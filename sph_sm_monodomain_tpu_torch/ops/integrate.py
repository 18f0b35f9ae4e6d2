"""Semi-implicit Euler integration, wall handling and clamps (mirror of
`sph_sm_monodomain_tpu.ops.integrate`; Update_Properties,
SPH_SM_monodomain.cpp:596-651).

Semantics kept:
  - vel = inter_vel + acc*dt/m: acc was already divided by density in the
    force phase, so the extra mass division is a reference quirk (cpp:608);
  - fixed particles keep pos and vel (cpp:606-610); the voltage update
    applies to every active row (cpp:612-616), clamped at +-max_voltage;
  - per-axis wall reflection vel *= Wall_Hit with the position snapped to
    0 or World - 1e-4 (cpp:618-647), then the AABB clamp to [0, World]
    (cpp:649).
Inactive (padded) rows are left untouched, so they stay parked outside the
grid.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import ParticleState
from .constants import const_tensor


def update_properties(state: ParticleState, cfg: SimConfig) -> ParticleState:
    dt = cfg.time_delta
    # a true division of dt by mass (Python's `dt / tensor` multiplies by
    # the reciprocal, which rounds differently from the JAX package)
    dtm = torch.full_like(state.mass, dt) / state.mass
    vel = state.inter_vel + state.acc * dtm[:, None]               # cpp:608
    pos = state.pos + vel * dt                                      # cpp:609
    fixed = state.fixed[:, None]                                    # cpp:606-610
    vel = torch.where(fixed, state.vel, vel)
    pos = torch.where(fixed, state.pos, pos)

    vm = state.vm + state.inter_vm * dt / state.mass                # cpp:612
    vm = torch.clamp(vm, -cfg.max_voltage, cfg.max_voltage)         # cpp:613-616

    world = const_tensor(tuple(cfg.world_size), state.device)[None, :]
    low = pos < 0.0                                                 # cpp:618-647
    high = pos >= world
    vel = torch.where(low | high, vel * cfg.wall_hit, vel)
    pos = torch.where(low, torch.zeros_like(pos), pos)
    pos = torch.where(high, (world - 1e-4).expand_as(pos), pos)
    pos = torch.minimum(torch.clamp(pos, min=0.0), world)           # cpp:649

    act = state.active
    return state.replace(
        pos=torch.where(act[:, None], pos, state.pos),
        vel=torch.where(act[:, None], vel, state.vel),
        vm=torch.where(act, vm, state.vm),
    )
