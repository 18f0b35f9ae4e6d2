"""FitzHugh-Nagumo membrane model and stimulus control (mirror of
`sph_sm_monodomain_tpu.ops.electrophysiology`; reference
SPH_SM_monodomain.cpp:575-593, 704-783).

The coupled fused step runs the FHN reaction in the sweep-A epilogue
(ops/fused_step.py); `fhn_cell_model` is the same ODE step on its own, for
the unfused step and the monodomain modes. Reference quirks kept:
  - Iion is ACCUMULATED (`+=`) each step unless `quirk_iion_accumulate` is
    off (cpp:589);
  - set_stim compares squared distance against an UNSQUARED radius
    (cpp:712) unless `quirk_stim_radius_squared` is off;
  - turnOffStim sets stim = pres = -10000 and zeroes all EP state
    (cpp:764-783).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..state import ParticleState


def fhn_cell_model(state: ParticleState, cfg: SimConfig) -> ParticleState:
    """FHN reaction ODE step (calculate_cell_model, cpp:575-593). The FHN
    fields of `cfg` may be 0-dim tensors (config.resolve_params)."""
    denom = cfg.fh_vp - cfg.fh_vr
    asd = (cfg.fh_vt - cfg.fh_vr) / denom
    u = (state.vm - cfg.fh_vr) / denom
    dt = cfg.time_delta
    d_iion = dt * (cfg.fh_c1 * u * (u - asd) * (u - 1.0)
                   + cfg.fh_c2 * state.w) / state.mass
    if cfg.quirk_iion_accumulate:
        iion = state.iion + d_iion                          # `+=` quirk, cpp:589
    else:
        iion = d_iion
    w = state.w + dt * cfg.fh_c3 * (u - cfg.fh_c4 * state.w) / state.mass
    return state.replace(iion=iion, w=w)


def _stim_threshold(radius: float, cfg: SimConfig) -> float:
    # dist^2 <= radius (quirk) vs dist^2 <= radius^2 (corrected)
    return radius if cfg.quirk_stim_radius_squared else radius * radius


def set_stim(state: ParticleState, center, radius: float, strength: float,
             cfg: SimConfig) -> ParticleState:
    """Stimulate particles around one center (set_stim, cpp:704-717)."""
    center = torch.as_tensor(np.asarray(center, np.float32),
                             device=state.device)
    d2 = ((state.pos - center[None, :]) ** 2).sum(dim=-1)
    hit = state.active & (d2 <= _stim_threshold(radius, cfg))
    stim = torch.where(hit, torch.full_like(state.stim, strength),
                       state.stim)
    return state.replace(stim=stim,
                         is_stim_on=torch.tensor(True, device=state.device))


def stim_hits_from_centers(pos: torch.Tensor, active: torch.Tensor, centers,
                           radius: float, cfg: SimConfig,
                           chunk: int = 256) -> torch.Tensor:
    """Union of set_stim spheres over many centers, `chunk` centers at a
    time (turnOnStim_Mesh/Cube loops, cpp:719-762)."""
    centers = np.asarray(centers, dtype=np.float32)
    hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    thresh = _stim_threshold(radius, cfg)
    c_all = torch.from_numpy(centers).to(pos.device)
    for s in range(0, centers.shape[0], chunk):
        block = c_all[s:s + chunk]
        # per-axis difference form, summed in the JAX package's order
        d2 = sum((pos[None, :, k] - block[:, None, k]) ** 2
                 for k in range(3))
        hit |= (d2 <= thresh).any(dim=0)
    return hit & active


def turn_on_stim_mesh(state: ParticleState, positions, cfg: SimConfig,
                      tile_width: float | None = None,
                      centers_are_cloud: bool = True) -> ParticleState:
    """Stimulate the whole cloud and pin the tendon anchors
    (turnOnStim_Mesh, cpp:745-762): a radius-0.01 stim sphere around every
    loaded position, then fix particles with x in [0, 0.07] or (x >= 0.90
    and y >= 0.80). With `centers_are_cloud` the union of spheres is the
    active cloud itself (each particle is distance 0 from its own center),
    so no distance pass runs."""
    if centers_are_cloud:
        hit = state.active
    else:
        hit = stim_hits_from_centers(state.pos, state.active, positions,
                                     0.01, cfg)
    stim = torch.where(hit, torch.full_like(state.stim, cfg.stim_strength),
                       state.stim)
    x, y = state.pos[:, 0], state.pos[:, 1]
    if tile_width is not None:
        x = torch.remainder(x, tile_width)
    anchors = ((x >= 0.0) & (x <= 0.07)) | ((x >= 0.90) & (y >= 0.80))
    fixed = state.fixed | (anchors & state.active)
    return state.replace(stim=stim, fixed=fixed,
                         is_stim_on=torch.tensor(True, device=state.device))


def turn_on_stim_cube(state: ParticleState, positions, cfg: SimConfig,
                      tile_width: float | None = None) -> ParticleState:
    """Stimulate two x-slabs and pin two floor strips (turnOnStim_Cube,
    cpp:719-743)."""
    positions = np.asarray(positions, dtype=np.float32)
    px = positions[:, 0] % tile_width if tile_width else positions[:, 0]
    sel = (((px >= 0.45) & (px <= 0.48))
           | ((px > 1.0) & (positions[:, 2] <= 1.05)))
    hit = stim_hits_from_centers(state.pos, state.active, positions[sel],
                                 0.001, cfg)
    stim = torch.where(hit, torch.full_like(state.stim, cfg.stim_strength),
                       state.stim)
    x, y = state.pos[:, 0], state.pos[:, 1]
    if tile_width:
        x = torch.remainder(x, tile_width)
    floor = ((y == 0.0) & (x <= 0.48)) | ((y == 0.0) & (x >= 1.0))  # cpp:738
    fixed = state.fixed | (floor & state.active)
    return state.replace(stim=stim, fixed=fixed,
                         is_stim_on=torch.tensor(True, device=state.device))


def turn_off_stim(state: ParticleState, cfg: SimConfig) -> ParticleState:
    """Reset all EP state and close the pressure gate (turnOffStim,
    cpp:764-783)."""
    act = state.active
    neg = torch.full_like(state.stim, -10000.0)
    zero = torch.zeros_like(state.vm)
    return state.replace(
        stim=torch.where(act, neg, state.stim),
        vm=torch.where(act, zero, state.vm),
        inter_vm=torch.where(act, zero, state.inter_vm),
        iion=torch.where(act, zero, state.iion),
        pres=torch.where(act, neg, state.pres),
        w=torch.where(act, zero, state.w),
        is_stim_on=torch.tensor(False, device=state.device),
    )
