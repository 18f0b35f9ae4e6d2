"""The coupled SPH + shape-matching + monodomain model: the v4 fused step and
its run loops (mirror of `sph_sm_monodomain_tpu.models.monodomain`,
`:44-172`, `:231-325`, `:349-480`).

Each step runs the reference phases (compute_SPH_SM_monodomain,
cpp:794-824) as: sort + window bookkeeping, shape-matching velocity
correction, sweep A (XSPH + density + EOS + FHN), sweep B (forces + Vm
Laplacian + integration + walls), unsort. `simulate` is a Python loop over
steps; `run_protocol` replays the reference app's experiment protocol in
chunks. Only the fused path is ported; the unfused reference step is not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig, resolve_params
from ..state import ParticleState
from ..ops.electrophysiology import turn_off_stim
from ..ops.fused_step import (apply_out_fused, build_dynp, build_qm_feats,
                              feats_from_out_a, sweep_a3, sweep_b3)
from ..ops.shape_matching import corrected_velocity, sm_invariants
from ..ops.sweeps import sweep_bookkeeping3


class StepAux(NamedTuple):
    """Per-step diagnostics."""
    overflow: torch.Tensor  # particles dropped by a capacity (0 on v4)


def ensure_fp32() -> None:
    """Full-fp32 matrix products: the shape-matching moments run at
    Precision.HIGHEST in the JAX package (ops/shape_matching.py:29), so TF32
    stays off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("could not disable TF32 matrix products")


def step_fused(state: ParticleState, cfg: SimConfig, sub_q: int = 128,
               impl: str = "v4", sm_inv=None, params=None
               ) -> tuple[ParticleState, StepAux]:
    """One coupled step with the fused sweeps.

    `sub_q`: rows per bookkeeping sub-block, which is one thread block of
    the sweep kernels (the JAX package's TPU tiling parameters q_block and
    w_window have no counterpart: the CUDA kernels iterate each window
    exactly). `sm_inv`: hoisted shape-matching invariants. `params`:
    per-call physics overrides (config.PARAM_FIELDS) that reach the kernels
    through the physics-constant vector (ops.fused_step.build_dynp)."""
    if impl != "v4":
        raise NotImplementedError(f"impl={impl!r}: the port has the v4 "
                                  "fused step only")
    cfg_eff = resolve_params(cfg, params)
    dynp = build_dynp(cfg_eff, state.device) if params else None

    order, inv, blk_lo, blk_hi, cx, cyz = sweep_bookkeeping3(
        state.pos, state.active, cfg, sub_q)
    # phase 2: shape matching (original order), with the effective config
    state = corrected_velocity(state, cfg_eff, sm_inv=sm_inv)

    fs, feats_a = build_qm_feats(state, cx, cyz, order)
    out_a = sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg, sub_q=sub_q,
                     dynp=dynp)
    vol_now = torch.where(out_a[:, 8] > 0.0, out_a[:, 10] / out_a[:, 8],
                          torch.zeros_like(out_a[:, 8]))
    feats_b = feats_from_out_a(out_a, vol_now)
    out_b = sweep_b3(out_a, feats_b, blk_lo, blk_hi, cfg, sub_q=sub_q,
                     dynp=dynp)
    state = apply_out_fused(state, out_a, out_b, inv)
    return state, StepAux(overflow=torch.zeros((), dtype=torch.int32,
                                               device=state.device))


def simulate(state: ParticleState, cfg: SimConfig, num_steps: int = 1,
             stim_off_step: int = -1, record_every: int = 0,
             sub_q: int = 128, impl: str = "v4", params=None):
    """Run `num_steps` coupled fused steps.

    `stim_off_step`: turnOffStim fires BEFORE that step index
    (main.cpp:329-334); -1 disables. If `record_every` > 0, returns (state,
    aux, traj) with traj = {"pos": (T, N, 3), "vm": (T, N)} frames taken
    after each full block of `record_every` steps (leftover steps run
    unrecorded)."""
    ensure_fp32()
    # rest-shape SM moments are run constants: hoisted out of the loop
    sm_inv = sm_invariants(state, cfg)
    overflow = torch.zeros((), dtype=torch.int32, device=state.device)
    pos_t, vm_t = [], []
    for i in range(num_steps):
        if i == stim_off_step:
            state = turn_off_stim(state, cfg)
        state, aux = step_fused(state, cfg, sub_q, impl=impl,
                                sm_inv=sm_inv, params=params)
        overflow = torch.maximum(overflow, aux.overflow)
        if record_every and (i + 1) % record_every == 0:
            pos_t.append(state.pos.clone())
            vm_t.append(state.vm.clone())
    aux = StepAux(overflow=overflow)
    if not record_every:
        return state, aux
    n = state.capacity
    traj = {"pos": (torch.stack(pos_t) if pos_t
                    else state.pos.new_zeros((0, n, 3))),
            "vm": (torch.stack(vm_t) if vm_t
                   else state.vm.new_zeros((0, n)))}
    return state, aux, traj


def run_protocol(scene, num_steps: int = 500, stim_off_step: int | None = None,
                 chunk: int = 100, record_every: int = 0, callback=None,
                 fused: bool | None = None, impl: str | None = None,
                 params=None):
    """Chunked run loop replaying the reference app's experiment protocol
    (main.cpp:73, 329-334): `num_steps` total, turnOffStim before the step
    at `stim_off_step` (default num_steps // 2), `chunk` steps per
    `simulate` call.

    `callback(step_idx, state)` runs between chunks and may return
    {"stim_off": True} (turnOffStim now, key 'q') or {"stop": True} (end
    the run, ESC). Returns (state, StepAux, traj|None)."""
    if fused is False:
        raise NotImplementedError("the unfused reference step is not "
                                  "ported yet")
    state, cfg = scene.state, scene.cfg
    run_impl = impl or scene.fused_impl
    if stim_off_step is None:
        stim_off_step = num_steps // 2
    if record_every:
        # each chunk holds a whole number of record blocks
        chunk = max(record_every, chunk - chunk % record_every)
    trajs = []
    max_overflow = 0
    done = 0
    while done < num_steps:
        n = min(chunk, num_steps - done)
        off = stim_off_step - done if done <= stim_off_step < done + n else -1
        out = simulate(state, cfg, num_steps=n, stim_off_step=off,
                       record_every=record_every, sub_q=scene.sub_block,
                       impl=run_impl, params=params)
        state, aux = out[0], out[1]
        if record_every:
            trajs.append(out[2])
        max_overflow = max(max_overflow, int(aux.overflow))
        done += n
        if callback is not None:
            cmd = callback(done, state) or {}
            if cmd.get("stim_off"):
                state = turn_off_stim(state, cfg)
                stim_off_step = -1  # already fired; don't re-fire later
            if cmd.get("stop"):
                break
    aux = StepAux(overflow=torch.tensor(max_overflow, dtype=torch.int32))
    if not record_every:
        return state, aux, None
    traj = ({k: torch.cat([t[k] for t in trajs]) for k in trajs[0]}
            if trajs else {})
    return state, aux, traj
