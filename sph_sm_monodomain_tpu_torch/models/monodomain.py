"""The coupled SPH + shape-matching + monodomain model: the v4 fused step,
the unfused reference step, and their run loops (mirror of
`sph_sm_monodomain_tpu.models.monodomain`, `:44-480`).

The fused step runs the reference phases (compute_SPH_SM_monodomain,
cpp:794-824) as: sort + window bookkeeping, shape-matching velocity
correction, sweep A (XSPH + density + EOS + FHN), sweep B (forces + Vm
Laplacian + integration + walls), unsort. `step` is the unfused reference
form of the same phases over a neighbor table (ops/grid.py, ops/sph.py):
plain PyTorch everywhere, and the in-package cross-check of the fused step.
`simulate` is a Python loop over steps; `run_protocol` replays the
reference app's experiment protocol in chunks. `step_fused_diff` is the
fused step under autograd: it swaps in the differentiable sweeps of
ops/fused_adjoint.py, whose backward passes are hand-written kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig, resolve_params
from ..state import ParticleState
from ..ops.electrophysiology import fhn_cell_model, turn_off_stim
from ..ops.fused_adjoint import make_diff_sweeps
from ..ops.fused_step import (apply_out_fused, build_dynp, build_qm_feats,
                              feats_b, sweep_a3, sweep_b3)
from ..ops.grid import build_neighbor_table
from ..ops.integrate import update_properties
from ..ops.shape_matching import corrected_velocity, sm_invariants
from ..ops.sph import (density_pressure, force_and_diffusion,
                       xsph_intermediate_velocity)
from ..ops.sweeps import sweep_bookkeeping3


class StepAux(NamedTuple):
    """Per-step diagnostics."""
    overflow: torch.Tensor  # neighbor-table entries dropped (0 on v4)


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
               impl: str = "v4", sm_inv=None, params=None, sweeps=None
               ) -> tuple[ParticleState, StepAux]:
    """One coupled step with the fused sweeps.

    `sub_q`: rows per bookkeeping sub-block, which is one thread block of
    the sweep kernels (the JAX package's TPU tiling parameters q_block and
    w_window have no counterpart: the CUDA kernels iterate each window
    exactly). `sm_inv`: hoisted shape-matching invariants. `params`:
    per-call physics overrides (config.PARAM_FIELDS) that reach the kernels
    through the physics-constant vector (ops.fused_step.build_dynp).
    `sweeps`: a (sweep_a, sweep_b) pair, each (qm, dynp, blk_lo, blk_hi)
    -> (N, 16), in place of the production sweeps (step_fused_diff passes
    the differentiable ones)."""
    if impl != "v4":
        raise NotImplementedError(f"impl={impl!r}: the port has the v4 "
                                  "fused step only")
    cfg_eff = resolve_params(cfg, params)
    # the differentiable sweeps take the constants as an operand always
    dynp = (build_dynp(cfg_eff, state.device)
            if params or sweeps is not None else None)

    # the sort and windows are per-step geometry, outside autograd
    order, inv, blk_lo, blk_hi, cx, cyz = sweep_bookkeeping3(
        state.pos.detach(), state.active, cfg, sub_q)
    # phase 2: shape matching (original order), with the effective config
    state = corrected_velocity(state, cfg_eff, sm_inv=sm_inv)

    fs, feats_a = build_qm_feats(state, cx, cyz, order)
    if sweeps is None:
        out_a = sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg, sub_q=sub_q,
                         dynp=dynp)
        out_b = sweep_b3(out_a, feats_b(out_a), blk_lo, blk_hi, cfg,
                         sub_q=sub_q, dynp=dynp)
    else:
        out_a = sweeps[0](fs, dynp, blk_lo, blk_hi)
        out_b = sweeps[1](out_a, dynp, blk_lo, blk_hi)
    state = apply_out_fused(state, out_a, out_b, inv)
    return state, StepAux(overflow=torch.zeros((), dtype=torch.int32,
                                               device=state.device))


def step_fused_diff(state: ParticleState, cfg: SimConfig, sub_q: int = 128,
                    sm_inv=None, params=None) -> ParticleState:
    """Differentiable v4 coupled step (the counterpart of the JAX package's
    ops.fused_adjoint.step_fused_diff): step_fused with the production
    sweep kernels forward and the hand-written backward sweeps in
    autograd's backward pass. Gradients w.r.t. the state and any tensor
    `params` overrides (config.PARAM_FIELDS). For long rollouts wrap the
    step in torch.utils.checkpoint. Returns the new state."""
    return step_fused(state, cfg, sub_q, sm_inv=sm_inv, params=params,
                      sweeps=make_diff_sweeps(cfg, sub_q))[0]


def step(state: ParticleState, cfg: SimConfig, neighbor_capacity: int,
         sm_inv=None, params=None) -> tuple[ParticleState, StepAux]:
    """One coupled step in the unfused reference form (Animation ->
    compute_SPH_SM_monodomain): neighbor table, corrected velocity, XSPH,
    density + pressure, FHN, force + Vm diffusion, integration. Plain
    PyTorch, differentiable w.r.t. the state and tensor `params`
    (config.PARAM_FIELDS) everywhere but through the neighbor table, which
    is geometry built from the static `cfg`."""
    nbr = build_neighbor_table(state.pos, state.pos, state.active, cfg,
                               neighbor_capacity)
    cfg = resolve_params(cfg, params)
    state = corrected_velocity(state, cfg, sm_inv=sm_inv)
    state = xsph_intermediate_velocity(state, nbr, cfg)
    state = density_pressure(state, nbr, cfg)
    state = fhn_cell_model(state, cfg)
    state = force_and_diffusion(state, nbr, cfg)
    state = update_properties(state, cfg)
    return state, StepAux(overflow=nbr.overflow)


def simulate(state: ParticleState, cfg: SimConfig, num_steps: int = 1,
             stim_off_step: int = -1, record_every: int = 0,
             sub_q: int = 128, impl: str = "v4", params=None,
             fused: bool = True, neighbor_capacity: int = 0):
    """Run `num_steps` coupled steps: fused (v4 sweep kernels), or with
    `fused=False` the unfused reference step over a neighbor table of width
    `neighbor_capacity` (which must then be given).

    `stim_off_step`: turnOffStim fires BEFORE that step index
    (main.cpp:329-334); -1 disables. If `record_every` > 0, returns (state,
    aux, traj) with traj = {"pos": (T, N, 3), "vm": (T, N)} frames taken
    after each full block of `record_every` steps (leftover steps run
    unrecorded). aux.overflow is the largest per-step table overflow."""
    if not fused and neighbor_capacity <= 0:
        raise ValueError("the unfused step needs neighbor_capacity > 0")
    ensure_fp32()
    # rest-shape SM moments are run constants: hoisted out of the loop
    sm_inv = sm_invariants(state, cfg)
    overflow = torch.zeros((), dtype=torch.int32, device=state.device)
    pos_t, vm_t = [], []
    for i in range(num_steps):
        if i == stim_off_step:
            state = turn_off_stim(state, cfg)
        if fused:
            state, aux = step_fused(state, cfg, sub_q, impl=impl,
                                    sm_inv=sm_inv, params=params)
        else:
            state, aux = step(state, cfg, neighbor_capacity, sm_inv=sm_inv,
                              params=params)
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

    `fused`: None or True runs the fused step, False the unfused reference
    step over the scene's neighbor table. On that path a chunk whose table
    overflowed is redone from its input state with `neighbor_capacity`
    grown 1.5x (rounded up to a multiple of 9), at most 3 times per run.

    `callback(step_idx, state)` runs between chunks and may return
    {"stim_off": True} (turnOffStim now, key 'q') or {"stop": True} (end
    the run, ESC). Returns (state, StepAux, traj|None)."""
    fused = fused is not False
    state, cfg = scene.state, scene.cfg
    run_impl = impl or scene.fused_impl
    if stim_off_step is None:
        stim_off_step = num_steps // 2
    if record_every:
        # each chunk holds a whole number of record blocks
        chunk = max(record_every, chunk - chunk % record_every)
    trajs = []
    max_overflow = 0
    regrow = 0
    done = 0
    while done < num_steps:
        n = min(chunk, num_steps - done)
        off = stim_off_step - done if done <= stim_off_step < done + n else -1
        out = simulate(state, cfg, num_steps=n, stim_off_step=off,
                       record_every=record_every, sub_q=scene.sub_block,
                       impl=run_impl, params=params, fused=fused,
                       neighbor_capacity=scene.neighbor_capacity)
        step_overflow = int(out[1].overflow)
        if step_overflow and regrow < 3 and not fused:
            # the table truncated neighbor runs (the cloud densified past
            # K): regrow and redo this chunk from its unchanged input state
            regrow += 1
            new_k = ((int(scene.neighbor_capacity * 1.5) + 8) // 9) * 9
            scene = scene._replace(neighbor_capacity=new_k)
            continue
        state = out[0]
        if record_every:
            trajs.append(out[2])
        max_overflow = max(max_overflow, step_overflow)
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
