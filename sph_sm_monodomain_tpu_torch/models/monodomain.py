"""The coupled SPH + shape-matching + monodomain model: the fused step in
its v4, v3 and v5 generations, the unfused reference step, and their run
loops (mirror of `sph_sm_monodomain_tpu.models.monodomain`, `:44-480`).

The fused step runs the reference phases (compute_SPH_SM_monodomain,
cpp:794-824) as: sort + candidate bookkeeping, shape-matching velocity
correction, sweep A (XSPH + density + EOS + FHN), sweep B (forces + Vm
Laplacian + integration + walls), unsort. The generations differ only in
the bookkeeping and the sweeps' candidate enumeration (ops/fused_step.py);
v5's packed slabs have a capacity, whose overflow run_protocol regrows.
The v1 / v2 ablation baselines (ablation/legacy_steps.py) run the
pointwise phases between raw-sum sweeps in PyTorch. `step` is the unfused
reference form of the same phases over a neighbor table (ops/grid.py, ops/sph.py):
plain PyTorch everywhere, and the in-package cross-check of the fused step.
`simulate` runs N steps through models/scan.py, the counterpart of the
JAX package's `lax.scan`: on the card, replays of one captured CUDA graph
of `unroll` steps (no host launch per kernel, no host sync per step), and
under autograd its checkpointed adjoint scan;
`simulate_donated` does so in the input state's own tensors;
`run_protocol` replays the reference app's experiment protocol in
chunks, donating on the fused v1-v4 paths. `step_fused_diff` is the
fused step under autograd: it swaps in the differentiable sweeps of
ops/fused_adjoint.py, whose backward passes are hand-written kernels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import SimConfig, resolve_params
from ..state import ParticleState
from ..ops.electrophysiology import fhn_cell_model, turn_off_stim
from ..ops.fused_adjoint import make_diff_sweeps
from ..ops.fused_step import (apply_out_fused, build_dynp, build_qm_feats,
                              build_qm_feats5, feats_b, pack_feats_a5,
                              pack_feats_b5, sweep_a3, sweep_a3_hash9,
                              sweep_a5, sweep_b3, sweep_b3_hash9, sweep_b5,
                              vol_now)
from ..ops.grid import build_neighbor_table
from ..ops.integrate import update_properties
from ..ops.numerics import ensure_fp32
from ..ops.shape_matching import corrected_velocity, sm_invariants
from ..ops.sph import (density_pressure, force_and_diffusion,
                       xsph_intermediate_velocity)
from ..ops.sweeps import (sweep_bookkeeping2, sweep_bookkeeping3,
                          sweep_bookkeeping5)
from ..utils import tracing
from .scan import copy_state, run_steps


class StepAux(NamedTuple):
    """Per-step diagnostics."""
    # entries dropped: neighbor-table slots (unfused) or packed-slab slots
    # (v5); 0 on v3 / v4, whose windows cannot overflow
    overflow: torch.Tensor


def _no_overflow(state: ParticleState) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=state.device)


def step_fused(state: ParticleState, cfg: SimConfig, sub_q: int | None = None,
               impl: str = "v4", sm_inv=None, params=None, sweeps=None,
               pack_cap: int = 0, w_chunk: int = 128
               ) -> tuple[ParticleState, StepAux]:
    """One coupled step with the fused sweeps.

    `impl`: the sweep generation, as in the JAX package: "v4" (three
    merged windows, the production default), "v3" (nine hash run windows),
    "v5" (per-sub-block packed candidate slabs of `pack_cap` slots, whose
    overflow StepAux reports), "v5s" (v5 over each whole slab), or the
    ablation baselines "v2" (v3's windows, raw-sum sweeps and PyTorch glue)
    and "v1" (per-query run bounds, raw-sum sweeps), which
    ablation/legacy_steps.py runs. `sub_q`: rows per bookkeeping
    sub-block, which is one thread block of the window sweep kernels
    (None: 64 for v3, 128 for v4 and v1, 32 for v5 and v2). `w_chunk`: the
    chunk width the v5 trip counts are counted in (the JAX package's
    w_window); the other generations take no TPU tiling parameter, since
    their kernels iterate each window or run exactly. `sm_inv`: hoisted shape-matching invariants.
    `params` (v4 only): per-call physics overrides (config.PARAM_FIELDS)
    that reach the kernels through the physics-constant vector
    (ops.fused_step.build_dynp). `sweeps` (v4 only): a (sweep_a, sweep_b)
    pair, each (qm, dynp, blk_lo, blk_hi) -> (N, 16), in place of the
    production sweeps (step_fused_diff passes the differentiable ones).

    While tracing is on (utils/tracing.py) the v4 step stamps the device
    at its start and after each stage (tracing.STEP_STAMPS["v4"]):
    bookkeeping, shape matching, the gathers of K1's inputs, K1, the
    gathers of K2's, K2, and the apply (unsort)."""
    if (params or sweeps is not None) and impl != "v4":
        raise ValueError("dynamic params on the fused path require "
                         f"impl='v4'; impl={impl!r} bakes the constants")
    if impl in ("v5", "v5s"):
        return _step_fused_v5(state, cfg, sub_q or 32, pack_cap, w_chunk,
                              sm_inv, static_trips=impl == "v5s")
    if impl == "v3":
        return _step_fused_v3(state, cfg, sub_q or 64, sm_inv)
    if impl == "v2":
        from ..ablation.legacy_steps import _step_fused_v2
        return _step_fused_v2(state, cfg, sub_q or 32, sm_inv)
    if impl == "v1":
        from ..ablation.legacy_steps import _step_fused_v1
        return _step_fused_v1(state, cfg, sub_q or 128, sm_inv)
    if impl != "v4":
        raise ValueError(f"unknown fused impl {impl!r} "
                         "(expected v1/v2/v3/v4/v5/v5s)")
    sub_q = sub_q or 128
    cfg_eff = resolve_params(cfg, params)
    # the differentiable sweeps take the constants as an operand always
    dynp = (build_dynp(cfg_eff, state.device)
            if params or sweeps is not None else None)

    dev = state.device
    tracing.stamp("off_step", dev)
    # the sort and windows are per-step geometry, outside autograd
    order, inv, blk_lo, blk_hi, cx, cyz = sweep_bookkeeping3(
        state.pos.detach(), state.active, cfg, sub_q)
    tracing.stamp("bookkeeping", dev)
    # phase 2: shape matching (original order), with the effective config
    state = corrected_velocity(state, cfg_eff, sm_inv=sm_inv)
    tracing.stamp("shape_matching", dev)

    fs, feats_a = build_qm_feats(state, cx, cyz, order)
    tracing.stamp("gathers", dev)
    if sweeps is None:
        out_a = sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg, sub_q=sub_q,
                         dynp=dynp)
        tracing.stamp("k1", dev)
        fb = feats_b(out_a)
        tracing.stamp("gathers", dev)
        out_b = sweep_b3(out_a, fb, blk_lo, blk_hi, cfg, sub_q=sub_q,
                         dynp=dynp)
        del fb      # freed before the apply: it would raise the step's peak
    else:
        out_a = sweeps[0](fs, dynp, blk_lo, blk_hi)
        tracing.stamp("k1", dev)
        tracing.stamp("gathers", dev)   # K2's inputs are gathered inside
        out_b = sweeps[1](out_a, dynp, blk_lo, blk_hi)
    tracing.stamp("k2", dev)
    state = apply_out_fused(state, out_a, out_b, inv)
    tracing.stamp("apply", dev)
    return state, StepAux(overflow=_no_overflow(state))


def _step_fused_v3(state: ParticleState, cfg: SimConfig, sub_q: int,
                   sm_inv=None) -> tuple[ParticleState, StepAux]:
    """v3 fused step: the v4 step's phases over the nine hash run windows
    of sweep_bookkeeping2, with the linear hash as the stencil feature."""
    order, inv, blk_lo, blk_hi, chash = sweep_bookkeeping2(
        state.pos, state.active, cfg, sub_q)
    state = corrected_velocity(state, cfg, sm_inv=sm_inv)
    fs, feats_a = build_qm_feats(state, chash, torch.zeros_like(chash),
                                 order)
    out_a = sweep_a3_hash9(fs, feats_a, blk_lo, blk_hi, cfg, sub_q=sub_q)
    out_b = sweep_b3_hash9(out_a, feats_b(out_a), blk_lo, blk_hi, cfg,
                           sub_q=sub_q)
    state = apply_out_fused(state, out_a, out_b, inv)
    return state, StepAux(overflow=_no_overflow(state))


def _step_fused_v5(state: ParticleState, cfg: SimConfig, sub_q: int,
                   pack_cap: int, w_chunk: int = 128, sm_inv=None,
                   static_trips: bool = False
                   ) -> tuple[ParticleState, StepAux]:
    """v5 fused step: sweep_bookkeeping5 left-packs each sub-block's nine
    tight dilated runs into `pack_cap` slots, a row gather builds the
    (B, 16, pack_cap) slabs of each sweep, and the sweeps walk them.
    Candidates past pack_cap are dropped and counted in StepAux.overflow
    (a device tensor; run_protocol reads it once per chunk and regrows)."""
    if pack_cap <= 0:
        raise ValueError("impl='v5' needs pack_cap > 0 (auto_sweep5_params)")
    order, inv, src, trips, overflow, cf, cm, cs = sweep_bookkeeping5(
        state.pos, state.active, cfg, sub_q, pack_cap, w_chunk)
    state = corrected_velocity(state, cfg, sm_inv=sm_inv)
    fs = build_qm_feats5(state, cf, cm, cs, order)
    kw = dict(sub_q=sub_q, w_chunk=w_chunk, static_trips=static_trips)
    out_a = sweep_a5(fs, pack_feats_a5(fs, src, pack_cap), trips, cfg, **kw)
    out_b = sweep_b5(out_a, pack_feats_b5(out_a, vol_now(out_a), src,
                                          pack_cap), trips, cfg, **kw)
    state = apply_out_fused(state, out_a, out_b, inv)
    return state, StepAux(overflow=overflow)


def step_fused_diff(state: ParticleState, cfg: SimConfig, sub_q: int = 128,
                    sm_inv=None, params=None) -> ParticleState:
    """Differentiable v4 coupled step (the counterpart of the JAX package's
    ops.fused_adjoint.step_fused_diff): step_fused with the production
    sweep kernels forward and the hand-written backward sweeps in
    autograd's backward pass. Gradients w.r.t. the state and any tensor
    `params` overrides (config.PARAM_FIELDS). Long rollouts run it through
    models/scan.run_steps, whose adjoint scan checkpoints each step
    (examples/fit_material_flagship.py). Returns the new state."""
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


def _simulate(state: ParticleState, cfg: SimConfig, num_steps: int = 1,
              stim_off_step: int = -1, record_every: int = 0,
              sub_q: int | None = None, impl: str = "v4", params=None,
              fused: bool = True, neighbor_capacity: int = 0,
              pack_cap: int = 0, w_chunk: int = 128, unroll: int = 1, *,
              donate: bool):
    """Run `num_steps` coupled steps: fused (the `impl` generation's sweep
    kernels; `sub_q`, `pack_cap`, `w_chunk` as in step_fused), or with
    `fused=False` the unfused reference step over a neighbor table of width
    `neighbor_capacity` (which must then be given).

    The steps run through models/scan.run_steps, the counterpart of the JAX
    package's jitted lax.scan: on the card, replays of one captured CUDA
    graph of `unroll` steps, cached under the static arguments (the JAX
    package's _SIM_STATIC) and the shapes; on the CPU the same blocks
    eagerly. Without `donate` the result never shares memory with the
    cached graph's buffers; with it (simulate_donated) the result is the
    input state's own tensors.

    Under autograd (a float tensor of the state, or a tensor of `params`,
    requiring grad) the unfused run is differentiable w.r.t. both, as the
    JAX package's simulate is on its XLA path: the steps run as the
    checkpointed adjoint scan of models/scan.py (one carry per step, the
    step recomputed in the backward pass; forward and backward steps
    replays of captured graphs on the card). simulate_donated then does
    not donate: its input is the adjoint's carry 0, and the result is a
    new state. The fused step is not differentiable here, as in the JAX
    package: on the card its sweep kernels raise under autograd (the
    fused gradient is step_fused_diff's).

    `stim_off_step`: turnOffStim fires BEFORE that step index
    (main.cpp:329-334); -1 disables. If `record_every` > 0, returns (state,
    aux, traj) with traj = {"pos": (T, N, 3), "vm": (T, N)} frames taken
    after each full block of `record_every` steps (leftover steps run
    unrecorded). aux.overflow is the largest per-step overflow (table or
    slab), kept on the device."""
    if not fused and neighbor_capacity <= 0:
        raise ValueError("the unfused step needs neighbor_capacity > 0")
    ensure_fp32()
    # rest-shape SM moments are run constants: hoisted out of the loop
    with tracing.span("simulate.sm_invariants"):
        sm_inv = sm_invariants(state, cfg)

    def one(st, ops):
        inv, prm = ops
        if fused:
            return step_fused(st, cfg, sub_q, impl=impl, sm_inv=inv,
                              params=prm, pack_cap=pack_cap, w_chunk=w_chunk)
        return step(st, cfg, neighbor_capacity, sm_inv=inv, params=prm)

    state, overflow, frames = run_steps(
        one, state, num_steps, operands=(sm_inv, params),
        key=("coupled", cfg, fused, impl, sub_q, pack_cap, w_chunk,
             neighbor_capacity),
        unroll=unroll, stim_off_step=stim_off_step,
        stim_off=lambda st: turn_off_stim(st, cfg),
        record_every=record_every, extract=lambda st: (st.pos, st.vm),
        donate=donate)
    aux = StepAux(overflow=overflow)
    if not record_every:
        return state, aux
    n = state.capacity
    traj = {"pos": (torch.stack([f[0] for f in frames]) if frames
                    else state.pos.new_zeros((0, n, 3))),
            "vm": (torch.stack([f[1] for f in frames]) if frames
                   else state.vm.new_zeros((0, n)))}
    return state, aux, traj


simulate = functools.partial(_simulate, donate=False)

# `simulate` with the state DONATED: the input state's own tensors hold the
# steps' state (on the card, the captured graph's buffers) and the result
# is written into them; the input is dead after the call, as under the JAX
# package's donate_argnums (run_protocol copies the caller's state once).
# Under autograd it does not donate (see _simulate).
simulate_donated = functools.partial(_simulate, donate=True)

# The JAX package's threshold above which run_protocol unrolls its
# donated chunk scan by 4 (a TPU memory ceiling); the port takes the same
# dispatch rule so the two packages run the same blocks, and its own
# graph-pool peak is measured by tools/hbm_footprint.py --scan.
VERY_LARGE_CAP = 4_200_000


def run_protocol(scene, num_steps: int = 500, stim_off_step: int | None = None,
                 chunk: int = 100, record_every: int = 0, callback=None,
                 fused: bool | None = None, impl: str | None = None,
                 params=None, unroll: int | None = None):
    """Chunked run loop replaying the reference app's experiment protocol
    (main.cpp:73, 329-334): `num_steps` total, turnOffStim before the step
    at `stim_off_step` (default num_steps // 2), `chunk` steps per
    `simulate` call.

    `fused`: None or True runs the fused step of generation `impl` (None:
    the scene's `fused_impl`, "v3" for a scene without one), False the
    unfused reference step over the scene's neighbor table. A chunk that
    overflowed is redone from its input state with the capacity grown
    1.5x, at most 3 times per run: on the unfused path `neighbor_capacity`
    (rounded up to a multiple of 9), on the v5 / v5s path `pack_cap`
    (rounded up to a multiple of 128). The overflow is read once per chunk.

    `unroll`: steps a captured graph holds (None: 4 on a donated run of
    more than VERY_LARGE_CAP rows, else 1, the JAX package's rule).

    Memory: on the card the fused v1-v4 paths (whose windows cannot
    overflow, so a chunk is never redone) donate each chunk's input state
    (simulate_donated), as the JAX package's do on the TPU. The caller's
    `scene.state` is copied once up front and stays valid; a `callback`
    must not keep the state it is given past its return (the next chunk
    overwrites those tensors): it copies what it keeps.

    `callback(step_idx, state)` runs between chunks and may return
    {"stim_off": True} (turnOffStim now, key 'q') or {"stop": True} (end
    the run, ESC). Returns (state, StepAux, traj|None).

    Tracing (utils/tracing.py): a call is one unit, span `protocol.unit`,
    with the spans `protocol.copy_state`, `protocol.chunk`,
    `protocol.overflow_fetch` (the host sync a chunk) and
    `protocol.callback`, and the counter `protocol.host_syncs`."""
    with tracing.span("protocol.unit", unit=True):
        return _run_protocol(scene, num_steps, stim_off_step, chunk,
                             record_every, callback, fused, impl, params,
                             unroll)


def _run_protocol(scene, num_steps, stim_off_step, chunk, record_every,
                  callback, fused, impl, params, unroll):
    fused = fused is not False
    state, cfg = scene.state, scene.cfg
    run_impl = impl or getattr(scene, "fused_impl", "v3")
    if stim_off_step is None:
        stim_off_step = num_steps // 2
    if record_every:
        # each chunk holds a whole number of record blocks
        chunk = max(record_every, chunk - chunk % record_every)
    donate = (fused and run_impl in ("v1", "v2", "v3", "v4")
              and state.device.type == "cuda")
    with tracing.span("protocol.copy_state", copied=donate):
        if donate:
            state = copy_state(state)
    if unroll is None:
        unroll = 4 if donate and state.capacity > VERY_LARGE_CAP else 1
    sim_fn = simulate_donated if donate else simulate
    trajs = []
    max_overflow = 0
    regrow = 0
    done = 0
    while done < num_steps:
        n = min(chunk, num_steps - done)
        off = stim_off_step - done if done <= stim_off_step < done + n else -1
        with tracing.span("protocol.chunk", start=done, steps=n):
            out = sim_fn(state, cfg, num_steps=n, stim_off_step=off,
                         record_every=record_every,
                         sub_q=scene.sub_block or None, impl=run_impl,
                         params=params, fused=fused,
                         neighbor_capacity=scene.neighbor_capacity,
                         pack_cap=getattr(scene, "pack_cap", 0),
                         w_chunk=scene.block_window, unroll=unroll)
        with tracing.span("protocol.overflow_fetch"):
            step_overflow = int(out[1].overflow)
        tracing.count("protocol.host_syncs")
        if step_overflow and regrow < 3 and \
                (not fused or run_impl in ("v5", "v5s")):
            # the table or the slabs truncated candidates (the cloud
            # densified past the capacity): regrow and redo this chunk from
            # its unchanged input state
            regrow += 1
            if fused:
                new_cap = ((int(scene.pack_cap * 1.5) + 127) // 128) * 128
                scene = scene._replace(pack_cap=new_cap)
            else:
                new_k = ((int(scene.neighbor_capacity * 1.5) + 8) // 9) * 9
                scene = scene._replace(neighbor_capacity=new_k)
            continue
        state = out[0]
        if record_every:
            trajs.append(out[2])
        max_overflow = max(max_overflow, step_overflow)
        done += n
        if callback is not None:
            with tracing.span("protocol.callback"):
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
