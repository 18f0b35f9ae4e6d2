"""Per-phase timing + CSV report in the reference's print_report format
(mirror of `sph_sm_monodomain_tpu.utils.report`; reference
SPH_SM_monodomain.cpp:785-824, schema at cpp:787).

The reference wraps each of the 7 step phases in chrono timers and prints
one semicolon-separated row. Here each phase (or each incremental pipeline
of the fused step) is timed over a chain of calls, each call's input the
previous call's output, so no call can be skipped, run as one scan
(models/scan.run_steps, the counterpart of the JAX package's `_scan_time`
over a jitted lax.scan):
  - on the card, replays of a captured CUDA graph of the chain's body,
    between two CUDA events (the card's time, not the host's launches);
  - on the CPU, eager calls under time.perf_counter, whose ops run
    synchronously.
The per-iteration cost of a pipeline is the best of `reps` chains. Where a
length is picked from the scene's own cost (`length=None`), it comes from
the difference of two chain lengths (`_iter_cost`), in which the fixed
cost of starting a chain cancels.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..config import SimConfig
from ..state import ParticleState
from ..ops import grid, sph
from ..ops.shape_matching import corrected_velocity, sm_invariants
from ..ops.electrophysiology import fhn_cell_model
from ..ops.integrate import update_properties
from ..models.scan import copy_state, run_steps

REPORT_HEADER = ("Avg FPS;Avg Step Duration;Time Steps;Find neighbors;"
                 "Corrected Velocity;Intermediate Velocity;Density-Pressure;"
                 "Cell model;Compute Force;Update Properties;K;Alpha;Beta;Mu;"
                 "sigma;Stim strength;FH_VT;FH_VP;FH_VR;C1;C2;C3;C4")

def _leaf(x) -> torch.Tensor:
    return x.pos if isinstance(x, ParticleState) else x


@torch.no_grad()
def _chain_time(body: Callable, init, length: int = 20, reps: int = 3,
                donate: bool = False, unroll: int = 1) -> float:
    """Best seconds per iteration of `body` run `length` times as one scan
    from `init` (models/scan.run_steps, each call's input the previous
    call's output), over `reps` runs after one warm-up run: on the card,
    replays of a captured graph of `unroll` bodies between two CUDA
    events; on the CPU, eager calls under time.perf_counter.

    `unroll` reproduces run_protocol's very-large-scene dispatch
    (models.monodomain.VERY_LARGE_CAP); with `donate` the runs chain in
    place, each donating the previous run's output, and the caller's
    `init` survives (it is copied once up front)."""
    leaf = _leaf(init)
    cuda = leaf.is_cuda

    def run(x):
        return run_steps(lambda s, _ops: (body(s), None), x, length,
                         key=("chain", body), unroll=unroll,
                         donate=donate)[0]

    out = run(copy_state(init) if donate else init)
    if cuda:
        torch.cuda.synchronize(leaf.device)
    best = float("inf")
    for _ in range(reps):
        src = out if donate else init
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = run(src)
            t1.record()
            t1.synchronize()
            dt = t0.elapsed_time(t1) * 1e-3
        else:
            c0 = time.perf_counter()
            out = run(src)
            dt = time.perf_counter() - c0
        best = min(best, dt / length)
    return best


def profile_phases(state: ParticleState, cfg: SimConfig,
                   neighbor_capacity: int, length: int = 20) -> dict:
    """Per-phase seconds of the unfused step, mirroring the 7 timed phases
    of compute_SPH_SM_monodomain (cpp:794-824). Every phase output feeds
    the chain's carry with a NONZERO coefficient, as in the JAX package, so
    each iteration does a phase's whole work. The unfused neighbor table
    has no per-cell buckets, so there is no cell_capacity argument."""
    with torch.no_grad():
        nbr = grid.build_neighbor_table(state.pos, state.pos, state.active,
                                        cfg, neighbor_capacity)
    mut = 1.0000001  # tiny mutation, as in the JAX package

    phases = {
        "find_neighbors": lambda p: p * mut
        + 1e-9 * (grid.build_neighbor_table(
            p, p, state.active, cfg,
            neighbor_capacity).idx[0, 0] % 2).to(p.dtype),
        "corrected_velocity": lambda s: corrected_velocity(s, cfg).replace(
            pos=s.pos * mut),
        "intermediate_velocity": lambda s: s.replace(
            corrected_vel=sph.xsph_intermediate_velocity(
                s, nbr, cfg).inter_vel * 0.999),
        "density_pressure": lambda s: s.replace(
            vm=sph.density_pressure(s, nbr, cfg).dens * 1e-6 + s.vm * 0.99),
        "cell_model": lambda s: fhn_cell_model(s, cfg).replace(
            vm=s.vm * 0.9999),
        "compute_force": lambda s: s.replace(
            vm=sph.force_and_diffusion(s, nbr, cfg).acc[:, 0] * 1e-6
            + s.vm * 0.99),
        "update_properties": lambda s: update_properties(s, cfg),
    }
    out = {}
    for name, body in phases.items():
        init = state.pos if name == "find_neighbors" else state
        out[name] = _chain_time(body, init, length=length)
    return out


def _iter_cost(body: Callable, init, l0: int = 2, l1: int = 8,
               donate: bool = False, unroll: int = 1) -> float:
    """Per-iteration cost of `body` from the difference of two chain
    lengths (the fixed cost of starting a chain cancels)."""
    w0 = _chain_time(body, init, length=l0, reps=2, donate=donate,
                     unroll=unroll) * l0
    w1 = _chain_time(body, init, length=l1, reps=2, donate=donate,
                     unroll=unroll) * l1
    return max((w1 - w0) / (l1 - l0), 1e-7)


def _auto_length(cheap_body: Callable, full_body: Callable, init,
                 donate: bool = False, unroll: int = 1) -> int:
    """Chain length sized from the scene's own measured cost: long enough
    that the CHEAPEST pipeline accumulates ~50 ms per chain (stage deltas
    then dominate timer jitter), short enough that the full-step pipeline
    stays a few seconds per rep."""
    t_cheap = _iter_cost(cheap_body, init, donate=donate, unroll=unroll)
    t_full = _iter_cost(full_body, init, donate=donate, unroll=unroll)
    return max(4, int(min(250.0, max(4.0, 0.05 / t_cheap), 3.0 / t_full)))


def _order_bit(order: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return (order[0] % 2).to(like.dtype)


def profile_phases_fused(scene, length: int | None = None) -> dict:
    """Per-phase seconds of the fused step the scene runs (v4, or v5 /
    v5s), by an INCREMENTAL pipeline ablation, as in the JAX package: each
    stage's cost is the time difference between running the pipeline up
    to and including it and stopping before it, so the attributed columns
    sum to the full step time unless a difference is clamped at 0:

      find_neighbors        <- sort + window bookkeeping
      corrected_velocity    <- shape matching
      density_pressure      <- sorted gather + sweep A (XSPH + density +
                               EOS + FHN epilogue)
      compute_force         <- feature stack + sweep B (forces + Vm
                               Laplacian + integration epilogue) + unsort
      intermediate_velocity, cell_model, update_properties -> 0 (fused
      into the sweep epilogues)

    `raw_pipeline_s` carries the four raw pipeline times, so a negative
    stage difference shows instead of vanishing into a zeroed column.
    `length=None` (the default) sizes the chains from the scene's own cost
    (`_auto_length`)."""
    from ..models.monodomain import VERY_LARGE_CAP, step_fused
    from ..ops.fused_step import (build_qm_feats, build_qm_feats5,
                                  pack_feats_a5, sweep_a3, sweep_a5)
    from ..ops.sweeps import sweep_bookkeeping3, sweep_bookkeeping5

    state, cfg = scene.state, scene.cfg
    wc = scene.block_window
    sub_q = scene.sub_block or 128
    impl = getattr(scene, "fused_impl", "v4")
    pack_cap = getattr(scene, "pack_cap", 0)
    with torch.no_grad():
        sm_inv = sm_invariants(state, cfg)

    if impl in ("v5", "v5s"):
        def book(s):
            return sweep_bookkeeping5(s.pos, s.active, cfg, sub_q, pack_cap,
                                      w_chunk=wc)

        def stage3(s):  # + qm gather + slab pack + sweep A
            order, inv, src, trips, _ovf, cf, cm, cs = book(s)
            s = corrected_velocity(s, cfg, sm_inv=sm_inv)
            fs = build_qm_feats5(s, cf, cm, cs, order)
            out_a = sweep_a5(fs, pack_feats_a5(fs, src, pack_cap), trips,
                             cfg, sub_q=sub_q, w_chunk=wc,
                             static_trips=(impl == "v5s"))
            return s.replace(dens=out_a[:, 8][inv],
                             pos=s.pos + 1e-12 * s.corrected_vel)
    elif impl == "v4":
        def book(s):
            return sweep_bookkeeping3(s.pos, s.active, cfg, sub_q)

        def stage3(s):  # + sorted gather + sweep A
            order, inv, blk_lo, blk_hi, cx, cyz = book(s)
            s = corrected_velocity(s, cfg, sm_inv=sm_inv)
            fs, feats_a = build_qm_feats(s, cx, cyz, order)
            out_a = sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg, sub_q=sub_q)
            return s.replace(dens=out_a[:, 8][inv],
                             pos=s.pos + 1e-12 * s.corrected_vel)
    else:
        raise ValueError(f"profile_phases_fused times the v4 and v5 "
                         f"steps (scene fused_impl={impl!r})")

    def stage1(s):  # bookkeeping (sort + window/slab index construction)
        order = book(s)[0]
        return s.replace(pos=s.pos + 1e-9 * _order_bit(order, s.pos))

    def stage2(s):  # + shape matching
        order = book(s)[0]
        s = corrected_velocity(s, cfg, sm_inv=sm_inv)
        return s.replace(pos=s.pos + 1e-9 * s.corrected_vel
                         + 1e-9 * _order_bit(order, s.pos))

    def stage4(s):  # full fused step
        out, _ = step_fused(s, cfg, sub_q, impl=impl, sm_inv=sm_inv,
                            pack_cap=pack_cap, w_chunk=wc)
        return out

    # very large scenes: time the unrolled dispatch run_protocol takes
    # there (models.monodomain.VERY_LARGE_CAP), chained in place
    donate = state.pos.is_cuda and state.capacity > VERY_LARGE_CAP
    dk = {"donate": donate, "unroll": 4 if donate else 1}
    if length is None:
        length = _auto_length(stage1, stage4, state, **dk)
    t1 = _chain_time(stage1, state, length=length, **dk)
    t2 = _chain_time(stage2, state, length=length, **dk)
    t3 = _chain_time(stage3, state, length=length, **dk)
    t4 = _chain_time(stage4, state, length=length, **dk)
    return {
        "find_neighbors": t1,
        "corrected_velocity": max(t2 - t1, 0.0),
        "intermediate_velocity": 0.0,
        "density_pressure": max(t3 - t2, 0.0),
        "cell_model": 0.0,
        "compute_force": max(t4 - t3, 0.0),
        "update_properties": 0.0,
        "total_step": t4,
        "raw_pipeline_s": (t1, t2, t3, t4),
    }


def profile_phases_sph_fused(scene, length: int | None = None) -> dict:
    """Per-phase seconds of the fused SPH-only mode
    (variants.step_sph_only_fused: the v4 sweeps with with_ep=False).
    Incremental pipeline attribution like profile_phases_fused:
    bookkeeping -> +sweep A -> full step; the "Corrected Velocity" column
    is structurally 0 (no shape matching in this mode)."""
    from ..models.variants import step_sph_only_fused, sph_only_config
    from ..ops.fused_step import build_qm_feats, sweep_a3
    from ..ops.sweeps import sweep_bookkeeping3

    state = scene.state
    cfg = sph_only_config(scene.cfg)
    sub_q = scene.sub_block or 128

    def book(s):
        return sweep_bookkeeping3(s.pos, s.active, cfg, sub_q)

    def stage1(s):
        order = book(s)[0]
        return s.replace(pos=s.pos + 1e-9 * _order_bit(order, s.pos))

    def stage2(s):  # + sorted gather + sweep A (with_ep=False)
        order, inv, blk_lo, blk_hi, cx, cyz = book(s)
        zeros1 = torch.zeros_like(s.mass)
        fs, feats_a = build_qm_feats(
            s.replace(corrected_vel=s.vel, vm=zeros1, iion=zeros1,
                      w=zeros1), cx, cyz, order)
        out_a = sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg, with_ep=False,
                         sub_q=sub_q)
        return s.replace(dens=out_a[:, 8][inv], pos=s.pos + 1e-12 * s.vel)

    def stage3(s):  # full sph-only fused step
        out, _ = step_sph_only_fused(s, cfg, sub_q)
        return out

    if length is None:
        length = _auto_length(stage1, stage3, state)
    t1 = _chain_time(stage1, state, length=length)
    t2 = _chain_time(stage2, state, length=length)
    t3 = _chain_time(stage3, state, length=length)
    return {
        "find_neighbors": t1,
        "corrected_velocity": 0.0,
        "intermediate_velocity": 0.0,
        "density_pressure": max(t2 - t1, 0.0),
        "cell_model": 0.0,
        "compute_force": max(t3 - t2, 0.0),
        "update_properties": 0.0,
        "total_step": t3,
        "raw_pipeline_s": (t1, t2, t3),
    }


def profile_phases_monodomain_fused(scene, length: int | None = None) -> dict:
    """Per-phase seconds of the fused monodomain-only mode
    (variants.simulate_monodomain_only_fused): per step only the FHN
    reaction ODEs ("Cell model" column) and the Laplacian-only sweep
    ("Compute Force" column, the diffusion half of the reference's
    Compute_Force, cpp:562-563) run; the geometry phases are hoisted into
    the prepared tables and are structurally 0 per step."""
    from ..models import variants

    state, cfg = scene.state, scene.cfg
    sub_q = scene.sub_block or 128
    tables = variants.monodomain_prepare_fused(state, cfg, sub_q=sub_q)

    def cell(s):
        return fhn_cell_model(s, cfg).replace(vm=s.vm * 0.9999)

    def full(s):
        return variants.simulate_monodomain_only_fused(
            s, tables, cfg, num_steps=1, sub_q=sub_q)

    if length is None:
        length = _auto_length(cell, full, state)
    t_cell = _chain_time(cell, state, length=length)
    t_full = _chain_time(full, state, length=length)
    return {
        "find_neighbors": 0.0,
        "corrected_velocity": 0.0,
        "intermediate_velocity": 0.0,
        "density_pressure": 0.0,
        "cell_model": t_cell,
        "compute_force": max(t_full - t_cell, 0.0),
        "update_properties": 0.0,
        "total_step": t_full,
        "raw_pipeline_s": (t_cell, t_full),
    }


def report_row(cfg: SimConfig, total_steps: int, avg_step_s: float,
               phase_seconds: dict, avg_fps: float | None = None) -> str:
    """One semicolon row in the reference print_report order (cpp:787-791)."""
    if avg_fps is None:
        avg_fps = 1.0 / avg_step_s if avg_step_s > 0 else 0.0
    p = phase_seconds
    cols = [
        avg_fps, avg_step_s, total_steps,
        p.get("find_neighbors", 0.0), p.get("corrected_velocity", 0.0),
        p.get("intermediate_velocity", 0.0), p.get("density_pressure", 0.0),
        p.get("cell_model", 0.0), p.get("compute_force", 0.0),
        p.get("update_properties", 0.0),
        cfg.k_stiffness, cfg.sm_alpha, cfg.sm_beta, cfg.mu_viscosity,
        cfg.sigma, cfg.stim_strength, cfg.fh_vt, cfg.fh_vp, cfg.fh_vr,
        cfg.fh_c1, cfg.fh_c2, cfg.fh_c3, cfg.fh_c4,
    ]
    return ";".join(f"{c:g}" if isinstance(c, float) else str(c)
                    for c in cols)
