"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's paths on the card at the full width of
`build_scene("biceps_full")` (18,475 particles): the chunked `run_protocol`
of the v4 fused step, through the two hand-written CUDA sweep kernels, and
of its v3, v5, v2 and v1 generations through theirs; the
flagship (K, mu) material fit through the differentiable step, whose
backward pass runs the two hand-written backward sweep kernels; the
frozen-cloud monodomain mode on the hand-written Laplacian kernel, forward
and backward; the SPH-only, SM-only and unfused modes; and the roofline
tool, whose FMA-chain probe measures the card's fp32 peak. Phases, each
printing its lines; any failure raises and exits non-zero:

  1. device   needs torch.cuda; prints the card's name and power limit
  2. build    nvcc builds csrc/*.cu, one process per source (timed, with
              ptxas usage)
  3. kernels  the sort + window bookkeeping on the card equals the CPU's;
              sweep A / sweep B kernels against their plain PyTorch
              versions on the biceps_full step-0 inputs, per column; two
              launches of each bitwise equal
  4. main     run_protocol(500 steps, chunk 100, stim off at 250); each
              forward kernel's launch count must be exactly 500
  5. small    6 steps of a 462-particle biceps slice through the kernels on
              the card against the plain versions on the CPU (the CPU path
              is the one the tests hold to the JAX package)
  6. timing   ms/step (CUDA events) of the kernel path and the plain path,
              and per-kernel times at biceps_full shapes beside their
              bounds
  7. bwd      backward sweep A / B kernels against their plain versions on
              the biceps_full step-0 inputs with seeded random cotangents,
              per column, two launches of each bitwise equal; the same on
              biceps_full x56 (1,034,600 particles, where they launch fewer
              warp slices) on 2,048 sampled rows, and their times there
  8. grad     value and grad of a 3-step checkpointed rollout loss w.r.t.
              log(K, mu) on the 462-particle slice, card (kernels) against
              CPU (plain versions)
  9. fit      the fit driver's functions on biceps_full: a 20-step rollout,
              4 snapshots, 6 Adam iterations from (0.3, 150); finite loss
              and grads, a falling loss, and exact launch counts
 10. timing   backward kernels (CUDA events and torch.profiler device
              time) against their plain versions, forward and grad ms/step
              of the fit's rollout, its peak memory, and each kernel's
              bound from the pairs these inputs need
 11. lap      the Laplacian kernel against its plain version on the
              monodomain tables of biceps_full, forward and backward forms,
              per column, two launches of each bitwise equal; a CSR SpMV of the same operator (a PyTorch library
              yardstick the port never calls) against its column 0
 12. mono     monodomain_prepare_fused + 500 fused monodomain-only steps on
              biceps_full with exact launch counts; 30 slice steps, card
              against CPU
 13. grad     d loss / d vm0 of a 3-step slice rollout, the Laplacian kernel
              path against the unfused path under autograd (both on the
              card); the ported fit_fhn_fused_demo on biceps_full (30
              steps, 8 Newton iterations) with exact launch counts
 14. modes    SPH-only (fused, 500 steps), SM-only (500 steps) and
              run_protocol(fused=False) (50 steps) on biceps_full; fused
              against unfused SPH-only on the slice
 15. timing   the Laplacian kernel, its plain version and the SpMV; ms/step
              of every mode; the monodomain value-and-grad ms/step; then
              biceps_full x56 (built in phase 7): prepare time, ms/step
              of 100 monodomain-only steps, peak memory, the Laplacian
              kernel's time and its bound from that scene's pairs; there
              the Laplacian kernel (both forms), sweeps A and B, the
              hash9 sweeps K6 A / B and K9 A / B and the v1 run sweeps K8
              A / B (on v1's bookkeeping of that state), which launch fewer
              warp slices than on biceps_full, against their plain versions
              on sampled rows, two launches of each bitwise equal, the
              sweeps' times; the Laplacian kernel's bound on biceps_full
 16. v3/v5    the v3 (hash9) and v5 (slab) bookkeeping on the card equals
              the CPU's; the hash9 sweep A / B kernels and the v5 slab
              sweep A / B kernels against their plain versions on the
              biceps_full step-0 inputs, per column; two launches of each
              bitwise equal
 17. v3/v5    run_protocol(500 steps, chunk 100) on build_scene(
              "biceps_full", fused_impl="v3") and ("v5"), exact launch
              counts; a forced v5 regrow on the slice (pack_cap before and
              after, launches including the redone steps)
 18. v3/v5    6 slice steps, card against CPU, for v3 and for v5
 19. timing   the four v3 / v5 kernels (CUDA events; K6 also torch.profiler
              device time) and their plain versions, v3 / v4 / v5 ms/step
              in this call, the slab packing, the bounds
 20. v1/v2    the v1 run bookkeeping on the card equals the CPU's; the v1
              (K8) and v2 (K9) raw-sum sweep kernels against their plain
              versions on the biceps_full step-0 inputs the step gives them,
              per column; two launches of each bitwise equal
 21. v1/v2    run_protocol(500 steps, chunk 100) on build_scene(
              "biceps_full", fused_impl="v1") and ("v2"), exact launch counts
 22. v1/v2    6 slice steps, card against CPU, for v1 and for v2
 23. timing   K8, K9 (and their torch.profiler device time) and their plain
              versions; the roofline tool on
              biceps_full, whose FMA-chain probe (K10) measures the fp32
              peak; K10 against its plain version; v1 / v2 / v4 ms/step in
              this call; the bounds

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import sys
import time
import warnings
from unittest import mock

import numpy as np
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ablation import legacy_steps
from sph_sm_monodomain_tpu_torch.ablation import legacy_sweeps as tls
from sph_sm_monodomain_tpu_torch.examples import fit_fhn_fused_demo as fhn
from sph_sm_monodomain_tpu_torch.examples import fit_material_flagship as fit
from sph_sm_monodomain_tpu_torch.models import monodomain
from sph_sm_monodomain_tpu_torch.models import variants
from sph_sm_monodomain_tpu_torch.ops import cuda_lib
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as fad
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.grid import (auto_cell_capacity,
                                                  auto_window_capacity)
from sph_sm_monodomain_tpu_torch.ops.shape_matching import (
    corrected_velocity, sm_invariants)
from sph_sm_monodomain_tpu_torch.ops.sweeps import (auto_sweep5_params,
                                                    sweep_bookkeeping2,
                                                    sweep_bookkeeping3,
                                                    sweep_bookkeeping5)
from sph_sm_monodomain_tpu_torch.tools import roofline
from sph_sm_monodomain_tpu_torch.tools.roofline import (PEAK_BYTES,
                                                        PEAK_FLOPS)
from sph_sm_monodomain_tpu_torch.utils.io import ASSETS_DIR

# kernel vs plain version: |kernel - plain| <= KERNEL_TOL * max(1, max|plain
# column|) per output column (both fp32, sums in another order)
KERNEL_TOL = 1e-5
STEPS, CHUNK = 500, 100
# card vs CPU after 6 steps: the JAX suite's fused-step tolerances
# (tests/test_pallas_sweeps.py), and for dens a relative 5e-5: two fp32
# summation orders drift apart step by step, and the CPU path itself ends
# 8.9e-6 (relative, dens) from the JAX package after these 6 steps
SLICE_TOLS = {"pos": 5e-5, "vel": 5e-3, "vm": 5e-3, "iion": 1e-5, "w": 1e-6}
SLICE_DENS_RTOL = 5e-5
# gradient card vs CPU after 3 checkpointed steps: the JAX suite's 3-step
# fused-vs-XLA grad tolerance (tests/test_fused_adjoint.py)
GRAD_STEPS, GRAD_RTOL = 3, 1e-3
# the fit at full width: rollout steps, snapshots, Adam iterations
FIT_STEPS, FIT_SNAPS, FIT_ITERS = 20, 4, 6
# the monodomain mode: steps of its main run; slice steps card vs CPU at
# the JAX suite's 30-step fused-mode bound (tests/test_variants.py:173-175);
# the gradient check's steps; the demo's steps and Newton iterations; the
# replicated scene and its steps
MONO_STEPS, MONO_SLICE_STEPS, MONO_SLICE_TOL = 500, 30, 1e-3
MONO_GRAD_STEPS, FHN_STEPS, FHN_ITERS = 3, 30, 8
REPLICATE, REPLICATE_STEPS = 56, 100
# the other modes: SPH-only and SM-only steps, unfused run_protocol steps;
# fused vs unfused SPH-only on the slice after 5 steps at the JAX suite's
# bounds (tests/test_variants.py:48-51)
MODE_STEPS, UNFUSED_STEPS = 500, 50
SPH_SLICE_STEPS, SPH_POS_TOL, SPH_DENS_RTOL = 5, 2e-5, 1e-4
# name, source, TPU kernel replaced, module holding the wrapper
KERNELS = (
    ("sweep_a3", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:446", fst),
    ("sweep_b3", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:522", fst),
    ("sweep_lap3", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:700", fst),
    ("sweep_bwd_a", "sph_sm_monodomain_tpu_torch/csrc/fused_adjoint.cu",
     "sph_sm_monodomain_tpu/ops/fused_adjoint.py:94", fad),
    ("sweep_bwd_b", "sph_sm_monodomain_tpu_torch/csrc/fused_adjoint.cu",
     "sph_sm_monodomain_tpu/ops/fused_adjoint.py:173", fad),
    ("sweep_a3_hash9", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:498", fst),
    ("sweep_b3_hash9", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:576", fst),
    ("sweep_a5", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:855", fst),
    ("sweep_b5", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:930", fst),
    ("sweep_a", "sph_sm_monodomain_tpu_torch/csrc/legacy_sweeps.cu",
     "sph_sm_monodomain_tpu/ablation/legacy_sweeps.py:119", tls),
    ("sweep_b", "sph_sm_monodomain_tpu_torch/csrc/legacy_sweeps.cu",
     "sph_sm_monodomain_tpu/ablation/legacy_sweeps.py:187", tls),
    ("sweep_a2", "sph_sm_monodomain_tpu_torch/csrc/legacy_sweeps.cu",
     "sph_sm_monodomain_tpu/ablation/legacy_sweeps.py:408", tls),
    ("sweep_b2", "sph_sm_monodomain_tpu_torch/csrc/legacy_sweeps.cu",
     "sph_sm_monodomain_tpu/ablation/legacy_sweeps.py:487", tls),
    ("fma_chains", "sph_sm_monodomain_tpu_torch/csrc/roofline.cu",
     "tools/roofline.py:79", roofline),
)
KERNEL_MODULE = {name: mod for name, _, _, mod in KERNELS}
# Bound: the larger of the kernel's FLOPs over the fp32 peak outside the
# tensor cores and its bytes (each input read once, each output written
# once) over the memory rate: PEAK_FLOPS, PEAK_BYTES (H100 SXM data sheet,
# 700 W), the pairs the sweeps need (pair_counts) and the FLOPs per needed
# pair of each sweep body (pair_flops), all from the roofline tool
# (sph_sm_monodomain_tpu_torch/tools/roofline.py).
# the forced v5 regrow on the slice: sub-block rows and a starting slab
# capacity its 32-row unions overflow
REGROW_SUB_Q, REGROW_CAP = 32, 128
# steps of the v3 / v4 / v5 and v1 / v2 / v4 ms/step comparisons
IMPL_TIMING_STEPS = 100
# the K10 comparison with its plain version, at the probe's input shape:
# chain iterations (the plain version runs two PyTorch ops each); the
# tolerance is roofline.FMA_ULP_TOL float32 ulps (both round each chain
# step once, as fmaf does)
FMA_CMP_ITERS = 4096
# steps the roofline tool times on biceps_full
ROOFLINE_STEPS = 50


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of `fn` over `reps` chained calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Mean device time per call of fn over `reps` calls, from torch.profiler:
    the CUDA kernels whose name holds `kernel` (all of them if None), so the
    wrappers' host overhead, which chained CUDA events include once a
    kernel is as short as it, is left out."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0)
             for e in prof.key_averages()
             if kernel is None or kernel in e.key)
    return us / reps / 1e3


def step0_inputs(scene, dev):
    """The sorted sweep inputs of the scene's first step."""
    st, cfg = scene.state, scene.cfg
    order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                     scene.sub_block)
    st = corrected_velocity(st, cfg, sm_inv=sm_invariants(st, cfg))
    fs, feats_a = fst.build_qm_feats(st, cx, cyz, order)
    return fs, feats_a, lo, hi


def bound(name, counts, n_rows, nbytes=None):
    """(bound ms, "bytes" or "operations", FLOPs, bytes) of one launch.
    Bytes, unless given: (N, 16) query matrix, (16, N) features, 128-row
    sub-blocks' window bounds, the 32-slot constants and the (N, 16)
    output."""
    flops = roofline.pair_flops(name, counts)
    if nbytes is None:
        nbytes = 4 * (3 * 16 * n_rows + 2 * (n_rows // 128) * 4 + 32)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def column_errors(got, want):
    """(max abs error, worst err / (KERNEL_TOL * max(1, max|want col|)))."""
    err = (got - want).abs().amax(dim=0)
    bound = KERNEL_TOL * torch.clamp(want.abs().amax(dim=0), min=1.0)
    return float(err.max()), float((err / bound).max()), err.tolist()


def check_in_world(state, cfg, what: str) -> None:
    """Active positions finite and inside the world box."""
    pos = state.pos[state.active]
    world = torch.tensor(cfg.world_size, device=pos.device)
    if not torch.isfinite(pos).all():
        raise AssertionError(f"{what}: non-finite positions")
    if not ((pos >= 0.0) & (pos <= world)).all():
        raise AssertionError(f"{what}: positions outside the world box")


def laplacian_csr(qm, feats, cfg):
    """The monodomain mode's operator L = A - diag(rowsum A), A_ij = vol_j
    W2(r_ij), as one CSR matrix in sorted order, built from the plain
    version's pair weights (ops/fused_step.lap_pair_weights); L @ vm is the
    Laplacian kernel's column 0. The self pair's weight is 0 (the r^2 >
    1e-12 guard), so the diagonal holds -rowsum alone."""
    P = fst._Phys(fst.kernel_params(cfg, None, qm.device))
    gm = float(fst._g_mid(cfg))
    n = qm.shape[0]
    rows = fst._rows_per_chunk(n, qm.device)
    idx, vals = [], []
    for s in range(0, n, rows):
        vw = fst.lap_pair_weights(qm[s:s + rows], feats, gm, P)
        r = torch.arange(vw.shape[0], device=qm.device)
        vw[r, s + r] -= vw.sum(1)
        nz = vw.nonzero()
        vals.append(vw[nz[:, 0], nz[:, 1]])
        idx.append(nz + torch.tensor([s, 0], device=qm.device))
    with warnings.catch_warnings():  # sparse CSR's "beta state" notice
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(torch.cat(idx).T, torch.cat(vals),
                                       (n, n)).coalesce().to_sparse_csr()


def timed_run(run, steps: int):
    """(device ms per step of run(steps), its result), CUDA events, after a
    one-step warm-up run."""
    run(1)
    out = {}
    ms = cuda_ms(lambda: out.setdefault("r", run(steps)), 1) / steps
    return ms, out["r"]


def slice_scene(dev, fused_impl="v4"):
    """The 462-particle biceps slice (every 40th row of biceps_full) as a
    scene of the given fused generation, tuned as build_scene tunes it."""
    pts = T.read_cloud_csv(ASSETS_DIR / "biceps_simple_out_18475.csv")[::40]
    cfg = T.SimConfig()
    st = T.stim.turn_on_stim_mesh(T.init_fluid(pts, cfg, device=dev), pts,
                                  cfg)
    tune = {}
    if fused_impl in ("v5", "v5s"):
        sub_q, kb, w_chunk = auto_sweep5_params(pts, cfg)
        tune = dict(sub_block=sub_q, pack_cap=kb, block_window=w_chunk)
    return T.Scene(state=st, cfg=cfg,
                   cell_capacity=auto_cell_capacity(pts, cfg),
                   neighbor_capacity=auto_window_capacity(pts, cfg),
                   num_particles=pts.shape[0], name="biceps_every40",
                   fused_impl=fused_impl, **tune)


def step0_inputs_v3(scene):
    """The sorted v3 sweep inputs of the scene's first step: (QM_A,
    sweep-A features, blk_lo, blk_hi)."""
    st, cfg = scene.state, scene.cfg
    order, inv, lo, hi, chash = sweep_bookkeeping2(st.pos, st.active, cfg,
                                                   scene.sub_block)
    st = corrected_velocity(st, cfg, sm_inv=sm_invariants(st, cfg))
    fs, feats_a = fst.build_qm_feats(st, chash, torch.zeros_like(chash),
                                     order)
    return fs, feats_a, lo, hi


def step0_inputs_v5(scene):
    """The sorted v5 sweep inputs of the scene's first step: (QM_A, src,
    trips, overflow)."""
    st, cfg = scene.state, scene.cfg
    order, inv, src, trips, over, cf, cm, cs = sweep_bookkeeping5(
        st.pos, st.active, cfg, scene.sub_block, scene.pack_cap,
        scene.block_window)
    st = corrected_velocity(st, cfg, sm_inv=sm_invariants(st, cfg))
    return fst.build_qm_feats5(st, cf, cm, cs, order), src, trips, over


def check_kernel(report, name, got, want):
    """Hold a kernel's output to its plain version per column; record the
    max abs error."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    max_err, ratio, per_col = column_errors(got, want)
    report[name] = {"max_abs_err": max_err}
    print(f"{name}: max_abs_err {max_err:.6g}, worst column at "
          f"{ratio:.4g} of the bound {KERNEL_TOL:g}*max(1,max|plain|); "
          f"per column {[f'{e:.3g}' for e in per_col]}", flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name} disagrees with its plain version")


def check_repeatable(name, launch):
    """Two launches of a kernel on the same inputs give the same bits (its
    partial sums are added in a fixed order, with no atomics)."""
    a, b = launch(), launch()
    torch.cuda.synchronize()
    print(f"{name}: two launches bitwise equal: {torch.equal(a, b)}",
          flush=True)
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two launches differ")


def sampled_rows(n: int, dev, warps: int = 64) -> torch.Tensor:
    """`warps` whole warps of 32 sorted rows spread evenly over n rows: the
    rows a kernel is held to its plain version on where the dense plain
    version of all n rows would take minutes."""
    w = torch.linspace(0, n // 32 - 1, warps, device=dev).long()
    return (w[:, None] * 32 + torch.arange(32, device=dev)).reshape(-1)


def plain_on_rows(plain, qm, rows):
    """plain(query rows) on `rows` of qm, 32 rows a call: the plain
    versions size their chunks by the query count alone, so a few rows
    against a million candidates would make one chunk of many GiB."""
    return torch.cat([plain(qm[r]) for r in rows.split(32)])


def check_big_kernels(big, btab, dev) -> dict:
    """Sweeps A and B and the Laplacian kernel (forward and backward forms)
    on a replicated scene, where they launch fewer warp slices than on
    biceps_full: seeded random vm and cotangent, held to their plain
    versions on sampled rows, two launches of each bitwise equal. Returns
    the sweeps' times there, {name: ms}."""
    cfg, sq, n = big.cfg, big.sub_block, big.state.capacity
    rows = sampled_rows(n, dev)
    rng = np.random.default_rng(56)
    rand = lambda: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(n).astype(np.float32)).to(dev)
    scratch = {}
    vm_r, g_r = rand() * 10.0, rand()
    geom = (btab.pos_s, btab.cx_s, btab.cyz_s)
    for form, (qm, ft) in (
            ("forward", variants._lap_inputs(vm_r, btab.vol_s, vm_r, *geom)),
            ("backward", variants._lap_inputs(torch.zeros_like(g_r),
                                              torch.ones_like(g_r), g_r,
                                              *geom))):
        launch = lambda: fst.sweep_lap3(qm, ft, btab.blk_lo,   # noqa: E731
                                        btab.blk_hi, cfg, sq)
        check_kernel(scratch, f"sweep_lap3 {form} (x{REPLICATE}, "
                     f"{rows.numel()} sampled rows)", launch()[rows],
                     plain_on_rows(lambda q, f=ft: fst.sweep_lap3_plain(
                         q, f, cfg), qm, rows))
        check_repeatable(f"sweep_lap3 {form} (x{REPLICATE})", launch)
    st = big.state.replace(vm=rand() * 10.0)
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg, sq)
    fs, fa = fst.build_qm_feats(st, cx, cyz, order)
    out_a = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sq)
    fb = fst.feats_b(out_a)
    sweeps = {"sweep_a3": (lambda: fst.sweep_a3(fs, fa, lo, hi, cfg,
                                                sub_q=sq),
                           lambda q: fst.sweep_a3_plain(q, fa, cfg), fs),
              "sweep_b3": (lambda: fst.sweep_b3(out_a, fb, lo, hi, cfg,
                                                sub_q=sq),
                           lambda q: fst.sweep_b3_plain(q, fb, cfg), out_a)}
    return check_big_sweeps(sweeps, rows)


def check_big_sweeps(sweeps, rows) -> dict:
    """Each of {name: (launch, plain, qm)} on the replicated scene: launch()
    held to plain(query rows of qm) on `rows`, two launches bitwise equal,
    and timed. Returns {name: ms}."""
    scratch, times = {}, {}
    for name, (launch, plain, qm) in sweeps.items():
        check_kernel(scratch, f"{name} (x{REPLICATE}, {rows.numel()} "
                     "sampled rows)", launch()[rows],
                     plain_on_rows(plain, qm, rows))
        check_repeatable(f"{name} (x{REPLICATE})", launch)
        times[name] = cuda_ms(launch, 20)
        print(f"{name} on x{REPLICATE}: kernel {times[name]:.4f} ms",
              flush=True)
    return times


def check_big_backward(big, dev) -> dict:
    """The backward sweeps A and B on a replicated scene, where they launch
    fewer warp slices than on biceps_full: its step-0 sweep inputs (sweep
    A's output from its kernel) with seeded random cotangents, held to
    their plain versions on sampled rows, two launches of each bitwise
    equal. Returns their times there, {name: ms}."""
    cfg, sq, n = big.cfg, big.sub_block, big.state.capacity
    rows = sampled_rows(n, dev)
    rng = np.random.default_rng(57)
    cot = lambda *shape: torch.from_numpy(                   # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    st = big.state
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg, sq)
    fs, fa = fst.build_qm_feats(st, cx, cyz, order)
    out_a = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sq)
    qa = fad.bwd_a_query(fs, cot(n), cot(n, 3))
    qb = fad.bwd_b_query(out_a, cot(n, 3), cot(n))
    fqa, fqb = qa.T.contiguous(), qb.T.contiguous()
    sweeps = {
        "sweep_bwd_a": (lambda: fad.sweep_bwd_a(qa, fqa, lo, hi, cfg, sq),
                        lambda q: fad.sweep_bwd_a_plain(q, fqa, cfg), qa),
        "sweep_bwd_b": (lambda: fad.sweep_bwd_b(qb, fqb, lo, hi, cfg, sq),
                        lambda q: fad.sweep_bwd_b_plain(q, fqb, cfg), qb)}
    return check_big_sweeps(sweeps, rows)


def hash9_inputs(state, cfg, sub_q):
    """A state's v3 sweep inputs as hash9_sweeps takes them: (QM_A, sweep-A
    features, OUT_A from the K6 A kernel, sweep-B features, blk_lo,
    blk_hi)."""
    order, _, lo, hi, chash = sweep_bookkeeping2(state.pos, state.active,
                                                 cfg, sub_q)
    fs, fa = fst.build_qm_feats(state, chash, torch.zeros_like(chash), order)
    out_a = fst.sweep_a3_hash9(fs, fa, lo, hi, cfg, sub_q=sub_q)
    return fs, fa, out_a, fst.feats_b(out_a), lo, hi


def hash9_sweeps(fs, fa, out_a, fb, lo, hi, cfg, sub_q):
    """The v3 sweeps A / B (K6) and the v2 raw-sum sweeps A / B (K9) on one
    set of v3 sweep inputs, {name: (launch, plain(query rows), qm)}. K9's
    query and feature layouts are K6's columns and rows 0-8 and 12 (pos,
    velocity, volume, mass or pressure and vm, the hash), and K9's sums are
    K6's before the epilogue, so both launch on K6's matrices."""
    return {
        "sweep_a3_hash9": (
            lambda: fst.sweep_a3_hash9(fs, fa, lo, hi, cfg, sub_q=sub_q),
            lambda q: fst.sweep_a3_plain(q, fa, cfg, stencil="hash9"), fs),
        "sweep_b3_hash9": (
            lambda: fst.sweep_b3_hash9(out_a, fb, lo, hi, cfg, sub_q=sub_q),
            lambda q: fst.sweep_b3_plain(q, fb, cfg, stencil="hash9"),
            out_a),
        "sweep_a2": (
            lambda: tls._window_sweep("sph_sweep_a2", fs, fa, lo, hi, cfg,
                                      sub_q),
            lambda q: tls._plain_a2(q, fa, cfg), fs),
        "sweep_b2": (
            lambda: tls._window_sweep("sph_sweep_b2", out_a, fb, lo, hi, cfg,
                                      sub_q),
            lambda q: tls._plain_b2(q, fb, cfg), out_a)}


def v1_sweeps(state, cfg, sub_q):
    """The v1 raw-sum sweeps A / B (K8) on a state's v1 bookkeeping, sweep
    B on the v1 step's glue of the K8 A kernel's sums, {name: (launch,
    plain(query rows), row indices)}: each query row brings its own runs,
    so the plain versions are called on the rows' indices."""
    order, _, qs, qe, _, _ = tls.sweep_bookkeeping(state.pos, state.active,
                                                   cfg, sub_q)
    pos, cvel, mass, dens, vm = (t[order] for t in (
        state.pos, state.corrected_vel, state.mass, state.dens, state.vm))
    qa, fa = tls._inputs_a(pos, cvel, fst._safe_div(mass, dens, dens > 0.0),
                           mass)
    sa = tls._run_sweep("sph_sweep_a1", qa, fa, qs, qe, cfg)
    d_now = sa[:, 0]
    qb, fb = tls._inputs_b(pos, cvel + sa[:, 1:4] * cfg.velocity_mixing,
                           fst._safe_div(mass, d_now, d_now > 0.0),
                           cfg.k_stiffness * (d_now - cfg.stand_density), vm)
    idx = torch.arange(qa.shape[0], device=qa.device)
    return {name: (
        lambda k=kern, q=q, f=f: tls._run_sweep(k, q, f, qs, qe, cfg),
        lambda r, p=plain, q=q, f=f: tls.plain_on_run_rows(
            lambda *a: p(*a, cfg), q, f, qs, qe, r), idx)
        for name, kern, plain, q, f in (
            ("sweep_a", "sph_sweep_a1", tls._plain_a1, qa, fa),
            ("sweep_b", "sph_sweep_b1", tls._plain_b1, qb, fb))}


def check_protocol_run(state, aux, cfg, what):
    """A 500-step run_protocol's end: finite and in the world box, stim
    off, no overflow."""
    check_in_world(state, cfg, what)
    act = state.active
    if not (state.stim[act] == -10000.0).all():
        raise AssertionError(f"{what}: stim != -10000 after stim-off")
    if int(aux.overflow) != 0:
        raise AssertionError(f"{what}: overflow {int(aux.overflow)}")


def slice_card_vs_cpu(small, label):
    """6 slice steps (chunk 4, stim off at 3) on the card against the CPU
    at SLICE_TOLS and SLICE_DENS_RTOL."""
    sc_cpu = small._replace(state=small.state.to("cpu"))
    got, _, _ = T.run_protocol(small, num_steps=6, chunk=4, stim_off_step=3)
    want, _, _ = T.run_protocol(sc_cpu, num_steps=6, chunk=4,
                                stim_off_step=3)
    a = want.active.numpy()
    g, w = T.state_to_numpy(got), T.state_to_numpy(want)
    for name, atol in SLICE_TOLS.items():
        err = float(np.abs(g[name][a] - w[name][a]).max())
        print(f"{label} slice {name}: max abs diff {err:.3g} (tolerance "
              f"{atol:g})", flush=True)
        if not err <= atol:
            raise AssertionError(f"{label} slice {name} diverged")
    rel = float((np.abs(g["dens"][a] - w["dens"][a]) / np.abs(w["dens"][a]))
                .max())
    print(f"{label} slice dens: max rel diff {rel:.3g} (tolerance "
          f"{SLICE_DENS_RTOL:g})", flush=True)
    if not rel <= SLICE_DENS_RTOL:
        raise AssertionError(f"{label} slice dens diverged")


def counted_protocol(sc, names, **kw):
    """run_protocol(sc, **kw) with the launch counts of the kernels `names`
    set to 0 just before it and read just after, and each chunk's
    simulate call recorded as (pack_cap, steps): a regrown chunk shows as a
    call redone with a larger pack_cap. Returns (state, aux, traj,
    launches, calls, wall seconds)."""
    calls, real_simulate = [], monodomain.simulate

    def recording_simulate(*args, **skw):
        calls.append((skw["pack_cap"], skw["num_steps"]))
        return real_simulate(*args, **skw)

    for nm in names:
        getattr(KERNEL_MODULE[nm], nm).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(monodomain, "simulate", recording_simulate):
        st, aux, traj = T.run_protocol(sc, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (st, aux, traj,
            {nm: getattr(KERNEL_MODULE[nm], nm).launches for nm in names},
            calls, wall)


# the v1 / v2 generations' raw-sum sweeps (ablation/legacy_sweeps.py), and
# how many leading arguments of a recorded call are fields: sweep A's pos,
# cvel, vol, mass, sweep B's pos, ivel, vol, pres, vm, and v2's hash; the
# two bounds arrays follow (v1: qstart, qend; v2: blk_lo, blk_hi); what
# torch.profiler's kernel names hold
RAW_SWEEPS = {"v1": ("sweep_a", "sweep_b"), "v2": ("sweep_a2", "sweep_b2")}
RAW_KERNEL_NAMES = {"sweep_a": "sweep_a1", "sweep_b": "sweep_b1",
                    "sweep_a2": "sweep_a2", "sweep_b2": "sweep_b2"}
RAW_FIELDS = {"sweep_a": 4, "sweep_b": 5, "sweep_a2": 5, "sweep_b2": 6}


def stack4(sums):
    """A raw sweep's (dens, xsph) or (acc, lap) as one (N, 4) tensor."""
    return torch.cat([t if t.dim() == 2 else t[:, None] for t in sums], dim=1)


def raw_sweep_calls(scene):
    """The raw-sum sweeps' calls of a v1 / v2 scene's first fused step on
    the card, as the step makes them (all positional): {name: args}.
    Recording launches each kernel once."""
    calls = {}

    def recorder(name):
        real = getattr(tls, name)

        def record(*args):
            calls[name] = args
            return real(*args)
        return record

    names = RAW_SWEEPS[scene.fused_impl]
    with mock.patch.multiple(legacy_steps, **{n: recorder(n) for n in names}):
        T.step_fused(scene.state, scene.cfg, scene.sub_block,
                     impl=scene.fused_impl)
    return calls


def raw_launchers(name, args):
    """(kernel, plain) callables of raw sweep `name` on a recorded call's
    inputs, each returning the (N, 4) sums. The kernel is launched directly
    on (N, 16) queries and (16, N) features built once (no launch count, no
    input glue); the plain sums run on the same matrices."""
    cfg = next(a for a in args if isinstance(a, T.SimConfig))
    nf = RAW_FIELDS[name]
    build = tls._inputs_a if name in ("sweep_a", "sweep_a2") else tls._inputs_b
    hash_s = args[nf - 1] if name in ("sweep_a2", "sweep_b2") else None
    qm, feats = build(*args[:nf - (hash_s is not None)], hash_s)
    b0, b1 = args[nf:nf + 2]
    if name == "sweep_a":
        return (lambda: tls._run_sweep("sph_sweep_a1", qm, feats, b0, b1,
                                       cfg),
                lambda: tls._plain_a1(qm, feats, b0, b1, cfg))
    if name == "sweep_b":
        return (lambda: tls._run_sweep("sph_sweep_b1", qm, feats, b0, b1,
                                       cfg),
                lambda: tls._plain_b1(qm, feats, b0, b1, cfg))
    plain = tls._plain_a2 if name == "sweep_a2" else tls._plain_b2
    return (lambda: tls._window_sweep(f"sph_{name}", qm, feats, b0, b1, cfg,
                                      args[-1]),
            lambda: plain(qm, feats, cfg))


def phase_raw_kernels(dev, report):
    """Phase 20: the v1 bookkeeping card == CPU; K8 and K9 against their
    plain versions on the step-0 inputs the biceps_full step gives them.
    Returns {impl: (scene, recorded calls)}."""
    raw = {}
    for impl in RAW_SWEEPS:
        sc = T.build_scene("biceps_full", fused_impl=impl, device=dev)
        raw[impl] = (sc, raw_sweep_calls(sc))
    sc, st = raw["v1"][0], raw["v1"][0].state
    on_card = tls.sweep_bookkeeping(st.pos, st.active, sc.cfg, sc.sub_block)
    on_cpu = tls.sweep_bookkeeping(st.pos.cpu(), st.active.cpu(), sc.cfg,
                                   sc.sub_block)
    for name, a, b in zip(("order", "inv", "qstart", "qend", "blk_start",
                           "blk_len"), on_card, on_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"v1 bookkeeping {name} differs card vs CPU")
    print(f"v1 bookkeeping (sub_block {sc.sub_block}): card == CPU exactly "
          "(order, inv, per-query runs, block windows)", flush=True)
    for impl, (sc, calls) in raw.items():
        for name in RAW_SWEEPS[impl]:
            args = calls[name]
            nb = RAW_FIELDS[name] + 2 * (impl == "v1")
            check_kernel(report, name, stack4(getattr(tls, name)(*args)),
                         stack4(getattr(tls, f"{name}_plain")(
                             *args[:nb], sc.cfg)))
            check_repeatable(name, raw_launchers(name, args)[0])
    return raw


def phase_raw_protocol(raw, v4_end, launches) -> dict:
    """Phase 21: 500-step run_protocol of the v1 and v2 scenes, each kernel
    launched exactly once a step; positions beside v4's."""
    runs = {}
    for impl, (sc, _) in raw.items():
        st_r, aux_r, _, got, calls, wall = counted_protocol(
            sc, RAW_SWEEPS[impl], num_steps=STEPS, chunk=CHUNK)
        run_steps = sum(n for _, n in calls)
        act = sc.state.active
        diff = float((st_r.pos[act] - v4_end.pos[act]).abs().max())
        print(f"{impl}: {STEPS} steps in {wall:.3f} s wall, launches {got}; "
              f"positions vs v4's after {STEPS} steps: max abs diff "
              f"{diff:.6g}", flush=True)
        if run_steps != STEPS or any(n != STEPS for n in got.values()):
            raise AssertionError(f"{impl} launches {got} over {run_steps} "
                                 f"steps, want {STEPS}")
        check_protocol_run(st_r, aux_r, sc.cfg, f"{impl} run_protocol")
        launches.update(got)
        runs[impl] = {"wall_s": wall, "pos_vs_v4": diff}
    return runs


def phase_raw_timing(dev, raw, scene, counts, times, bounds, launches,
                     report) -> dict:
    """Phase 23: K8 and K9 against their plain versions; the roofline tool
    on biceps_full, whose FMA-chain probe (K10) is the path that launches
    K10; K10 against its plain version; v1 / v2 / v4 ms/step; the bounds.
    Returns the numbers for the JSON line."""
    n_rows = scene.state.capacity
    raw_device = {}
    for impl, (sc, calls) in raw.items():
        for name in RAW_SWEEPS[impl]:
            kern, plain = raw_launchers(name, calls[name])
            times[name] = (cuda_ms(kern, 200), cuda_ms(plain, 5))
            raw_device[name] = device_ms(kern, 50, RAW_KERNEL_NAMES[name])
            print(f"{name}: kernel {times[name][0]:.4f} ms, "
                  f"{raw_device[name]:.4f} ms device (torch.profiler), "
                  f"plain {times[name][1]:.4f} ms", flush=True)

    roofline.fma_chains.launches = 0
    torch.cuda.synchronize()
    roof = roofline.report("biceps_full", None, ROOFLINE_STEPS)
    torch.cuda.synchronize()
    launches["fma_chains"] = roofline.fma_chains.launches
    if not (launches["fma_chains"] > 0 and roof["peak_flops"] > 0.0):
        raise AssertionError(f"roofline: {launches['fma_chains']} K10 "
                             f"launches, peak {roof['peak_flops']}")
    if roof["pairs"] != counts:
        raise AssertionError(f"roofline pairs {roof['pairs']} differ from "
                             f"the bounds' {counts}")
    x = roofline.fma_probe_input(dev)
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        x.numel()).astype(np.float32)).to(dev)
    got = roofline.fma_chains(x, FMA_CMP_ITERS)
    want = roofline.fma_chains_plain(x, FMA_CMP_ITERS)
    torch.cuda.synchronize()
    ulps = roofline.ulp_error(got, want)
    report["fma_chains"] = {"max_abs_err": float((got - want).abs().max())}
    print(f"fma_chains ({x.numel()} threads x {roofline.FMA_CHAINS} chains, "
          f"{FMA_CMP_ITERS} iterations): max_abs_err "
          f"{report['fma_chains']['max_abs_err']:.6g}, {ulps:.3g} ulp "
          f"(tolerance {roofline.FMA_ULP_TOL:g}); probe peak "
          f"{roof['peak_flops'] / 1e12:.4f} TFLOP/s against the data sheet's "
          f"{PEAK_FLOPS / 1e12:.0f}", flush=True)
    if not (torch.isfinite(got).all() and ulps <= roofline.FMA_ULP_TOL):
        raise AssertionError("fma_chains disagrees with its plain version")
    # timed at the probe's longer chain, where launch and tail are small
    iters = roofline.FMA_ITERS[1]
    times["fma_chains"] = (
        cuda_ms(lambda: roofline.fma_chains(x, iters), 5),
        cuda_ms(lambda: roofline.fma_chains_plain(x, iters), 1))
    print(f"fma_chains at {iters} iterations: kernel "
          f"{times['fma_chains'][0]:.4f} ms, plain "
          f"{times['fma_chains'][1]:.4f} ms", flush=True)

    impl_ms = {"v1": [], "v2": [], "v4": []}
    scenes = {"v1": raw["v1"][0], "v2": raw["v2"][0], "v4": scene}
    with torch.no_grad():
        for label in ("v4", "v1", "v2", "v2", "v1", "v4"):
            sc = scenes[label]
            impl_ms[label].append(timed_run(
                lambda k, sc=sc: T.simulate(sc.state, sc.cfg, k,
                                            sub_q=sc.sub_block,
                                            impl=sc.fused_impl),
                IMPL_TIMING_STEPS)[0])
    print(f"ms/step over {IMPL_TIMING_STEPS} steps, in the order v4 v1 v2 "
          f"v2 v1 v4: {impl_ms}", flush=True)

    # bytes: queries, features, the run or window bounds, constants, out
    blocks2 = n_rows // raw["v2"][0].sub_block
    nbytes = {"sweep_a": 4 * (2 * 16 * n_rows + 2 * 16 * n_rows
                              + 4 * n_rows + 32),
              "sweep_a2": 4 * (2 * 16 * n_rows + 2 * 16 * blocks2
                               + 4 * n_rows + 32)}
    nbytes.update(sweep_b=nbytes["sweep_a"], sweep_b2=nbytes["sweep_a2"])
    for name, nb in nbytes.items():
        bounds[name] = bound(name, counts, n_rows, nb)
    flops = 2.0 * iters * roofline.FMA_CHAINS * x.numel()
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, 8 * x.numel() / PEAK_BYTES * 1e3
    bounds["fma_chains"] = (max(t_ops, t_bytes), "operations"
                            if t_ops >= t_bytes else "bytes", flops,
                            8 * x.numel())
    for name in list(nbytes) + ["fma_chains"]:
        b_ms, by, fl, nb = bounds[name]
        print(f"{name}: {fl / 1e6:.3f} MFLOP, {nb / 1e6:.3f} MB, bound "
              f"{b_ms * 1e3:.4f} us ({by}), kernel at "
              f"{b_ms / times[name][0] * 100:.3f}% of it", flush=True)
    walked = {impl: roofline.walked_per_row(sc) for impl, (sc, _) in
              raw.items()}
    print(f"candidates walked per query row (step 0): {walked}", flush=True)
    return {"raw_impl_ms_per_step": impl_ms, "roofline": roof,
            "raw_walked_per_row": walked, "raw_device_ms": raw_device}


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False — this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(roofline.card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} ({kind})", flush=True)
    monodomain.ensure_fp32()

    phase("2 build")
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    cuda_lib.load()
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)

    phase("3 kernels vs plain versions (biceps_full step-0 inputs)")
    t0 = time.perf_counter()
    scene = T.build_scene("biceps_full", device=dev)
    torch.cuda.synchronize()
    print(f"scene {scene.name}: {scene.num_particles} particles, capacity "
          f"{scene.state.capacity}, sub_block {scene.sub_block}, built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    cfg, sub_q = scene.cfg, scene.sub_block
    st = scene.state
    on_card = sweep_bookkeeping3(st.pos, st.active, cfg, sub_q)
    on_cpu = sweep_bookkeeping3(st.pos.cpu(), st.active.cpu(), cfg, sub_q)
    for name, a, b in zip(("order", "inv", "blk_lo", "blk_hi", "cx", "cyz"),
                          on_card, on_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"bookkeeping {name} differs card vs CPU")
    print("bookkeeping: card == CPU exactly (order, inv, windows, cells)",
          flush=True)
    fs, feats_a, lo, hi = step0_inputs(scene, dev)
    plain_a = fst.sweep_a3_plain(fs, feats_a, cfg)
    report = {}
    check_kernel(report, "sweep_a3",
                 fst.sweep_a3(fs, feats_a, lo, hi, cfg, sub_q=sub_q), plain_a)
    feats_b = fst.feats_b(plain_a)  # B compared on the same OUT_A
    check_kernel(report, "sweep_b3",
                 fst.sweep_b3(plain_a, feats_b, lo, hi, cfg, sub_q=sub_q),
                 fst.sweep_b3_plain(plain_a, feats_b, cfg))
    check_repeatable("sweep_a3", lambda: fst.sweep_a3(fs, feats_a, lo, hi,
                                                      cfg, sub_q=sub_q))
    check_repeatable("sweep_b3", lambda: fst.sweep_b3(plain_a, feats_b, lo,
                                                      hi, cfg, sub_q=sub_q))

    phase(f"4 main path: run_protocol({STEPS} steps, chunk {CHUNK})")
    fst.sweep_a3.launches = 0
    fst.sweep_b3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, aux, traj = T.run_protocol(scene, num_steps=STEPS, chunk=CHUNK,
                                      record_every=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sweep_a3": fst.sweep_a3.launches,
                "sweep_b3": fst.sweep_b3.launches}
    print(f"{STEPS} steps in {wall:.3f} s wall, launches {launches}",
          flush=True)
    for name, n in launches.items():
        if n != STEPS:
            raise AssertionError(f"{name} launched {n} times, want {STEPS}")
    check_protocol_run(state, aux, cfg, "run_protocol")
    act = state.active
    orig = scene.state.orig_pos[act]
    for step in (250, 500):
        d = torch.linalg.vector_norm(traj["pos"][step // 50 - 1][act] - orig,
                                     dim=-1)
        print(f"mean displacement at step {step}: {float(d.mean()):.6g} "
              f"(max {float(d.max()):.6g})", flush=True)

    phase("5 small input: kernels on the card vs plain versions on the CPU")
    small = slice_scene(dev)
    slice_card_vs_cpu(small, "v4")

    phase("6 timing (CUDA events)")
    st0 = scene.state
    sm_inv = sm_invariants(st0, cfg)
    holder = {"s": st0}

    def one_step():
        holder["s"], _ = T.step_fused(holder["s"], cfg, sub_q=sub_q,
                                      sm_inv=sm_inv)

    for _ in range(10):
        one_step()
    kernel_ms = cuda_ms(one_step, 100)
    plain = {"sweep_a3": lambda q, f, lo, hi, c, **kw:
             fst.sweep_a3_plain(q, f, c, dynp=kw.get("dynp")),
             "sweep_b3": lambda q, f, lo, hi, c, **kw:
             fst.sweep_b3_plain(q, f, c, dynp=kw.get("dynp"))}
    holder["s"] = st0
    with mock.patch.object(monodomain, "sweep_a3", plain["sweep_a3"]), \
            mock.patch.object(monodomain, "sweep_b3", plain["sweep_b3"]):
        one_step()
        plain_ms = cuda_ms(one_step, 5)
    print(f"ms/step kernel path {kernel_ms:.4f}, plain path {plain_ms:.4f}; "
          f"particle-steps/s kernel path "
          f"{scene.num_particles / kernel_ms * 1e3:.1f}", flush=True)
    times = {
        "sweep_a3": (cuda_ms(lambda: fst.sweep_a3(fs, feats_a, lo, hi, cfg,
                                                  sub_q=sub_q), 200),
                     cuda_ms(lambda: fst.sweep_a3_plain(fs, feats_a, cfg),
                             5)),
        "sweep_b3": (cuda_ms(lambda: fst.sweep_b3(plain_a, feats_b, lo, hi,
                                                  cfg, sub_q=sub_q), 200),
                     cuda_ms(lambda: fst.sweep_b3_plain(plain_a, feats_b,
                                                        cfg), 5)),
    }
    n_rows = fs.shape[0]
    counts = roofline.pair_counts(fs, lo, hi, cfg, sub_q)
    print(f"pairs the sweeps need (biceps_full step 0): {counts}",
          flush=True)
    for name, (k_ms, p_ms) in times.items():
        b_ms = bound(name, counts, n_rows)[0]
        print(f"{name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms * 1e3:.4f} us (kernel at {b_ms / k_ms * 100:.3f}% of "
              "it)", flush=True)

    phase("7 backward kernels vs plain versions (biceps_full step-0 "
          f"inputs, seeded random cotangents; x{REPLICATE} on sampled rows)")
    rng = np.random.default_rng(0)
    cot = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    qm_a = fad.bwd_a_query(fs, cot(n_rows), cot(n_rows, 3))
    qm_b = fad.bwd_b_query(plain_a, cot(n_rows, 3), cot(n_rows))
    feats_ba, feats_bb = qm_a.T.contiguous(), qm_b.T.contiguous()
    bwd = {"sweep_bwd_a": (lambda: fad.sweep_bwd_a(qm_a, feats_ba, lo, hi,
                                                   cfg, sub_q),
                           lambda: fad.sweep_bwd_a_plain(qm_a, feats_ba,
                                                         cfg)),
           "sweep_bwd_b": (lambda: fad.sweep_bwd_b(qm_b, feats_bb, lo, hi,
                                                   cfg, sub_q),
                           lambda: fad.sweep_bwd_b_plain(qm_b, feats_bb,
                                                         cfg))}
    for name, (launch, plain) in bwd.items():
        check_kernel(report, name, launch(), plain())
        check_repeatable(name, launch)
    t0 = time.perf_counter()
    big = T.build_scene("biceps_full", replicate=REPLICATE, device=dev)
    torch.cuda.synchronize()
    build_big_s = time.perf_counter() - t0
    print(f"biceps_full x{REPLICATE}: {big.num_particles} particles, scene "
          f"built in {build_big_s:.3f} s", flush=True)
    big_bwd_ms = check_big_backward(big, dev)

    phase(f"8 gradient: {GRAD_STEPS}-step checkpointed rollout on the "
          "slice, card vs CPU")
    theta = fit.theta_of(0.5, 100.0, "cpu")
    grads = {}
    for where, sc in (("card", small),
                      ("cpu", small._replace(state=small.state.to("cpu")))):
        d = sc.state.device
        loss = fit.make_loss(sc, sm_invariants(sc.state, sc.cfg),
                             torch.zeros((), device=d), GRAD_STEPS, 1)
        val, g = fit.value_and_grad(loss, theta.to(d))
        grads[where] = (float(val), g.cpu().numpy())
        print(f"{where}: loss {grads[where][0]:.9g}, d/d log(K, mu) "
              f"{grads[where][1].tolist()}", flush=True)
    (vc, gc), (vp, gp) = grads["card"], grads["cpu"]
    rel = np.abs(np.append(gc - gp, vc - vp)) / np.abs(np.append(gp, vp))
    print(f"max rel diff {float(rel.max()):.3g} (tolerance {GRAD_RTOL:g})",
          flush=True)
    if not (np.all(np.isfinite(gc)) and float(rel.max()) <= GRAD_RTOL):
        raise AssertionError("slice gradient: card and CPU disagree")

    phase(f"9 fit: biceps_full, {FIT_STEPS}-step rollout, {FIT_SNAPS} "
          f"snapshots, {FIT_ITERS} Adam iterations from {fit.THETA0}")
    theta_true = fit.theta_of(fit.TRUE_K, fit.TRUE_MU, dev)
    theta0 = fit.theta_of(*fit.THETA0, dev)
    for name, _, _, mod in KERNELS:
        getattr(mod, name).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        target = fit.rollout_disp(scene, sm_inv, theta_true, FIT_STEPS,
                                  FIT_SNAPS)
    fit_loss = fit.make_loss(scene, sm_inv, target, FIT_STEPS, FIT_SNAPS)
    log_theta, losses, fgrads = fit.adam_fit(
        fit_loss, theta0, FIT_ITERS, log=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    fit_launches = {name: getattr(mod, name).launches
                    for name, _, _, mod in KERNELS}
    losses = [float(v) for v in losses]
    k_fit, mu_fit = torch.exp(log_theta).tolist()
    print(f"fit in {time.perf_counter() - t0:.3f} s wall: losses {losses}, "
          f"K {k_fit:.6g}, mu {mu_fit:.6g}, launches {fit_launches}",
          flush=True)
    if not (np.all(np.isfinite(losses))
            and all(bool(torch.isfinite(g).all()) for g in fgrads)):
        raise AssertionError("fit: non-finite loss or gradient")
    if not losses[-1] < losses[0]:
        raise AssertionError("fit: the loss did not fall")
    # checkpointing recomputes each step's forward during the backward
    # pass; the target rollout runs the forward once more
    want = {"sweep_a3": FIT_STEPS * (1 + 2 * FIT_ITERS),
            "sweep_b3": FIT_STEPS * (1 + 2 * FIT_ITERS),
            "sweep_lap3": 0,
            "sweep_bwd_a": FIT_STEPS * FIT_ITERS,
            "sweep_bwd_b": FIT_STEPS * FIT_ITERS,
            "sweep_a3_hash9": 0, "sweep_b3_hash9": 0, "sweep_a5": 0,
            "sweep_b5": 0, "sweep_a": 0, "sweep_b": 0, "sweep_a2": 0,
            "sweep_b2": 0, "fma_chains": 0}
    if fit_launches != want:
        raise AssertionError(f"fit launches {fit_launches}, want {want}")
    launches.update(sweep_bwd_a=fit_launches["sweep_bwd_a"],
                    sweep_bwd_b=fit_launches["sweep_bwd_b"])

    phase("10 timing: backward kernels, the fit's rollout, bounds")
    bwd_device_ms = {}
    for name, (launch, plain) in bwd.items():
        times[name] = (cuda_ms(launch, 200), cuda_ms(plain, 5))
        bwd_device_ms[name] = device_ms(launch, 50, name)
        print(f"{name}: kernel {times[name][0]:.4f} ms (CUDA events), "
              f"{bwd_device_ms[name]:.4f} ms device (torch.profiler); "
              f"plain {times[name][1]:.4f} ms", flush=True)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fit.rollout_disp(
            scene, sm_inv, theta0, FIT_STEPS, FIT_SNAPS), 2) / FIT_STEPS
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    grad_ms = cuda_ms(lambda: fit.value_and_grad(fit_loss, theta0),
                      2) / FIT_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"fit rollout: forward {fwd_ms:.4f} ms/step, value_and_grad "
          f"{grad_ms:.4f} ms/step ({grad_ms / fwd_ms:.3f}x forward); "
          f"max_memory_allocated {peak / 2**30:.4f} GiB "
          f"({(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} "
          f"MiB held before the grad call)", flush=True)
    bounds = {}
    for name in times:
        bounds[name] = bound(name, counts, n_rows)
        b_ms, by, flops, nbytes = bounds[name]
        print(f"{name}: {flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB, "
              f"bound {b_ms * 1e3:.4f} us ({by}), kernel at "
              f"{b_ms / times[name][0] * 100:.3f}% of it", flush=True)

    phase("11 Laplacian kernel vs plain version (biceps_full monodomain "
          "tables), forward and backward forms; CSR SpMV of the operator")
    tab = variants.monodomain_prepare_fused(scene.state, cfg, sub_q=sub_q)
    vm_r, g_r = cot(n_rows) * 10.0, cot(n_rows)
    geom = (tab.pos_s, tab.cx_s, tab.cyz_s)
    lap_in = {"forward": variants._lap_inputs(vm_r, tab.vol_s, vm_r, *geom),
              "backward": variants._lap_inputs(torch.zeros_like(g_r),
                                               torch.ones_like(g_r), g_r,
                                               *geom)}
    lap_out, worst = {}, 0.0
    for form, (qm_l, feats_l) in lap_in.items():
        got = fst.sweep_lap3(qm_l, feats_l, tab.blk_lo, tab.blk_hi, cfg,
                             sub_q)
        want = fst.sweep_lap3_plain(qm_l, feats_l, cfg)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"sweep_lap3 {form}: non-finite output")
        max_err, ratio, per_col = column_errors(got, want)
        worst = max(worst, max_err)
        print(f"sweep_lap3 {form}: max_abs_err {max_err:.6g}, worst column "
              f"at {ratio:.4g} of the bound {KERNEL_TOL:g}*max(1,max|plain|)"
              f"; column 0 {per_col[0]:.3g}, columns 1-15 "
              f"{max(per_col[1:]):.3g}", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"sweep_lap3 {form} disagrees with its "
                                 "plain version")
        lap_out[form] = got
        check_repeatable(f"sweep_lap3 {form}", lambda q=qm_l, f=feats_l:
                         fst.sweep_lap3(q, f, tab.blk_lo, tab.blk_hi, cfg,
                                        sub_q))
    report["sweep_lap3"] = {"max_abs_err": worst}
    t0 = time.perf_counter()
    lap_csr = laplacian_csr(*lap_in["forward"], cfg)
    vm_col = vm_r[:, None]
    spmv_y = lap_csr @ vm_col
    torch.cuda.synchronize()
    max_err, ratio, _ = column_errors(spmv_y, lap_out["forward"][:, :1])
    print(f"CSR Laplacian: {lap_csr._nnz()} nonzeros (built in "
          f"{time.perf_counter() - t0:.3f} s); SpMV vs kernel column 0: "
          f"max_abs_err {max_err:.6g}, {ratio:.4g} of the bound", flush=True)
    if not ratio <= 1.0:
        raise AssertionError("the CSR SpMV disagrees with the kernel")

    phase(f"12 monodomain mode: monodomain_prepare_fused + {MONO_STEPS} "
          "fused steps on biceps_full")
    fst.sweep_a3.launches = fst.sweep_lap3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mtab = variants.monodomain_prepare_fused(scene.state, cfg, sub_q=sub_q)
    mono = variants.simulate_monodomain_only_fused(scene.state, mtab, cfg,
                                                   MONO_STEPS, sub_q=sub_q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mono_launches = {"sweep_a3": fst.sweep_a3.launches,
                     "sweep_lap3": fst.sweep_lap3.launches}
    vm = mono.vm[mono.active]
    print(f"{MONO_STEPS} steps in {wall:.3f} s wall, launches "
          f"{mono_launches}; vm min {float(vm.min()):.6g} mean "
          f"{float(vm.mean()):.6g} max {float(vm.max()):.6g}", flush=True)
    want = {"sweep_a3": 1, "sweep_lap3": MONO_STEPS + 1}
    if mono_launches != want:
        raise AssertionError(f"monodomain launches {mono_launches}, want "
                             f"{want}")
    launches["sweep_lap3"] = mono_launches["sweep_lap3"]
    if not (torch.isfinite(vm).all()
            and float(vm.abs().max()) <= cfg.max_voltage):
        raise AssertionError("monodomain: vm non-finite or beyond "
                             "max_voltage")
    if not torch.equal(mono.pos, scene.state.pos):
        raise AssertionError("monodomain: the frozen cloud moved")
    vms = []
    for st_s in (small.state, small.state.to("cpu")):
        t_s = variants.monodomain_prepare_fused(st_s, small.cfg)
        vms.append(variants.simulate_monodomain_only_fused(
            st_s, t_s, small.cfg, MONO_SLICE_STEPS).vm.cpu())
    a = small.state.active.cpu()
    err = float((vms[0][a] - vms[1][a]).abs().max())
    print(f"slice, {MONO_SLICE_STEPS} steps: vm card vs CPU max abs diff "
          f"{err:.3g} (tolerance {MONO_SLICE_TOL:g})", flush=True)
    if not err <= MONO_SLICE_TOL:
        raise AssertionError("slice monodomain run: card and CPU disagree")

    phase(f"13 gradient through the Laplacian kernel: {MONO_GRAD_STEPS}-step "
          "slice rollout vs the unfused path; the fhn demo on biceps_full")
    rng = np.random.default_rng(13)
    cap_s = small.state.capacity
    wgt = torch.from_numpy(rng.normal(size=cap_s).astype(np.float32)).to(dev)
    vm0 = torch.from_numpy(rng.normal(size=cap_s).astype(np.float32)
                           * 5.0).to(dev)
    ftab = variants.monodomain_prepare_fused(small.state, small.cfg)
    utab = variants.monodomain_prepare(small.state, small.cfg,
                                       small.neighbor_capacity)
    vg = {}
    for name, run in (
            ("kernel", lambda s: variants.simulate_monodomain_only_fused(
                s, ftab, small.cfg, MONO_GRAD_STEPS)),
            ("unfused", lambda s: variants.simulate_monodomain_only(
                s, utab, small.cfg, MONO_GRAD_STEPS))):
        v = vm0.clone().requires_grad_()
        out = run(small.state.replace(vm=v))
        val = torch.where(out.active, out.vm * wgt,
                          torch.zeros_like(out.vm)).sum()
        (g,) = torch.autograd.grad(val, v)
        vg[name] = (float(val.detach()), g)
    (vk, gk), (vu, gu) = vg["kernel"], vg["unfused"]
    g_tol = 1e-4 * max(1.0, float(gu.abs().max()))
    g_err = float((gk - gu).abs().max())
    print(f"loss kernel {vk:.9g} unfused {vu:.9g} (rel diff "
          f"{abs(vk - vu) / abs(vu):.3g}, tolerance 1e-5); d loss / d vm0 "
          f"max abs diff {g_err:.3g} (tolerance {g_tol:.3g}, max|g| "
          f"{float(gu.abs().max()):.4g})", flush=True)
    if not (abs(vk - vu) <= 1e-5 * abs(vu) and g_err <= g_tol
            and float(gu.abs().max()) > 0.0):
        raise AssertionError("gradient through the Laplacian kernel "
                             "disagrees with the unfused path")
    fst.sweep_a3.launches = fst.sweep_lap3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    demo = fhn.main(["biceps_full", str(FHN_STEPS), str(FHN_ITERS),
                     "--device", str(dev)])
    torch.cuda.synchronize()
    demo_launches = {"sweep_a3": fst.sweep_a3.launches,
                     "sweep_lap3": fst.sweep_lap3.launches}
    print(f"fhn demo in {time.perf_counter() - t0:.3f} s wall: amplitude "
          f"{demo['amp']:.6g} ({demo['err'] * 100:.4f}% off), launches "
          f"{demo_launches}", flush=True)
    # the prepare's sweep A and row sum; the target rollout; per
    # value-and-grad one forward sweep per step and one backward sweep per
    # step but the first, whose input vm does not depend on the amplitude
    want = {"sweep_a3": 1,
            "sweep_lap3": 1 + FHN_STEPS + FHN_ITERS * (2 * FHN_STEPS - 1)}
    if demo_launches != want or not demo["err"] <= 0.01:
        raise AssertionError(f"fhn demo: launches {demo_launches} (want "
                             f"{want}), amplitude error {demo['err']}")

    phase(f"14 SPH-only ({MODE_STEPS} fused steps), SM-only ({MODE_STEPS} "
          f"steps), run_protocol(fused=False) ({UNFUSED_STEPS} steps) on "
          "biceps_full")
    sph_cfg = variants.sph_only_config(cfg)
    fst.sweep_a3.launches = fst.sweep_b3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sph, sph_aux = variants.simulate_sph_only(
        scene.state, sph_cfg, scene.neighbor_capacity, MODE_STEPS,
        fused=True, sub_q=sub_q)
    torch.cuda.synchronize()
    sph_launches = (fst.sweep_a3.launches, fst.sweep_b3.launches)
    t1 = time.perf_counter()
    sm, sm_aux = variants.simulate_sm_only(scene.state, cfg, MODE_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    uf, uf_aux, _ = T.run_protocol(scene, num_steps=UNFUSED_STEPS, chunk=25,
                                   fused=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    act = scene.state.active
    for what, st_m, aux_m, secs in (("SPH-only", sph, sph_aux, t1 - t0),
                                    ("SM-only", sm, sm_aux, t2 - t1),
                                    ("unfused run_protocol", uf, uf_aux,
                                     t3 - t2)):
        check_in_world(st_m, cfg, what)
        d = torch.linalg.vector_norm(st_m.pos[act] - scene.state.pos[act],
                                     dim=-1)
        print(f"{what}: {secs:.3f} s wall, overflow {int(aux_m.overflow)}, "
              f"mean displacement {float(d.mean()):.6g} (max "
              f"{float(d.max()):.6g})", flush=True)
        if int(aux_m.overflow) != 0:
            raise AssertionError(f"{what}: overflow {int(aux_m.overflow)}")
    if sph_launches != (MODE_STEPS, MODE_STEPS):
        raise AssertionError(f"SPH-only launches {sph_launches}")
    s_cfg = variants.sph_only_config(small.cfg)
    sph_s = [variants.simulate_sph_only(
        small.state, s_cfg, small.neighbor_capacity, SPH_SLICE_STEPS,
        fused=f)[0] for f in (True, False)]
    a = small.state.active
    pos_err = float((sph_s[0].pos[a] - sph_s[1].pos[a]).abs().max())
    dens_err = float(((sph_s[0].dens[a] - sph_s[1].dens[a]).abs()
                      / sph_s[1].dens[a].abs()).max())
    print(f"slice SPH-only, {SPH_SLICE_STEPS} steps, fused vs unfused: pos "
          f"{pos_err:.3g} (tolerance {SPH_POS_TOL:g}), dens rel "
          f"{dens_err:.3g} (tolerance {SPH_DENS_RTOL:g})", flush=True)
    if not (pos_err <= SPH_POS_TOL and dens_err <= SPH_DENS_RTOL):
        raise AssertionError("slice SPH-only: fused and unfused disagree")

    phase("15 timing: the Laplacian kernel, the modes, biceps_full "
          f"x{REPLICATE}, bounds")
    qm_f, feats_f = lap_in["forward"]
    times["sweep_lap3"] = (
        cuda_ms(lambda: fst.sweep_lap3(qm_f, feats_f, tab.blk_lo, tab.blk_hi,
                                       cfg, sub_q), 200),
        cuda_ms(lambda: fst.sweep_lap3_plain(qm_f, feats_f, cfg), 5))
    spmv_ms = cuda_ms(lambda: lap_csr @ vm_col, 200)
    print(f"sweep_lap3: kernel {times['sweep_lap3'][0]:.4f} ms, plain "
          f"{times['sweep_lap3'][1]:.4f} ms, CSR SpMV {spmv_ms:.4f} ms",
          flush=True)
    utab_full = variants.monodomain_prepare(scene.state, cfg,
                                            scene.neighbor_capacity)
    k_nbr = scene.neighbor_capacity
    with torch.no_grad():
        mode_ms = {
            "monodomain_fused": timed_run(
                lambda k: variants.simulate_monodomain_only_fused(
                    scene.state, mtab, cfg, k, sub_q=sub_q), 100)[0],
            "monodomain_unfused": timed_run(
                lambda k: variants.simulate_monodomain_only(
                    scene.state, utab_full, cfg, k), 20)[0],
            "sph_only_fused": timed_run(
                lambda k: variants.simulate_sph_only(
                    scene.state, sph_cfg, k_nbr, k, fused=True,
                    sub_q=sub_q), 100)[0],
            "sph_only_unfused": timed_run(
                lambda k: variants.simulate_sph_only(
                    scene.state, sph_cfg, k_nbr, k), 20)[0],
            "sm_only": timed_run(
                lambda k: variants.simulate_sm_only(scene.state, cfg, k),
                50)[0],
            "coupled_unfused": timed_run(
                lambda k: T.simulate(scene.state, cfg, k, fused=False,
                                     neighbor_capacity=k_nbr), 20)[0],
        }
    rollout = fhn.make_rollout(scene, mtab, FHN_STEPS)
    amp = torch.tensor(300.0, device=dev)
    fhn.value_and_grad(rollout, amp)
    mode_ms["monodomain_value_and_grad"] = cuda_ms(
        lambda: fhn.value_and_grad(rollout, amp), 2) / FHN_STEPS
    for name, ms in mode_ms.items():
        print(f"{name}: {ms:.4f} ms/step", flush=True)

    del lap_csr, utab_full
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    btab = variants.monodomain_prepare_fused(big.state, big.cfg,
                                             sub_q=big.sub_block)
    torch.cuda.synchronize()
    prep_big_s = time.perf_counter() - t0
    with torch.no_grad():
        big_ms, big_out = timed_run(
            lambda k: variants.simulate_monodomain_only_fused(
                big.state, btab, big.cfg, k, sub_q=big.sub_block),
            REPLICATE_STEPS)
    big_peak = torch.cuda.max_memory_allocated(dev)
    check_in_world(big_out, big.cfg, f"x{REPLICATE}")
    bvm = big_out.vm[big_out.active]
    if not (torch.isfinite(bvm).all()
            and float(bvm.abs().max()) <= big.cfg.max_voltage):
        raise AssertionError(f"x{REPLICATE}: vm non-finite or beyond "
                             "max_voltage")
    qm_b, feats_b = variants._lap_inputs(big.state.vm[btab.order],
                                         btab.vol_s,
                                         big.state.vm[btab.order],
                                         btab.pos_s, btab.cx_s, btab.cyz_s)
    big_lap_ms = cuda_ms(lambda: fst.sweep_lap3(qm_b, feats_b, btab.blk_lo,
                                                btab.blk_hi, big.cfg,
                                                big.sub_block), 20)
    print(f"biceps_full x{REPLICATE}: {big.num_particles} particles "
          f"(capacity {big.state.capacity}), scene built in "
          f"{build_big_s:.3f} s, prepare {prep_big_s:.3f} s, "
          f"{REPLICATE_STEPS} monodomain-only steps at {big_ms:.4f} ms/step "
          f"({big.num_particles / big_ms * 1e3:.1f} particle-steps/s), "
          f"Laplacian kernel {big_lap_ms:.4f} ms; max_memory_allocated "
          f"{big_peak / 2**30:.4f} GiB ({(big_peak - base) / 2**20:.1f} MiB "
          f"above the {base / 2**20:.1f} MiB held before the prepare); vm "
          f"max {float(bvm.max()):.6g}", flush=True)
    big_sweep_ms = check_big_kernels(big, btab, dev)
    big_sweep_ms.update(check_big_sweeps(
        {**hash9_sweeps(*hash9_inputs(big.state, big.cfg, big.sub_block),
                        big.cfg, big.sub_block),
         **v1_sweeps(big.state, big.cfg, big.sub_block)},
        sampled_rows(big.state.capacity, dev)))
    big_counts = roofline.pair_counts(qm_b, btab.blk_lo, btab.blk_hi,
                                      big.cfg, big.sub_block)
    big_bound = bound("sweep_lap3", big_counts, big.state.capacity)
    print(f"pairs the Laplacian kernel needs (x{REPLICATE}): {big_counts}; "
          f"{big_bound[2] / 1e6:.3f} MFLOP, {big_bound[3] / 1e6:.3f} MB, "
          f"bound {big_bound[0] * 1e3:.4f} us ({big_bound[1]}), kernel at "
          f"{big_bound[0] / big_lap_ms * 100:.3f}% of it", flush=True)

    lap_counts = roofline.pair_counts(qm_f, tab.blk_lo, tab.blk_hi, cfg,
                                      sub_q)
    bounds["sweep_lap3"] = bound("sweep_lap3", lap_counts, n_rows)
    b_ms, by, flops, nbytes = bounds["sweep_lap3"]
    print(f"pairs the Laplacian kernel needs (biceps_full): {lap_counts}; "
          f"sweep_lap3: {flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB, "
          f"bound {b_ms * 1e3:.4f} us ({by}), kernel at "
          f"{b_ms / times['sweep_lap3'][0] * 100:.3f}% of it", flush=True)

    phase("16 v3 / v5 kernels vs plain versions (biceps_full step-0 inputs)")
    t0 = time.perf_counter()
    scene3 = T.build_scene("biceps_full", fused_impl="v3", device=dev)
    scene5 = T.build_scene("biceps_full", fused_impl="v5", device=dev)
    torch.cuda.synchronize()
    sq3, sq5, kb5 = scene3.sub_block, scene5.sub_block, scene5.pack_cap
    kw5 = dict(sub_q=sq5, w_chunk=scene5.block_window)
    print(f"v3 scene: sub_block {sq3}; v5 scene: sub_block {sq5}, pack_cap "
          f"{kb5}, w_chunk {scene5.block_window}; both built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for label, fn, sc, args in (
            ("bookkeeping2", sweep_bookkeeping2, scene3, (sq3,)),
            ("bookkeeping5", sweep_bookkeeping5, scene5,
             (sq5, kb5, scene5.block_window))):
        on_card = fn(sc.state.pos, sc.state.active, cfg, *args)
        on_cpu = fn(sc.state.pos.cpu(), sc.state.active.cpu(), cfg, *args)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
            raise AssertionError(f"{label} differs card vs CPU")
    print("bookkeeping2 / bookkeeping5: card == CPU exactly (order, inv, "
          "windows / slots, trips, overflow, cells)", flush=True)
    fs3, fa3, lo3, hi3 = step0_inputs_v3(scene3)
    plain_a3h = fst.sweep_a3_plain(fs3, fa3, cfg, stencil="hash9")
    check_kernel(report, "sweep_a3_hash9",
                 fst.sweep_a3_hash9(fs3, fa3, lo3, hi3, cfg, sub_q=sq3),
                 plain_a3h)
    fb3 = fst.feats_b(plain_a3h)  # B compared on the same OUT_A
    check_kernel(report, "sweep_b3_hash9",
                 fst.sweep_b3_hash9(plain_a3h, fb3, lo3, hi3, cfg, sub_q=sq3),
                 fst.sweep_b3_plain(plain_a3h, fb3, cfg, stencil="hash9"))
    check_repeatable("sweep_a3_hash9", lambda: fst.sweep_a3_hash9(
        fs3, fa3, lo3, hi3, cfg, sub_q=sq3))
    check_repeatable("sweep_b3_hash9", lambda: fst.sweep_b3_hash9(
        plain_a3h, fb3, lo3, hi3, cfg, sub_q=sq3))
    fs5, src5, trips5, over5 = step0_inputs_v5(scene5)
    if int(over5) != 0:
        raise AssertionError(f"v5 step 0 overflows pack_cap {kb5}")
    pa5 = fst.pack_feats_a5(fs5, src5, kb5)
    plain_a5 = fst.sweep_a5_plain(fs5, pa5, cfg)
    kern_a5 = fst.sweep_a5(fs5, pa5, trips5, cfg, **kw5)
    check_kernel(report, "sweep_a5", kern_a5, plain_a5)
    pb5 = fst.pack_feats_b5(plain_a5, fst.vol_now(plain_a5), src5, kb5)
    check_kernel(report, "sweep_b5",
                 fst.sweep_b5(plain_a5, pb5, trips5, cfg, **kw5),
                 fst.sweep_b5_plain(plain_a5, pb5, cfg))
    check_repeatable("sweep_a5", lambda: fst.sweep_a5(fs5, pa5, trips5, cfg,
                                                      **kw5))
    check_repeatable("sweep_b5", lambda: fst.sweep_b5(plain_a5, pb5, trips5,
                                                      cfg, **kw5))
    whole = fst.sweep_a5(fs5, pa5, trips5, cfg, static_trips=True, **kw5)
    torch.cuda.synchronize()
    print(f"sweep_a5 over the whole slab (v5s) vs over the trips: max abs "
          f"diff {float((whole - kern_a5).abs().max()):.3g}", flush=True)
    if not torch.equal(whole, kern_a5):
        raise AssertionError("v5s and v5 sweep A differ: a padding slot "
                             "was not inert")

    phase(f"17 v3 / v5 main paths: run_protocol({STEPS} steps, chunk "
          f"{CHUNK}) on biceps_full; a forced v5 regrow on the slice")
    ends, runs = {}, {}
    for label, sc, names in (("v3", scene3, ("sweep_a3_hash9",
                                             "sweep_b3_hash9")),
                             ("v5", scene5, ("sweep_a5", "sweep_b5"))):
        st_r, aux_r, traj_r, got, calls, wall = counted_protocol(
            sc, names, num_steps=STEPS, chunk=CHUNK, record_every=50)
        run_steps = sum(n for _, n in calls)
        runs[label] = {"steps_run": run_steps, "simulate_calls": calls,
                       "wall_s": wall}
        print(f"{label}: {STEPS} steps in {wall:.3f} s wall, {run_steps} "
              f"run (simulate calls (pack_cap, steps) {calls}), launches "
              f"{got}", flush=True)
        if run_steps < STEPS or any(n != run_steps for n in got.values()):
            raise AssertionError(f"{label} launches {got}, want "
                                 f"{run_steps}")
        launches.update(got)
        check_protocol_run(st_r, aux_r, cfg, f"{label} run_protocol")
        orig = sc.state.orig_pos[act]
        for step in (250, 500):
            d = torch.linalg.vector_norm(
                traj_r["pos"][step // 50 - 1][act] - orig, dim=-1)
            print(f"{label} mean displacement at step {step}: "
                  f"{float(d.mean()):.6g} (max {float(d.max()):.6g})",
                  flush=True)
        ends[label] = st_r
    for label in ("v3", "v5"):
        diff = (ends[label].pos[act] - state.pos[act]).abs().max()
        print(f"after {STEPS} steps, {label} vs v4 positions: max abs diff "
              f"{float(diff):.6g}", flush=True)
    small5 =slice_scene(dev, "v5")._replace(sub_block=REGROW_SUB_Q,
                                             pack_cap=REGROW_CAP)
    st_g, aux_g, _, got, calls, _ = counted_protocol(
        small5, ("sweep_a5", "sweep_b5"), num_steps=6, chunk=4,
        stim_off_step=3)
    run_steps = sum(n for _, n in calls)
    regrow = {"pack_cap_before": calls[0][0], "pack_cap_after": calls[-1][0],
              "simulate_calls": calls, "steps_run": run_steps,
              "launches": got}
    print(f"forced v5 regrow on the slice (sub_block {REGROW_SUB_Q}): "
          f"pack_cap {regrow['pack_cap_before']} -> "
          f"{regrow['pack_cap_after']}; simulate calls (pack_cap, steps) "
          f"{calls}; launches {got} for {run_steps} steps run, 6 kept; "
          f"overflow {int(aux_g.overflow)}", flush=True)
    check_in_world(st_g, small5.cfg, "v5 regrow")
    if not (regrow["pack_cap_after"] > regrow["pack_cap_before"]
            and len(calls) > 2 and run_steps > 6
            and all(n == run_steps for n in got.values())
            and int(aux_g.overflow) == 0):
        raise AssertionError(f"v5 regrow: {regrow}")

    phase("18 v3 / v5 small input: kernels on the card vs plain versions "
          "on the CPU")
    for label in ("v3", "v5"):
        slice_card_vs_cpu(slice_scene(dev, label), label)

    phase("19 timing: the v3 / v5 kernels, v3 / v4 / v5 ms/step, slab "
          "packing, bounds")
    times["sweep_a3_hash9"] = (
        cuda_ms(lambda: fst.sweep_a3_hash9(fs3, fa3, lo3, hi3, cfg,
                                           sub_q=sq3), 200),
        cuda_ms(lambda: fst.sweep_a3_plain(fs3, fa3, cfg, stencil="hash9"),
                5))
    times["sweep_b3_hash9"] = (
        cuda_ms(lambda: fst.sweep_b3_hash9(plain_a3h, fb3, lo3, hi3, cfg,
                                           sub_q=sq3), 200),
        cuda_ms(lambda: fst.sweep_b3_plain(plain_a3h, fb3, cfg,
                                           stencil="hash9"), 5))
    times["sweep_a5"] = (
        cuda_ms(lambda: fst.sweep_a5(fs5, pa5, trips5, cfg, **kw5), 200),
        cuda_ms(lambda: fst.sweep_a5_plain(fs5, pa5, cfg), 5))
    times["sweep_b5"] = (
        cuda_ms(lambda: fst.sweep_b5(plain_a5, pb5, trips5, cfg, **kw5), 200),
        cuda_ms(lambda: fst.sweep_b5_plain(plain_a5, pb5, cfg), 5))
    for name in ("sweep_a3_hash9", "sweep_b3_hash9", "sweep_a5", "sweep_b5"):
        print(f"{name}: kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms", flush=True)
    hash9_device_ms = {
        "sweep_a3_hash9": device_ms(lambda: fst.sweep_a3_hash9(
            fs3, fa3, lo3, hi3, cfg, sub_q=sq3), 50, "sweep_a3_hash9"),
        "sweep_b3_hash9": device_ms(lambda: fst.sweep_b3_hash9(
            plain_a3h, fb3, lo3, hi3, cfg, sub_q=sq3), 50, "sweep_b3_hash9")}
    print(f"device time (torch.profiler): {hash9_device_ms}", flush=True)
    pack_ms = {
        "a": cuda_ms(lambda: fst.pack_feats_a5(fs5, src5, kb5), 50),
        "b": cuda_ms(lambda: fst.pack_feats_b5(
            plain_a5, fst.vol_now(plain_a5), src5, kb5), 50)}
    print(f"slab packing ({kb5} slots x {fs5.shape[0] // sq5} blocks, "
          f"{pa5.numel() * 4 / 1e6:.1f} MB a slab): sweep A "
          f"{pack_ms['a']:.4f} ms, sweep B {pack_ms['b']:.4f} ms", flush=True)
    impl_ms = {"v3": [], "v4": [], "v5": []}
    with torch.no_grad():
        for label in ("v4", "v3", "v5", "v5", "v3", "v4"):
            sc = {"v3": scene3, "v4": scene, "v5": scene5}[label]
            impl_ms[label].append(timed_run(
                lambda k, sc=sc: T.simulate(
                    sc.state, sc.cfg, k, sub_q=sc.sub_block,
                    impl=sc.fused_impl, pack_cap=sc.pack_cap,
                    w_chunk=sc.block_window), IMPL_TIMING_STEPS)[0])
    print(f"ms/step over {IMPL_TIMING_STEPS} steps, in the order v4 v3 v5 "
          f"v5 v3 v4: {impl_ms}", flush=True)
    slots5 = int((src5 < fs5.shape[0]).sum())
    new_bytes = {
        # queries, features, 16 window bounds a sub-block, constants, out
        "sweep_a3_hash9": 4 * (3 * 16 * n_rows + 2 * 16 * (n_rows // sq3)
                               + 32),
        # the function's bytes: queries, their (16, N) features, trips,
        # constants, out; the slabs are an intermediate the step builds
        # from the features (their packing is timed above)
        "sweep_a5": 4 * (3 * 16 * n_rows + n_rows // sq5 + 32)}
    new_bytes["sweep_b3_hash9"] = new_bytes["sweep_a3_hash9"]
    new_bytes["sweep_b5"] = new_bytes["sweep_a5"]
    for name, nb in new_bytes.items():
        bounds[name] = bound(name, counts, n_rows, nb)
        b_ms, by, flops, nbytes = bounds[name]
        print(f"{name}: {flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB, "
              f"bound {b_ms * 1e3:.4f} us ({by}), kernel at "
              f"{b_ms / times[name][0] * 100:.3f}% of it", flush=True)
    print(f"v5 slab slots the unions fill: {slots5} of "
          f"{pa5.shape[0] * kb5}", flush=True)
    # candidates each generation's kernels walk per query row at step 0
    walked = {impl: roofline.walked_per_row(sc) for impl, sc in (
        ("v4", scene), ("v3", scene3), ("v5", scene5))}
    print(f"candidates walked per query row (step 0): {walked}", flush=True)

    phase("20 v1 / v2 kernels vs plain versions (biceps_full step-0 "
          "inputs)")
    raw = phase_raw_kernels(dev, report)
    phase(f"21 v1 / v2 main paths: run_protocol({STEPS} steps, chunk "
          f"{CHUNK}) on biceps_full")
    raw_runs = phase_raw_protocol(raw, state, launches)
    phase("22 v1 / v2 small input: kernels on the card vs plain versions "
          "on the CPU")
    for label in RAW_SWEEPS:
        slice_card_vs_cpu(slice_scene(dev, label), label)
    phase("23 timing: K8, K9, the roofline tool and K10, v1 / v2 / v4 "
          "ms/step, bounds")
    raw_timing = phase_raw_timing(dev, raw, scene, counts, times, bounds,
                                  launches, report)

    library = {"sweep_lap3": spmv_ms}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name)}
        for name, source, replaces, _ in KERNELS],
        "step_ms": kernel_ms, "plain_step_ms": plain_ms,
        "fit_fwd_ms_per_step": fwd_ms, "fit_grad_ms_per_step": grad_ms,
        "bwd_device_ms": bwd_device_ms, "hash9_device_ms": hash9_device_ms,
        "fit_peak_gib": peak / 2**30,
        "mode_ms_per_step": mode_ms,
        "impl_ms_per_step": impl_ms, "slab_pack_ms": pack_ms,
        "walked_per_row": walked,
        "v3_v5_runs": runs, "v5_regrow": regrow, "v1_v2_runs": raw_runs,
        **raw_timing,
        "replicate": {"particles": big.num_particles,
                      "prepare_s": prep_big_s, "ms_per_step": big_ms,
                      "lap_kernel_ms": big_lap_ms,
                      "lap_bound_ms": big_bound[0],
                      "sweep_a3_ms": big_sweep_ms["sweep_a3"],
                      "sweep_b3_ms": big_sweep_ms["sweep_b3"],
                      **{f"{k}_ms": big_sweep_ms[k] for k in (
                          "sweep_a3_hash9", "sweep_b3_hash9", "sweep_a2",
                          "sweep_b2", "sweep_a", "sweep_b")},
                      "sweep_bwd_a_ms": big_bwd_ms["sweep_bwd_a"],
                      "sweep_bwd_b_ms": big_bwd_ms["sweep_bwd_b"],
                      "peak_gib": big_peak / 2**30}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
