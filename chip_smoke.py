"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's paths on the card at the full width of
`build_scene("biceps_full")` (18,475 particles): the chunked `run_protocol`
of the v4 fused step, through the two hand-written CUDA sweep kernels, and
of its v3, v5, v2 and v1 generations through theirs; the
flagship (K, mu) material fit through the differentiable step, whose
backward pass runs the two hand-written backward sweep kernels; the
frozen-cloud monodomain mode on the hand-written Laplacian kernel, forward
and backward; the SPH-only, SM-only and unfused modes; the roofline
tool, whose FMA-chain probe measures the card's fp32 peak; the coupled and
SM-only steps on the multi-muscle scenes biceps_full x7 and x56 (one
shape-matching cluster a muscle); the contraction and fit demos; and the
multi-device runs, two ranks sharing the card.
Phases, each printing its lines; any failure raises and exits non-zero:

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
 24. multi    the coupled v4 step on build_scene("biceps_full",
              replicate=7) (129,325 particles, the blocked shape-matching
              form) and replicate=56 (1,034,600, the contig form): cluster
              ids on the card equal row // tile rows, the form taken,
              run_protocol (3 and 100 steps) with exact K1 / K2 launch
              counts, the goals' distance from float64 with every tile
              deformed alike (tools/sm_precision.py, against the fp32 sums
              about the world origin of the JAX package), K1 / K2 on the
              inputs the run ends on against their plain versions (sampled
              rows, two launches bitwise equal) and their times (CUDA
              events); the independent-run oracle: after 3 steps tile 0 of
              x7 and x56 within 2e-4 of an x1 run, and every tile (minus
              its x offset) within 2e-4 of tile 0, beside the x1 run's own
              spread (its largest move when every live position starts
              one float32 ulp up, or down)
 25. small    susane x2: 6 coupled and 6 SM-only steps, card against CPU
 26. sm-only  SM-only on x56, 100 steps, finite fields
 27. timing   ms/step of coupled x7, coupled x56 and SM-only x56 (best of
              3 calls ending in a host fetch), peak memory, and the CUDA
              launches per step of the coupled step: equal on x7 and x56
              in one form, no more on x56 than on x7; project_positions
              per call on x7 and x56 in each of the blocked, contig and
              one-hot forms (wall and device ms)
 28. demos    contraction_demo (biceps_18475, 40 steps, 20 frames),
              fit_stimulus_demo 4 3 (< 1% off) and fit_material_demo 6 100
              (< 20% off)
 29. cli      the command line on biceps_full: cli.main, coupled, 500
              steps, chunk 100, with --report, --profile-phases, --traj
              (the native writer) and --save-checkpoint: rc 0, overflow 0,
              a 23-column report row whose phase columns reconcile with
              its step column, 5 trajectory frames read back finite and
              inside the world, K1 / K2 launched 500 times by the run
              besides the profiler's own launches; a run stopped at step
              300 by its control file and resumed from its checkpoint,
              held to the uninterrupted run; --mode monodomain (K3's
              launches), sph and sm, 50 steps each; the tools
              profile_phases, hbm_footprint (biceps_full and x7),
              ablate_fused (full book), bench_rows (one scene) and sweep
              --quick

 30. multi    K1 / K2 on each half of biceps_full's sorted rows (padded to
              whole sub-blocks at 2 ranks; q_slice, the slab launches)
              against their plain versions, two launches bitwise equal,
              their times and bounds; 2 ranks sharing the card (gloo
              through host copies; which gloo collectives take CUDA
              tensors is probed and printed): the fused slab path (3
              steps against one device at tests/test_sharded_fused.py's
              tolerances, then 200 protocol steps, stim off at 100,
              finite and inside the world, K1 / K2 slab launches
              exactly 200 per rank), the gather path (3 steps), the halo
              path on biceps_full x7 (3 steps against one device by
              orig_pos at
              tests/test_halo.py's tolerances, then 50 steps: every
              particle kept, migration counted, overflow 0), K1 / K2 on
              each rank's recorded halo inputs (S queries against S + 2H
              candidates) against their plain versions; NCCL at world
              size 1; the command line with --devices 2 --parallel
              gather / fused / halo (20 steps), the halo checkpoint
              resumed on one device; ms/step of each path (two ranks on
              one card, eager: gloo through host copies cannot be
              captured) and of one device. NCCL at world size 1, graphed
              (models/scan.run_steps): a probe that captures of NCCL
              collectives outlast the watchdog's tick in the default
              capture mode; the fused slab against one device
              bit for bit (3 steps) and its 200-step protocol in chunks
              of 100, the gather path (3 steps) and the halo path on x7
              (50 steps, every particle kept, overflow 0), each against
              its run under scan.eager() bit for bit with the same K1 /
              K2 slab launches; graphed and eager ms/step, host launch
              calls and device operations a step, and slab launches a
              step, of the fused slab (biceps_full) and the halo path
              (x7). The gather path's value-and-grad (overrides K
              and mu and the initial vel requiring grad, loss sum(pos *
              w)): at NCCL world size 1 on the padded biceps_full (3
              steps, stim off before step 1), the graphed adjoint scan
              (two captures, forward and backward step, then replays)
              against scan.eager() bit for bit and against one device's
              unfused adjoint (bit for bit, or within the CPU tests'
              tolerances widened by one device's own spread; which is
              printed), ms/step graphed and eager, peak memory; 2 ranks
              sharing the card (2 steps, the eager adjoint through host
              copies) against one device the same way. The halo pricing
              tool (tools/halo_gpu.py --check on x7 at world size 1) and
              its row
 31. graph    the compiled run loop (models/scan.py: simulate, the mode
              drivers and run_protocol replay a captured CUDA graph):
              biceps_full v4 run_protocol(500 steps, stim off at 250,
              graphed) against an eager Python loop of step_fused
              over the same protocol, bit for bit (or within twice the
              spread of two eager runs, with the stage that does not
              repeat named), K1 / K2 launched exactly 500 times, one
              capture, scene.state untouched; 20 steps each of v3, v5
              (pack_cap forced low: a regrow and a recapture), v1, v2 and
              the unfused step, then SM-only, SPH-only and the fused
              monodomain mode (K3), each against its eager run the same
              way with exact launch counts; biceps_full x56 coupled, 100
              steps: counts, finite fields, peak memory, and the graph
              pool's peak (tools/hbm_footprint --scan, donated); ms/step
              graphed and eager (best of 3 calls ending in a host fetch)
              on biceps_full, x7, x56, SM-only x56 and monodomain fused;
              host launch calls a step, kernels a replay runs and the
              device's idle share, from a profiled window; the command
              line's rendered frames after a graphed run differ from
              chunk to chunk

 32. grad     the compiled gradient paths (models/scan.py's checkpointed
              adjoint scan: forward and backward steps replay captured
              graphs) on biceps_full: the flagship --fused value-and-grad
              (100 steps, 5 snapshots, from the JAX example's (0.3,
              150)), graphed against the eager adjoint (scan.eager())
              bit for bit or within twice the spread of two eager runs, and
              both within GRAD_RTOL of the torch.utils.checkpoint loop,
              exact K1 / K2 / K4 / K5 counts, ms/step graphed (best of 3)
              and eager, peak memory, capture time; the flagship's unfused
              path (4 steps, 2 snapshots) the same way; a graphed 250-step
              fit (FIT_ITERS Adam iterations, the loss must fall); the
              stimulus, material and fhn demos; simulate(..., params)
              under grad, unfused, 3 steps, graphed against eager; one
              gather's backward through the unfused table with its own
              indices and with ops/sph.gather_index's
 33. trajectory  the main path against the JAX package's trajectory of
              full biceps_full committed in tests/data/
              biceps_full_jax_trajectory.npz (tools/trajectory_parity.py):
              the graphed run_protocol (K1 / K2, stim off before step 20)
              from the scene as built and from a seeded vm field, runs of
              1, 3 and 40 steps, exact K1 / K2 counts; each field's largest
              difference over its tolerance (max(the JAX suite's one-step
              tolerance, 2 x the larger of JAX's committed spreads under a
              one-ulp move and under a row shuffle), dens relative;
              inter_vm after step 1 row by row), printed with the ratio
              against the one-ulp spread alone; none above 1

Earlier phases run the same drivers, now graphed: their exact launch
counts come from replays (models/scan.py corrects the counters), and
their timings warm the capture up first. Phases 8-10, 13 and 28 run their
gradients through the adjoint scan's graphs.

The line before the last is a JSON object with one entry per kernel (K1 /
K2's slab launches as rows of their own); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch import cli, runtime
from sph_sm_monodomain_tpu_torch.ablation import legacy_steps
from sph_sm_monodomain_tpu_torch.ablation import legacy_sweeps as tls
from sph_sm_monodomain_tpu_torch.examples import contraction_demo
from sph_sm_monodomain_tpu_torch.examples import fit_fhn_fused_demo as fhn
from sph_sm_monodomain_tpu_torch.examples import fit_material_demo
from sph_sm_monodomain_tpu_torch.examples import fit_material_flagship as fit
from sph_sm_monodomain_tpu_torch.examples import fit_stimulus_demo
from sph_sm_monodomain_tpu_torch.models import monodomain
from sph_sm_monodomain_tpu_torch.models import scan
from sph_sm_monodomain_tpu_torch.models import variants
from sph_sm_monodomain_tpu_torch.ops import cuda_lib
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as fad
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops import shape_matching as tsm
from sph_sm_monodomain_tpu_torch.ops.grid import (auto_cell_capacity,
                                                  auto_window_capacity)
from sph_sm_monodomain_tpu_torch.ops.shape_matching import (
    corrected_velocity, sm_invariants)
from sph_sm_monodomain_tpu_torch.ops.sweeps import (auto_sweep5_params,
                                                    sweep_bookkeeping2,
                                                    sweep_bookkeeping3,
                                                    sweep_bookkeeping5)
from sph_sm_monodomain_tpu_torch.tools import (ablate_fused, bench_rows,
                                               hbm_footprint, profile_phases,
                                               roofline, sm_precision, sweep,
                                               tile_drift,
                                               trajectory_parity)
from sph_sm_monodomain_tpu_torch.utils import render as render_mod
from sph_sm_monodomain_tpu_torch.utils import report as report_mod
from sph_sm_monodomain_tpu_torch.tools.roofline import (PEAK_BYTES,
                                                        PEAK_FLOPS)
from sph_sm_monodomain_tpu_torch.state import FIELD_NAMES
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
# phase 32: the flagship fit at the JAX example's defaults (steps,
# snapshots), the steps of the value-and-grad held to its eager adjoint
# and to the checkpoint loop (fewer than the fit's, to make room for
# phase 30's multi-device gradient: each eager reference runs ~90 ms a
# step), its unfused path's steps and snapshots (the unfused step streams
# (N, neighbor_capacity) tensors, 18,560 x 4,464 here), and the steps of
# simulate under grad
FLAG_STEPS, FLAG_SNAPS, FLAG_VG_STEPS = 250, 5, 100
FLAG_UNFUSED_STEPS, FLAG_UNFUSED_SNAPS = 4, 2
SIM_GRAD_STEPS = 3
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
# the multi-muscle scale-up (sm_clusters > 1): replicate count, the
# clustered shape-matching form it takes, run_protocol steps
MULTI = ((7, "blocked", 3), (REPLICATE, "contig", 100))
# the independent-run oracle (tests/test_sm_clusters.py:1-8): steps and
# the position bound (tests/test_sm_clusters.py:66-70) of tile 0 against
# the x1 run and of every tile against tile 0
ORACLE_STEPS, ORACLE_TOL = 3, 2e-4
# the clustered goals' largest distance from a float64 evaluation, every
# tile deformed alike (tools/sm_precision.py; 6.2e-6 on the CPU at x56)
SM_PRECISION_TOL = 1e-4
# card vs CPU on a small replicate; SM-only steps on x56; steps of the
# timed calls; the contraction demo's steps
SMALL_REPLICATE, SMALL_STEPS, SM_BIG_STEPS = 2, 6, 100
MULTI_TIMING_STEPS, CONTRACTION_STEPS = 20, 40
# project_positions calls a timing of one clustered form averages over
FORM_CALLS = 20
# the command line (phase 29): steps and chunk of the coupled run, the
# step its resumed twin stops at, the steps of each other mode and of the
# sweep tool's runs; the resumed run is held to the uninterrupted one at
# the multi-step parity tests' one-step tolerances (tests/torch_parity.py
# STEP_TOLS, dens relative 1e-5)
CLI_STEPS, CLI_CHUNK, CLI_STOP_AT = 500, 100, 300
CLI_MODE_STEPS, CLI_SWEEP_STEPS = 50, 20
RESUME_TOLS = {"pos": 5e-5, "vel": 5e-3, "vm": 5e-3, "iion": 1e-5, "w": 1e-6}
RESUME_DENS_RTOL = 1e-5
# torch.profiler's names of the host calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


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
    two-step warm-up run (the first call of a driver runs one step eagerly,
    the second captures its graph)."""
    run(2)
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


def check_big_sweeps(sweeps, rows, label=f"x{REPLICATE}") -> dict:
    """Each of {name: (launch, plain, qm)} on the replicated scene `label`:
    launch() held to plain(query rows of qm) on `rows`, two launches
    bitwise equal, and timed. Returns {name: ms}."""
    scratch, times = {}, {}
    for name, (launch, plain, qm) in sweeps.items():
        check_kernel(scratch, f"{name} ({label}, {rows.numel()} "
                     "sampled rows)", launch()[rows],
                     plain_on_rows(plain, qm, rows))
        check_repeatable(f"{name} ({label})", launch)
        times[name] = cuda_ms(launch, 20)
        print(f"{name} on {label}: kernel {times[name]:.4f} ms",
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
    simulate call recorded as (pack_cap, steps): a
    regrown chunk shows as a call redone with a larger pack_cap. Returns (state, aux, traj,
    launches, calls, wall seconds)."""
    calls = []

    def recording(real):
        def rec(*args, **skw):
            calls.append((skw["pack_cap"], skw["num_steps"]))
            return real(*args, **skw)
        return rec

    for nm in names:
        getattr(KERNEL_MODULE[nm], nm).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(monodomain, "simulate",
                           recording(monodomain.simulate)):
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


# --- phases 24-28: the multi-muscle scale-up (sm_clusters > 1) and the demos

def check_fields_finite(state, cfg, what: str) -> None:
    """Every float field finite on the live rows, positions in the world."""
    check_in_world(state, cfg, what)
    act = state.active
    for name, x in T.state_to_numpy(state).items():
        if x.dtype.kind == "f" and not np.isfinite(x[act.cpu().numpy()]).all():
            raise AssertionError(f"{what}: non-finite {name}")


def check_cluster_ids(sc, label: str) -> None:
    """On the card, cluster_ids puts live row i in tile i // sm_tile_rows
    (tile k's first rows sit exactly on x = k * tile_w); a Python-scalar
    divisor, which CUDA turns into a multiply by its reciprocal, is
    printed beside it for the rows it would misplace."""
    st, cfg = sc.state, sc.cfg
    k, r = cfg.sm_clusters, cfg.sm_tile_rows
    live = st.active
    want = torch.arange(st.capacity, device=live.device) // r
    cid = tsm.cluster_ids(st.orig_pos, cfg)
    recip = torch.clamp(torch.floor(st.orig_pos[:, 0]
                                    / (cfg.world_size[0] / k)), 0, k - 1)
    bad = int((cid[live] != want[live]).sum())
    moved = int((recip.long()[live] != want[live]).sum())
    print(f"{label}: cluster_ids == row // {r} on the {int(live.sum())} live "
          f"rows: {bad == 0} ({bad} differ); a Python-scalar divisor would "
          f"misplace {moved}", flush=True)
    if bad:
        raise AssertionError(f"{label}: cluster_ids misplace {bad} rows")


def tile_offsets(k: int, dev) -> torch.Tensor:
    """(k, 1, 3) x offsets of the tiles, as scene_positions adds them."""
    x = torch.arange(k, device=dev, dtype=torch.float32) \
        * torch.tensor(np.float32(1.5), device=dev)
    return torch.stack([x, torch.zeros_like(x), torch.zeros_like(x)],
                       dim=1)[:, None, :]


def phase_multi_muscle(dev, scene, scenes) -> dict:
    """Phase 24: the coupled v4 step on the replicated scenes {k: scene}
    of MULTI (biceps_full x7, blocked form, and x56, contig form): cluster
    ids, the form, run_protocol with exact K1 / K2 launch counts, K1 / K2
    on the inputs the run ends on against their plain versions (sampled
    rows) with their times, and the independent-run oracle against the x1
    run `scene`."""
    out = {}
    for k, form, steps in MULTI:
        sc, label = scenes[k], f"x{k}"
        check_cluster_ids(sc, label)
        inv = sm_invariants(sc.state, sc.cfg)
        got = tsm._segment_form(inv, sc.cfg, sc.state.capacity)
        print(f"{label}: clustered shape matching takes the {got} form "
              f"(want {form})", flush=True)
        if got != form:
            raise AssertionError(f"{label}: form {got}, want {form}")
        st, aux, _, launches, calls, wall = counted_protocol(
            sc, ("sweep_a3", "sweep_b3"), num_steps=steps, chunk=CHUNK)
        run = sum(n for _, n in calls)
        print(f"{label}: run_protocol({steps} steps) in {wall:.3f} s wall, "
              f"{run} run (simulate calls {calls}), launches {launches}",
              flush=True)
        if launches != {"sweep_a3": run, "sweep_b3": run} or run != steps:
            raise AssertionError(f"{label}: launches {launches} for {run} "
                                 f"steps run, want {steps}")
        check_fields_finite(st, sc.cfg, f"{label} run_protocol")
        prec = sm_precision.goal_errors(sc)
        print(f"{label}: goals of every tile deformed alike, largest "
              f"distance from float64: the port's {max(prec['port']):.4g} "
              f"(bound {SM_PRECISION_TOL:g}), fp32 sums about the world "
              f"origin {max(prec['origin']):.4g}; per tile "
              f"{[float(f'{v:.3g}') for v in prec['port']]} against "
              f"{[float(f'{v:.3g}') for v in prec['origin']]}", flush=True)
        if not max(prec["port"]) <= SM_PRECISION_TOL:
            raise AssertionError(f"{label}: clustered goals off float64")
        if int(aux.overflow) != 0:
            raise AssertionError(f"{label}: overflow {int(aux.overflow)}")
        fs, fa, lo, hi = step0_inputs(sc._replace(state=st), dev)
        sq = sc.sub_block
        out_a = fst.sweep_a3(fs, fa, lo, hi, sc.cfg, sub_q=sq)
        fb = fst.feats_b(out_a)
        sweeps = {"sweep_a3": (lambda: fst.sweep_a3(fs, fa, lo, hi, sc.cfg,
                                                    sub_q=sq),
                               lambda q: fst.sweep_a3_plain(q, fa, sc.cfg),
                               fs),
                  "sweep_b3": (lambda: fst.sweep_b3(out_a, fb, lo, hi,
                                                    sc.cfg, sub_q=sq),
                               lambda q: fst.sweep_b3_plain(q, fb, sc.cfg),
                               out_a)}
        # CUDA events over 20 launches: torch.profiler drops events of
        # these kernels (it read K2 on x7 at 0 ms)
        ev = check_big_sweeps(sweeps, sampled_rows(sc.state.capacity, dev),
                              label=f"{label} coupled, step {steps}")
        out[label] = {"particles": sc.num_particles, "form": got,
                      "steps": steps, "wall_s": wall, "launches": launches,
                      "events_ms": ev,
                      "goal_err_port": max(prec["port"]),
                      "goal_err_origin_sums": max(prec["origin"])}

    ref = T.simulate(scene.state, scene.cfg, num_steps=ORACLE_STEPS)[0]
    r = scene.num_particles
    ref_pos = ref.pos[:r]
    # the x1 run's own spread: its largest move when every live position
    # starts one float32 ulp up, or down
    spread = max(float((T.simulate(tile_drift.bump_pos(scene.state, t),
                                   scene.cfg, num_steps=ORACLE_STEPS)[0]
                        .pos[:r] - ref_pos).abs().max())
                 for t in (np.inf, -np.inf))
    print(f"x1: after {ORACLE_STEPS} steps its own +-1-ulp spread is "
          f"{spread:.4g}", flush=True)
    oracle = {"x1_spread": spread}
    for k, sc in scenes.items():
        st = T.simulate(sc.state, sc.cfg, num_steps=ORACLE_STEPS)[0]
        tiles = st.pos[:k * r].reshape(k, r, 3) - tile_offsets(k, dev)
        d_ref = (tiles - ref_pos).abs().amax(dim=(1, 2)).tolist()
        d_t0 = (tiles - tiles[0]).abs().amax(dim=(1, 2)).tolist()
        print(f"x{k}: after {ORACLE_STEPS} steps tile 0 lies {d_ref[0]:.4g} "
              f"from the x1 run ({d_ref[0] / spread:.3g} x the x1 run's own "
              f"spread {spread:.4g}), every tile at most {max(d_t0):.4g} "
              f"from tile 0 (bound {ORACLE_TOL:g} each); per tile, from "
              f"tile 0 {[round(v, 7) for v in d_t0]}, from the x1 run "
              f"{[round(v, 7) for v in d_ref]}", flush=True)
        if not (d_ref[0] <= ORACLE_TOL and max(d_t0) <= ORACLE_TOL):
            raise AssertionError(f"x{k}: tiles diverge from the x1 run")
        oracle[f"x{k}"] = {"tile0_vs_x1": d_ref[0], "tiles_vs_x1": d_ref,
                           "tiles_vs_tile0": d_t0}
    return {"runs": out, "oracle": oracle}


def phase_small_replicate(dev) -> None:
    """Phase 25: susane x2 (two clusters, blocked form), 6 coupled and 6
    SM-only steps on the card against the port on the CPU."""
    small = T.build_scene("susane", replicate=SMALL_REPLICATE, device=dev)
    slice_card_vs_cpu(small, f"susane x{SMALL_REPLICATE} coupled")
    got = variants.simulate_sm_only(small.state, small.cfg, SMALL_STEPS)[0]
    want = variants.simulate_sm_only(small.state.to("cpu"), small.cfg,
                                     SMALL_STEPS)[0]
    a = want.active
    for name in ("pos", "vel"):
        err = float((getattr(got, name).cpu()[a]
                     - getattr(want, name)[a]).abs().max())
        print(f"susane x{SMALL_REPLICATE} SM-only {name}: max abs diff "
              f"{err:.3g} (tolerance {SLICE_TOLS[name]:g})", flush=True)
        if not err <= SLICE_TOLS[name]:
            raise AssertionError(f"SM-only {name}: card vs CPU diverged")


def phase_sm_only_big(big) -> dict:
    """Phase 26: SM-only on x56, finite fields."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, aux = variants.simulate_sm_only(big.state, big.cfg, SM_BIG_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_fields_finite(st, big.cfg, f"SM-only x{REPLICATE}")
    d = st.displacement()[st.active]
    print(f"SM-only x{REPLICATE}: {SM_BIG_STEPS} steps in {wall:.3f} s wall, "
          f"mean displacement {float(d.mean()):.6g} (max "
          f"{float(d.max()):.6g})", flush=True)
    return {"steps": SM_BIG_STEPS, "wall_s": wall}


def best_ms_per_step(run, steps: int, reps: int = 3) -> float:
    """Best wall ms per step of `reps` calls run(steps), each ending in a
    host fetch of its result, after a two-step warm-up (which captures)."""
    run(2)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = run(steps)[0]
        float(st.pos[0, 0])
        best = min(best, time.perf_counter() - t0)
    return best / steps * 1e3


def launches_per_step(run) -> dict:
    """Per step of run(steps): the device operations torch.profiler records
    (kernels, and the memsets a library runs) and the kernel launch calls
    the host makes (the difference of a 4- and a 2-step call, so the
    per-call set-up drops out)."""
    kinds = {}
    for steps in (2, 4):
        run(steps)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        kinds[steps] = (
            sum(e.count for e in ev
                if e.device_type == torch.autograd.DeviceType.CUDA),
            sum(e.count for e in ev if e.key in LAUNCH_CALLS))
    return {"kernels": (kinds[4][0] - kinds[2][0]) / 2,
            "launch_calls": (kinds[4][1] - kinds[2][1]) / 2}


def form_times(sc, label: str) -> dict:
    """project_positions per call on the replicated scene `sc` in each of
    the three clustered forms, forced (blocked: _BLOCKED_MAX_LANES raised
    past f*K; contig: lowered to 0; one-hot: also sm_tile_rows = 0): wall
    ms (best of 3 x FORM_CALLS calls ending in a sync) and device ms
    (torch.profiler)."""
    out = {}
    for form, lanes, tile_r in (("blocked", 1 << 30, sc.cfg.sm_tile_rows),
                                ("contig", 0, sc.cfg.sm_tile_rows),
                                ("onehot", 0, 0)):
        cfg = sc.cfg.replace(sm_tile_rows=tile_r)
        with mock.patch.object(tsm, "_BLOCKED_MAX_LANES", lanes):
            inv = sm_invariants(sc.state, cfg)
            got = tsm._segment_form(inv, cfg, sc.state.capacity)
            if got != form:
                raise AssertionError(f"{label}: forced {form}, took {got}")

            def call():
                return tsm.project_positions(sc.state, cfg, inv)
            call()
            wall = float("inf")
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(FORM_CALLS):
                    call()
                torch.cuda.synchronize()
                wall = min(wall, time.perf_counter() - t0)
            dev_ms = device_ms(call, FORM_CALLS)
        out[form] = {"wall_ms": wall / FORM_CALLS * 1e3, "device_ms": dev_ms}
        del inv
    print(f"{label}: project_positions per call, by clustered form: "
          + ", ".join(f"{f} {v['wall_ms']:.4f} ms wall / {v['device_ms']:.4f}"
                      f" ms device" for f, v in out.items()), flush=True)
    return out


def phase_multi_timing(dev, big, x7) -> dict:
    """Phase 27: ms/step of coupled x7, coupled x56 and SM-only x56 (best
    of 3 graphed calls ending in a host fetch), their peak memory, and the
    CUDA launches per step of the eager coupled step: equal on x7 and x56
    in the contig form (x7 forced into it), and no more on x56 than on x7
    in its own blocked form."""
    runs = {
        "coupled_x7": lambda k: T.simulate(x7.state, x7.cfg, k),
        f"coupled_x{REPLICATE}": lambda k: T.simulate(big.state, big.cfg, k),
        f"sm_only_x{REPLICATE}": lambda k: variants.simulate_sm_only(
            big.state, big.cfg, k)}
    out = {}
    for name, run in runs.items():
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = best_ms_per_step(run, MULTI_TIMING_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        out[name] = {"ms_per_step": ms, "peak_gib": peak / 2**30,
                     "above_held_gib": (peak - base) / 2**30}
        print(f"{name}: {ms:.4f} ms/step (best of 3 x {MULTI_TIMING_STEPS} "
              f"steps), max_memory_allocated {peak / 2**30:.4f} GiB "
              f"({(peak - base) / 2**30:.4f} GiB above the "
              f"{base / 2**30:.4f} GiB held before)", flush=True)
    # the eager step's launches (a graph replay launches none from the
    # host); eager also keeps the forced contig form from a cached capture
    # of the blocked one
    with eager_steps():
        counts = {"x7": launches_per_step(runs["coupled_x7"]),
                  f"x{REPLICATE}": launches_per_step(
                      runs[f"coupled_x{REPLICATE}"])}
        with mock.patch.object(tsm, "_BLOCKED_MAX_LANES", 0):
            counts["x7 contig"] = launches_per_step(runs["coupled_x7"])
    print(f"coupled step, CUDA kernels run and kernel launch calls per "
          f"step: {counts}", flush=True)
    calls = {name: c["launch_calls"] for name, c in counts.items()}
    if not (calls["x7 contig"] == calls[f"x{REPLICATE}"] <= calls["x7"]):
        raise AssertionError("the launches per step grow with the cluster "
                             "count")
    out["launches_per_step"] = counts
    out["forms"] = {"x7": form_times(x7, "x7"),
                    f"x{REPLICATE}": form_times(big, f"x{REPLICATE}")}
    return out


def phase_demos() -> dict:
    """Phase 28: the three ported demos on the card."""
    t0 = time.perf_counter()
    res = contraction_demo.main(["biceps_18475", str(CONTRACTION_STEPS)])
    frames = [f for f in res["frames"] if Path(f).is_file()]
    print(f"contraction_demo: {len(frames)} frames written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if len(frames) != 20:
        raise AssertionError(f"contraction_demo wrote {len(frames)} frames")
    check_fields_finite(res["state"], T.SimConfig(), "contraction_demo")
    t0 = time.perf_counter()
    stim = fit_stimulus_demo.main(["4", "3"])
    t1 = time.perf_counter()
    mat = fit_material_demo.main(["6", "100"])
    t2 = time.perf_counter()
    print(f"fit_stimulus_demo 4 3: {stim['err'] * 100:.3f}% off in "
          f"{t1 - t0:.3f} s; fit_material_demo 6 100: K "
          f"{mat['err_k'] * 100:.2f}% off, mu {mat['err_mu'] * 100:.2f}% off "
          f"in {t2 - t1:.3f} s", flush=True)
    if not stim["err"] < 0.01:
        raise AssertionError("fit_stimulus_demo missed 1%")
    if not max(mat["err_k"], mat["err_mu"]) < 0.2:
        raise AssertionError("fit_material_demo missed 20%")
    return {"stimulus_err": stim["err"], "material_err_k": mat["err_k"],
            "material_err_mu": mat["err_mu"], "frames": len(frames)}


def run_cli(argv, names=(), buf=None):
    """cli.main(argv) with the launch counts of the kernels `names` set to
    0 just before it and read just after; its standard output goes to
    `buf` (a fresh StringIO if None), then is echoed and returned. Returns
    (rc, launches, output, wall seconds)."""
    for nm in names:
        getattr(KERNEL_MODULE[nm], nm).launches = 0
    buf = buf if buf is not None else io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    return (rc, {nm: getattr(KERNEL_MODULE[nm], nm).launches
                 for nm in names}, out, wall)


def counting_profiler(names, seen):
    """profile_phases_fused, recording into `seen` the launches of the
    kernels `names` that its own chains make."""
    real = report_mod.profile_phases_fused

    def wrapped(*args, **kw):
        before = {nm: getattr(KERNEL_MODULE[nm], nm).launches
                  for nm in names}
        out = real(*args, **kw)
        for nm in names:
            seen[nm] = getattr(KERNEL_MODULE[nm], nm).launches - before[nm]
        return out
    return wrapped


def stop_when_paused(ctl: Path, buf: io.StringIO, step: int):
    """A thread that appends 'stop' to the control file `ctl` once the
    CLI's output `buf` says the run paused at `step` (its --pause-at),
    where it waits on the file."""
    def watch():
        while f"paused at step {step} " not in buf.getvalue():
            time.sleep(0.05)
        with open(ctl, "a") as f:
            f.write("stop\n")
    t = threading.Thread(target=watch, daemon=True)
    t.start()
    return t


def check_resumed(end, full, cfg) -> bool:
    """The resumed run's final state against the uninterrupted run's, at
    RESUME_TOLS / RESUME_DENS_RTOL; returns whether every field's bits
    are equal."""
    a = full.active
    for name, atol in RESUME_TOLS.items():
        err = float((getattr(end, name)[a] - getattr(full, name)[a]).abs()
                    .max())
        print(f"resumed vs uninterrupted {name}: max abs diff {err:.3g} "
              f"(tolerance {atol:g})", flush=True)
        if not err <= atol:
            raise AssertionError(f"resumed run: {name} off the "
                                 "uninterrupted run")
    rel = float(((end.dens[a] - full.dens[a]) / full.dens[a]).abs().max())
    if not rel <= RESUME_DENS_RTOL:
        raise AssertionError("resumed run: dens off the uninterrupted run")
    check_in_world(end, cfg, "resumed run")
    return all(torch.equal(getattr(end, f.name), getattr(full, f.name))
               for f in dataclasses.fields(end))


def phase_cli(dev) -> dict:
    """Phase 29: the command line and the measuring tools on biceps_full."""
    if not runtime.native_available():
        raise AssertionError("the native trajectory writer did not build")
    out = {}
    base = ["--scene", "biceps_full", "--chunk", str(CLI_CHUNK)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rep, traj, ckpt = tmp / "report.csv", tmp / "t.bin", tmp / "end.npz"
        seen = {}
        with mock.patch.object(report_mod, "profile_phases_fused",
                               counting_profiler(("sweep_a3", "sweep_b3"),
                                                 seen)):
            rc, launches, text, wall = run_cli(
                base + ["--steps", str(CLI_STEPS), "--report", str(rep),
                        "--profile-phases", "--traj", str(traj),
                        "--save-checkpoint", str(ckpt)],
                ("sweep_a3", "sweep_b3"))
        run_launches = {nm: launches[nm] - seen.get(nm, 0) for nm in launches}
        print(f"cli coupled: rc {rc} in {wall:.3f} s; K1 / K2 launches "
              f"{launches}, of them the profiler's {seen}, the run's "
              f"{run_launches}", flush=True)
        if rc != 0 or "overflow=0" not in text:
            raise AssertionError("cli coupled run failed or overflowed")
        if run_launches != {"sweep_a3": CLI_STEPS, "sweep_b3": CLI_STEPS}:
            raise AssertionError(f"cli run launched {run_launches}")
        header, row = rep.read_text().splitlines()
        cols = row.split(";")
        if header != report_mod.REPORT_HEADER or len(cols) != 23:
            raise AssertionError("cli report row off the schema")
        step_s = float(cols[1])
        phase_sum = sum(float(c) for c in cols[3:10])
        print(f"cli report row: {row}\nstep {step_s * 1e3:.4f} ms, phase "
              f"columns sum {phase_sum * 1e3:.4f} ms", flush=True)
        if not (step_s > 0 and 0.5 * step_s <= phase_sum <= 1.5 * step_s):
            raise AssertionError("cli report row: phases do not reconcile")
        steps, payload = runtime.read_trajectory(traj)
        world = np.asarray(T.SimConfig().world_size, np.float32)
        pos = payload[..., :3]
        print(f"cli trajectory: steps {steps.tolist()}, payload "
              f"{payload.shape}", flush=True)
        if steps.tolist() != list(range(CLI_CHUNK, CLI_STEPS + 1,
                                         CLI_CHUNK)) \
                or not np.isfinite(payload).all() \
                or (pos < 0).any() or (pos > world).any():
            raise AssertionError("cli trajectory frames off")
        full, step, _ = T.load_checkpoint(str(ckpt), with_config=True,
                                          device=dev)
        if step != CLI_STEPS:
            raise AssertionError(f"cli checkpoint at step {step}")
        raw = [ln for ln in text.splitlines()
               if ln.startswith("profile raw pipelines")]
        out["coupled"] = {"wall_s": wall, "launches": launches,
                          "profiler_launches": seen, "row": row,
                          "raw_line": raw[0] if raw else None}

        # the same run stopped at step CLI_STOP_AT by its control file,
        # then resumed from the checkpoint it saved
        ctl, half = tmp / "ctl", tmp / "half.npz"
        ctl.write_text("")
        buf = io.StringIO()
        watcher = stop_when_paused(ctl, buf, CLI_STOP_AT)
        rc1, _, _, wall1 = run_cli(
            base + ["--steps", str(CLI_STEPS), "--stim-off-step",
                    str(CLI_STEPS // 2), "--control", str(ctl),
                    "--pause-at", str(CLI_STOP_AT), "--save-checkpoint",
                    str(half)], buf=buf)
        watcher.join()
        if rc1 != 0 or T.load_checkpoint(str(half), device=dev)[1] \
                != CLI_STOP_AT:
            raise AssertionError("the stopped run did not save step "
                                 f"{CLI_STOP_AT}")
        rc2, _, _, wall2 = run_cli(
            base + ["--steps", str(CLI_STEPS), "--stim-off-step",
                    str(CLI_STEPS // 2), "--load-checkpoint", str(half),
                    "--save-checkpoint", str(tmp / "resumed.npz")])
        end, step, _ = T.load_checkpoint(str(tmp / "resumed.npz"),
                                         with_config=True, device=dev)
        if rc2 != 0 or step != CLI_STEPS:
            raise AssertionError("the resumed run did not reach the end")
        bits = check_resumed(end, full, T.SimConfig())
        print(f"resume: stopped at {CLI_STOP_AT} in {wall1:.3f} s, resumed "
              f"to {CLI_STEPS} in {wall2:.3f} s; bit-equal to the "
              f"uninterrupted run: {bits}", flush=True)
        out["resume"] = {"bit_equal": bits, "wall_s": [wall1, wall2]}

        modes = {"monodomain": ("sweep_lap3", "sweep_a3"),
                 "sph": ("sweep_a3", "sweep_b3"), "sm": ("sweep_a3",)}
        want = {"monodomain": {"sweep_lap3": CLI_MODE_STEPS + 1,
                               "sweep_a3": 1},
                "sph": {"sweep_a3": CLI_MODE_STEPS,
                        "sweep_b3": CLI_MODE_STEPS},
                "sm": {"sweep_a3": 0}}
        out["modes"] = {}
        for mode, names in modes.items():
            rc, launches, text, wall = run_cli(
                base + ["--mode", mode, "--steps", str(CLI_MODE_STEPS),
                        "--save-checkpoint", str(tmp / f"{mode}.npz")],
                names)
            st = T.load_checkpoint(str(tmp / f"{mode}.npz"), device=dev)[0]
            check_fields_finite(st, T.SimConfig(), f"cli --mode {mode}")
            print(f"cli --mode {mode}: rc {rc} in {wall:.3f} s, launches "
                  f"{launches}", flush=True)
            if rc != 0 or launches != want[mode]:
                raise AssertionError(f"cli --mode {mode}: rc {rc}, "
                                     f"launches {launches}")
            out["modes"][mode] = {"wall_s": wall, "launches": launches}

        tools = {}
        t0 = time.perf_counter()
        ph = profile_phases.main(["--scene", "biceps_full"])
        tools["profile_phases"] = {
            "s": time.perf_counter() - t0,
            "raw_pipeline_ms": [t * 1e3 for t in ph["raw_pipeline_s"]],
            "total_ms": ph["total_step"] * 1e3}
        t0 = time.perf_counter()
        rows = hbm_footprint.main(["--scenes", "biceps_full,biceps_full:7"])
        if len(rows) != 2:
            raise AssertionError("hbm_footprint measured no scene")
        tools["hbm_footprint"] = {"s": time.perf_counter() - t0,
                                  "rows": rows}
        t0 = time.perf_counter()
        tools["ablate_fused"] = {"ms": ablate_fused.main(
            ["biceps_full", "full", "book"]), "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        lines = bench_rows.main(["--scenes", "biceps_full::100", "--out",
                                 str(tmp / "rows.csv")])
        tools["bench_rows"] = {"rows": lines, "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        if sweep.main(["--quick", "--scene", "biceps_full", "--steps",
                       str(CLI_SWEEP_STEPS), "--out",
                       str(tmp / "sweep.csv")]) != 0:
            raise AssertionError("sweep --quick failed")
        rows = [ln for ln in (tmp / "sweep.csv").read_text().splitlines()
                if ln and not ln.startswith(("#", "Avg F"))]
        if len(rows) != 8:
            raise AssertionError(f"sweep --quick wrote {len(rows)} rows")
        tools["sweep"] = {"rows": len(rows), "s": time.perf_counter() - t0}
        out["tools"] = tools
    return out


# --- phase 30: multi-device runs (two ranks sharing the card) ---------------

# the slab launches of K1 / K2 (ops/fused_step.sweep_a3 / sweep_b3 with
# q_slice or n_q != n_c, counted in their `slab_launches`): name, source,
# TPU kernel replaced
SLAB_KERNELS = (
    ("sweep_a3_slab", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:446", "sweep_a3"),
    ("sweep_b3_slab", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:522", "sweep_b3"),
)
# ranks sharing the card; steps of the short parity runs against one device,
# of the fused protocol (stim off at half) and its chunks, of each timing, of
# the gather path, and of the halo run on biceps_full x7 that counts
# migration; each collective's wait bound
PAR_RANKS, PAR_PARITY_STEPS = 2, 3
PAR_STEPS, PAR_CHUNK, PAR_TIMING_STEPS = 200, 100, 20
PAR_GATHER_STEPS, PAR_HALO_REPLICATE, PAR_HALO_STEPS = 3, 7, 50
PAR_TIMEOUT_S = 300
# Two ranks against one device, by particle identity: each field within
# the JAX suite's tolerance for its path (tests/test_sharded_fused.py,
# tests/test_sharded.py, tests/test_halo.py; (atol, rtol), one of them
# used) or within twice one device's own change when the same run starts
# from the state with its rows shuffled (seeded), whichever is larger: the
# ranks add the shape-matching moments in rank order, and on biceps_full
# that moves one step's corrected velocities 1.0e-4 (the port on the CPU;
# a shuffle of the rows 0.8-1.3e-4; JAX's own psum over 2 devices
# 5.7e-4), which the step amplifies ~100x in vel (tests/torch_parity.py's
# rule, with a shuffle in place of its 1-ulp bump, which shape matching
# absorbs)
PAR_FUSED_TOLS = {"pos": (5e-5, 0), "vel": (5e-4, 0), "vm": (1e-3, 0),
                  "dens": (0, 1e-5), "inter_vm": (5e-3, 0)}
PAR_GATHER_TOLS = {"pos": (5e-5, 0), "vel": (5e-4, 0), "vm": (1e-3, 0),
                   "dens": (0, 1e-5)}
PAR_HALO_TOLS = {"pos": (2e-5, 0), "vel": (5e-3, 0), "vm": (1e-3, 0),
                 "dens": (1.0, 0), "iion": (1e-6, 0), "w": (1e-7, 0)}
PAR_SHUFFLE_SEED = 13
PAR_FIELDS = ("pos", "vel", "vm", "dens", "iion", "w", "inter_vm", "stim",
              "active", "orig_pos")
# the command line's short runs (steps, chunk), and the resumed steps
PAR_CLI_STEPS, PAR_CLI_CHUNK, PAR_CLI_RESUME = 20, 10, 10
# the gather path's value-and-grad: the stim-off index inside
# PAR_GATHER_STEPS steps at NCCL world size 1, the steps of the run of
# PAR_RANKS ranks sharing the card, the overrides that require grad (the
# initial vel requires grad too), the seed of the loss weights w (loss
# sum(pos * w)); against one device, tests/test_torch_parallel.py's
# tolerances (the value relative, each gradient relative to its largest
# magnitude), each widened to twice one device's own largest relative
# change when every live position moves one ulp or the rows are shuffled
# (PAR_SHUFFLE_SEED)
PAR_GRAD_STIM_OFF, PAR_GRAD_RANK_STEPS, PAR_GRAD_SEED = 1, 2, 5
PAR_GRAD_PARAMS = {"k_stiffness": 0.8, "mu_viscosity": 150.0}
PAR_GRAD_VALUE_RTOL, PAR_GRAD_RTOL = 1e-5, 1e-4
# the halo pricing tool's run (tools/halo_gpu.py): replicate, scan length
HALO_TOOL_ARGS = ("7", "20")


def grad_weights(cap: int, dev) -> torch.Tensor:
    """The seeded weights w (cap, 3) of the gradient runs' loss."""
    return torch.from_numpy(np.random.default_rng(PAR_GRAD_SEED).normal(
        size=(cap, 3)).astype(np.float32)).to(dev)


def gather_value_and_grad(run, st0, w) -> list:
    """[loss, d/dK, d/dmu, d/dvel] of loss = sum(pos * w) after run(state,
    params), the initial vel and the PAR_GRAD_PARAMS overrides requiring
    grad."""
    vel = st0.vel.detach().clone().requires_grad_()
    params = {k: torch.tensor(v, device=st0.pos.device, requires_grad=True)
              for k, v in PAR_GRAD_PARAMS.items()}
    out = run(st0.replace(vel=vel), params)
    val = (out.pos * w).sum()
    return [val.detach(), *torch.autograd.grad(val, [*params.values(),
                                                     vel])]


def one_device_grad(scp, steps: int, st0=None, w=None) -> list:
    """gather_value_and_grad of the one-device unfused adjoint
    (simulate(fused=False), phase 32's path) over `steps` steps, the stim
    off before PAR_GRAD_STIM_OFF."""
    st0 = scp.state if st0 is None else st0
    w = grad_weights(st0.capacity, st0.device) if w is None else w
    return gather_value_and_grad(lambda st, p: T.simulate(
        st, scp.cfg, steps, PAR_GRAD_STIM_OFF, fused=False,
        neighbor_capacity=scp.neighbor_capacity, params=p)[0], st0, w)


def one_device_grad_spread(scp, steps: int, want: list) -> list:
    """One device's own largest relative change of each output of
    one_device_grad (`want`) when every live position moves one float32
    ulp toward +inf, and when its rows are shuffled (PAR_SHUFFLE_SEED; the
    loss weights and vel's gradient follow the rows)."""
    st = scp.state
    bumped = st.replace(pos=torch.where(st.active[:, None], torch.nextafter(
        st.pos, torch.full_like(st.pos, float("inf"))), st.pos))
    perm = torch.from_numpy(np.random.default_rng(PAR_SHUFFLE_SEED)
                            .permutation(st.capacity)).to(st.device)
    shuffled = T.ParticleState(**{
        f: getattr(st, f) if f == "is_stim_on" else getattr(st, f)[perm]
        for f in FIELD_NAMES})
    w = grad_weights(st.capacity, st.device)
    other = one_device_grad(scp, steps, bumped)
    shuf = one_device_grad(scp, steps, shuffled, w[perm])
    vel = torch.empty_like(shuf[3])
    vel[perm] = shuf[3]
    shuf[3] = vel
    return [max(float((x - b).abs().max()) / float(b.abs().max())
                for x in (o, s)) for b, o, s in zip(want, other, shuf)]


GRAD_NAMES = ("value", "d/dK", "d/dmu", "d/dvel")


def hold_grad_to_one_device(what, got, scp, steps: int, want=None) -> dict:
    """`got` ([loss, d/dK, d/dmu, d/dvel] of a multi-device run) against
    one device's: bit for bit, or each output within max(its tolerance, 2
    x one device's spread) of its largest magnitude. Prints which;
    returns {"bit_equal", "errors", "limits", "spread"}."""
    want = one_device_grad(scp, steps) if want is None else want
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        print(f"{what} vs one device's unfused adjoint: bit for bit",
              flush=True)
        return {"bit_equal": True}
    spread = one_device_grad_spread(scp, steps, want)
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]
    lims = [max(PAR_GRAD_VALUE_RTOL if i == 0 else PAR_GRAD_RTOL, 2.0 * sp)
            for i, sp in enumerate(spread)]
    print(f"{what} vs one device's unfused adjoint: not bit for bit; "
          "relative errors (of each output's largest magnitude) "
          + ", ".join(f"{n} {e:.3g} (limit {lim:.3g}, one device's spread "
                      f"{sp:.3g})" for n, e, lim, sp in
                      zip(GRAD_NAMES, errs, lims, spread)), flush=True)
    if any(not e <= lim for e, lim in zip(errs, lims)):
        raise AssertionError(f"{what}: off one device: {errs} vs {lims}")
    return {"bit_equal": False, "errors": errs, "limits": lims,
            "spread": spread}


def par_pad(scene_cap: int, sub_q: int) -> int:
    """The capacity the fused slab path pads to at PAR_RANKS ranks (as the
    command line pads it: whole sub-blocks a rank)."""
    m = PAR_RANKS * sub_q
    return -(-scene_cap // m) * m


def rank_ms(step, st, steps: int, comm):
    """(host ms per step of st = step(st) over `steps` steps, ended by a
    synchronize and a barrier on every rank; the state)."""
    comm.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = step(st)
    torch.cuda.synchronize()
    comm.barrier()
    return (time.perf_counter() - t0) * 1e3 / steps, st


# one gloo collective on CUDA tensors between two processes (argv: rank,
# port, collective); prints "RESULT ok" where it ran and gave the right
# values. A collective gloo takes without copying through the host may
# crash its process, so each runs in processes of its own.
GLOO_PROBE = r"""
import datetime, sys, torch, torch.distributed as dist
rank, port, op = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=30))
torch.cuda.set_device(0)
x = torch.full((4,), float(rank + 1), device="cuda")
both = torch.tensor([1.0] * 4 + [2.0] * 4, device="cuda")
if op == "all_reduce":
    y = x.clone(); dist.all_reduce(y); ok = bool((y == 3.0).all())
elif op == "broadcast":
    y = x.clone(); dist.broadcast(y, 0); ok = bool((y == 1.0).all())
elif op == "all_gather":
    ys = [torch.empty_like(x) for _ in range(2)]; dist.all_gather(ys, x)
    ok = bool((torch.cat(ys) == both).all())
elif op == "all_gather_into_tensor":
    y = x.new_empty(8); dist.all_gather_into_tensor(y, x)
    ok = bool((y == both).all())
else:
    y = torch.empty_like(x)
    for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                     dist.P2POp(dist.irecv, y, 1 - rank)]):
        r.wait()
    torch.cuda.synchronize(); ok = bool((y == 2.0 - rank).all())
print("RESULT", "ok" if ok else "wrong values", flush=True)
dist.destroy_process_group()
"""
GLOO_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
            "isend_irecv")


def probe_gloo_cuda() -> dict:
    """Which gloo collectives take CUDA tensors as they are, two processes
    on the card for each, all at once (the port's gloo-host transport
    copies every collective's tensors through host memory instead):
    {collective: "accepted" or what happened}."""
    from sph_sm_monodomain_tpu_torch.parallel import comm as C
    procs = {op: [subprocess.Popen(
        [sys.executable, "-c", GLOO_PROBE, str(r), str(port), op],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
        for op, port in ((op, C.free_port()) for op in GLOO_OPS)}
    found = {}
    for op, ps in procs.items():
        outs = []
        for p in ps:
            try:
                outs.append((p.communicate(timeout=90)[0], p.returncode))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append((p.communicate()[0], "killed after 90 s"))
        if all(rc == 0 and "RESULT ok" in o for o, rc in outs):
            found[op] = "accepted"
            continue
        o, rc = next((o, rc) for o, rc in outs
                     if not (rc == 0 and "RESULT ok" in o))
        lines = [ln for ln in o.splitlines()
                 if "Error" in ln or "what()" in ln or "RESULT" in ln]
        found[op] = f"refused (exit {rc}): {(lines or ['-'])[-1][:160]}"
    return found


def _save_fields(st, path):
    torch.save({k: getattr(st, k).cpu() for k in PAR_FIELDS}, path)


def par_rank_main(comm, out_dir):
    """One rank of phase 30 (PAR_RANKS ranks on the card): on biceps_full
    padded to whole sub-blocks, the fused slab path's
    parity steps, timing and PAR_STEPS-step protocol with its K1 / K2
    launch counts, the gather path's steps and timing; on biceps_full x7
    the halo path (its first step's sweep inputs recorded), its parity
    steps, timing and the longer run. Rank 0 writes the gathered states;
    every rank writes rank<r>.json."""
    from sph_sm_monodomain_tpu_torch.parallel import halo_step as PH
    from sph_sm_monodomain_tpu_torch.parallel import sharded_step as PS
    monodomain.ensure_fp32()
    out, dev, lead = Path(out_dir), comm.device, comm.rank == 0
    res = {"transport": comm.transport, "describe": comm.describe(),
           "run_loop": PS.run_loop(comm)[1]}
    sc = T.build_scene("biceps_full", device=dev)
    sc = T.build_scene("biceps_full", device=dev,
                       pad_to=par_pad(sc.state.capacity, sc.sub_block))
    cfg, sub_q = sc.cfg, sc.sub_block

    # the fused slab path: parity steps, timing, the protocol with counts
    step = PS.make_sharded_step_fused(comm, cfg, sub_q=sub_q)
    st = PS.shard_state(sc.state, comm)
    for i in range(PAR_PARITY_STEPS):
        st, _ = step(st)
        full = PS.gather_state(st, comm)
        if lead and i in (0, PAR_PARITY_STEPS - 1):
            _save_fields(full, out / f"fused{i + 1}.pt")
    res["fused_ms"], _ = rank_ms(lambda s: step(s)[0], st, PAR_TIMING_STEPS,
                                 comm)
    stim_off = PAR_STEPS // 2
    st = PS.shard_state(sc.state, comm)
    fst.sweep_a3.slab_launches = fst.sweep_b3.slab_launches = 0
    fst.sweep_a3.launches = fst.sweep_b3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    while done < PAR_STEPS:
        n = min(PAR_CHUNK, PAR_STEPS - done)
        off = stim_off - done if done <= stim_off < done + n else -1
        st, _ = PS.make_sharded_simulate_fused(comm, cfg, n, off,
                                               sub_q=sub_q)(st)
        done += n
    torch.cuda.synchronize()
    res["protocol"] = {
        "wall_s": time.perf_counter() - t0,
        "slab_launches": [fst.sweep_a3.slab_launches,
                          fst.sweep_b3.slab_launches],
        "full_launches": [fst.sweep_a3.launches, fst.sweep_b3.launches]}
    full = PS.gather_state(st, comm)
    if lead:
        _save_fields(full, out / "protocol.pt")

    # the unfused all-gather path
    gstep = PS.make_sharded_step(comm, cfg, sc.neighbor_capacity)
    st = PS.shard_state(sc.state, comm)
    ovf = []
    for _ in range(PAR_GATHER_STEPS):
        st, o = gstep(st)
        ovf.append(int(o))
    res["gather_overflow"] = ovf
    full = PS.gather_state(st, comm)
    if lead:
        _save_fields(full, out / "gather.pt")
    res["gather_ms"], _ = rank_ms(lambda s: gstep(s)[0], st,
                                  PAR_GATHER_STEPS, comm)
    # its value-and-grad: the eager adjoint scan through host copies, each
    # rank differentiating its rows' share of the loss
    gsim = PS.make_sharded_simulate(comm, cfg, sc.neighbor_capacity,
                                    PAR_GRAD_RANK_STEPS, PAR_GRAD_STIM_OFF)
    n_loc = sc.state.capacity // comm.size
    w = grad_weights(sc.state.capacity, dev)[comm.rank * n_loc:
                                              (comm.rank + 1) * n_loc]
    comm.barrier()
    t0 = time.perf_counter()
    got = gather_value_and_grad(lambda s, p: gsim(s, p)[0],
                                PS.shard_state(sc.state, comm), w)
    torch.cuda.synchronize()
    res["grad_s"] = time.perf_counter() - t0
    with torch.no_grad():
        grad = {"value": comm.all_sum(got[0].double()).cpu(),
                "params": comm.all_gather(torch.stack(got[1:3])[None]).cpu(),
                "vel": comm.all_gather(got[3]).cpu()}
    if lead:
        torch.save(grad, out / "grad.pt")

    # the halo path on biceps_full x7 (a world stretched along x)
    x7 = T.build_scene("biceps_full", replicate=PAR_HALO_REPLICATE,
                       device=dev)
    cfg7, sq7 = x7.cfg, x7.sub_block
    st, s_cap, mig, halo = PH.shard_state_halo(x7.state, comm, cfg7,
                                               q_block=sq7)
    res["halo_caps"] = [s_cap, mig, halo]
    hstep = PH.make_halo_step(comm, cfg7, mig, halo, sub_q=sq7)
    rec = {}

    def recording(name, real):
        def call(*args, **kw):
            rec.setdefault(name, [a.detach().clone() if torch.is_tensor(a)
                                  else a for a in args[:4]])
            return real(*args, **kw)
        return call
    with mock.patch.object(PH, "sweep_a3", recording("a", PH.sweep_a3)), \
            mock.patch.object(PH, "sweep_b3", recording("b", PH.sweep_b3)):
        st, o = hstep(st)
    torch.save(rec, out / f"halo_inputs{comm.rank}.pt")
    ovf = [int(o)]
    for _ in range(PAR_PARITY_STEPS - 1):
        st, o = hstep(st)
        ovf.append(int(o))
    full = PS.gather_state(st, comm)
    if lead:
        _save_fields(full, out / "halo.pt")
    res["halo_ms"], _ = rank_ms(lambda s: hstep(s)[0], st, PAR_TIMING_STEPS,
                                comm)
    sim = PH.make_halo_simulate(comm, cfg7, mig, halo, PAR_HALO_STEPS,
                                sub_q=sq7)
    st, o = sim(PH.shard_state_halo(x7.state, comm, cfg7, q_block=sq7)[0])
    res["halo_overflow"] = ovf + [int(o)]
    full = PS.gather_state(st, comm)
    if lead:
        _save_fields(full, out / "halo_end.pt")
    (out / f"rank{comm.rank}.json").write_text(json.dumps(res))


def _by_identity(fields: dict):
    """The active rows of saved fields ordered by orig_pos (numpy)."""
    act = fields["active"].numpy()
    op = fields["orig_pos"].numpy()[act]
    key = np.lexsort((op[:, 2], op[:, 1], op[:, 0]))
    return {k: v.numpy()[act][key] for k, v in fields.items()}, int(act.sum())


def _fields_of(st):
    return {k: getattr(st, k).detach().cpu() for k in PAR_FIELDS}


def one_device_runs(step, st, counts):
    """{k: fields by identity after k steps of st = step(st)} for k in
    counts, from st and from st with its rows shuffled (PAR_SHUFFLE_SEED):
    (runs, shuffled runs)."""
    perm = torch.from_numpy(np.random.default_rng(PAR_SHUFFLE_SEED)
                            .permutation(st.capacity)).to(st.device)
    shuffled = T.ParticleState(**{
        f.name: (getattr(st, f.name) if getattr(st, f.name).dim() == 0
                 else getattr(st, f.name)[perm])
        for f in dataclasses.fields(st)})
    outs = []
    for s0 in (st, shuffled):
        out = {}
        for k in range(1, max(counts) + 1):
            s0 = step(s0)
            if k in counts:
                out[k] = _by_identity(_fields_of(s0))[0]
        outs.append(out)
    return outs


def hold_close(what, got, want, shuffled, tols) -> dict:
    """Fields `got` (by identity) against one device's `want`, each within
    max(its tolerance, 2 x one device's shuffle spread |want - shuffled|)
    (PAR_FUSED_TOLS' rule). Returns {field: (error, limit, spread)}."""
    out = {}
    for name, (atol, rtol) in tols.items():
        a, b, c = got[name], want[name], shuffled[name]
        scale = np.maximum(np.abs(b), 1e-30) if rtol else 1.0
        err = float((np.abs(a - b) / scale).max())
        spread = float((np.abs(c - b) / scale).max())
        lim = max(rtol or atol, 2.0 * spread)
        out[name] = (err, lim, spread)
        if not err <= lim:
            raise AssertionError(f"{what}: {name} off one device by "
                                 f"{err:.3g}, limit {lim:.3g} (one "
                                 f"device's shuffle spread {spread:.3g})")
    print(f"{what}: " + ", ".join(
        f"{k} {e:.3g} (limit {lim:.3g}, spread {sp:.3g})"
        for k, (e, lim, sp) in out.items()), flush=True)
    return out


def check_slab_kernels(dev, scp):
    """K1 / K2 on each half of the padded biceps_full's sorted step-0 rows
    (q_slice, as two ranks launch them), against their plain versions per
    column, two launches bitwise equal; their times, plain times and
    bounds at that shape. Returns ({name: max err}, {name: (ms, plain
    ms)}, {name: bound tuple}, the inputs)."""
    cfg, sub_q = scp.cfg, scp.sub_block
    fs, fa, lo, hi = step0_inputs(scp, dev)
    n = fs.shape[0]
    half = n // PAR_RANKS
    plain_a = fst.sweep_a3_plain(fs, fa, cfg)
    fb = fst.feats_b(plain_a)
    errs, times, bounds = {}, {}, {}
    for name, _, _, base in SLAB_KERNELS:
        kern = getattr(fst, base)
        plain = getattr(fst, f"{base}_plain")
        qm, feats = (fs, fa) if base == "sweep_a3" else (plain_a, fb)
        scratch = {}
        for off in range(0, n, half):
            launch = lambda o=off: kern(qm, feats, lo, hi, cfg,  # noqa: E731
                                        sub_q=sub_q, q_slice=(o, half))
            check_kernel(scratch, f"{name} rows [{off}, {off + half}) of "
                         f"{n}", launch(), plain(qm[off:off + half], feats,
                                                 cfg))
            check_repeatable(f"{name} rows [{off}, {off + half})", launch)
        errs[name] = max(v["max_abs_err"] for v in scratch.values())
        times[name] = (
            cuda_ms(lambda: kern(qm, feats, lo, hi, cfg, sub_q=sub_q,
                                 q_slice=(0, half)), 200),
            cuda_ms(lambda: plain(qm[:half], feats, cfg), 5))
        b0, b1 = 0, half // sub_q * 4
        counts = roofline.pair_counts(qm[:half], lo[b0:b1], hi[b0:b1], cfg,
                                      sub_q, cand=fs)
        nbytes = 4 * (2 * 16 * half + 16 * n + 2 * (half // sub_q) * 4 + 32)
        bounds[name] = bound(base, counts, half, nbytes)
        b_ms = bounds[name][0]
        print(f"{name} (rows [0, {half}) of {n}): kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
              f"bound {b_ms * 1e3:.4f} us ({bounds[name][1]}; kernel at "
              f"{b_ms / times[name][0] * 100:.3f}% of it); pairs {counts}",
              flush=True)
    return errs, times, bounds


def check_halo_kernels(dev, out, cfg7, sub_q) -> dict:
    """K1 / K2 on each rank's recorded first-step halo inputs (its S query
    rows against its S + 2H merged candidates, n_q != n_c) against their
    plain versions on sampled rows, two launches bitwise equal, and rank
    0's launch time. Returns {name: max err, name + "_ms": ms}."""
    res = {}
    for r in range(PAR_RANKS):
        rec = torch.load(out / f"halo_inputs{r}.pt")
        for name, key, base in (("sweep_a3_slab", "a", "sweep_a3"),
                                ("sweep_b3_slab", "b", "sweep_b3")):
            qm, feats, lo, hi = (t.to(dev) if torch.is_tensor(t) else t
                                 for t in rec[key])
            kern = getattr(fst, base)
            plain = getattr(fst, f"{base}_plain")
            rows = sampled_rows(qm.shape[0], dev)
            launch = lambda: kern(qm, feats, lo, hi, cfg7,  # noqa: E731
                                  sub_q=sub_q)
            scratch = {}
            check_kernel(scratch, f"{name} halo rank {r} ({qm.shape[0]} "
                         f"queries, {feats.shape[1]} candidates, "
                         f"{rows.numel()} sampled rows)", launch()[rows],
                         plain_on_rows(lambda q, f=feats: plain(q, f, cfg7),
                                       qm, rows))
            check_repeatable(f"{name} halo rank {r}", launch)
            res[name] = max(res.get(name, 0.0),
                            scratch.popitem()[1]["max_abs_err"])
            if r == 0:
                res[f"{name}_ms"] = cuda_ms(launch, 50)
                print(f"{name} on rank 0's halo inputs: kernel "
                      f"{res[f'{name}_ms']:.4f} ms", flush=True)
    return res


def cli_par_runs(tmp: Path) -> dict:
    """The command line with --devices PAR_RANKS on biceps_full, one run a
    --parallel strategy, all at once (each its own ranks on the card);
    the halo run saves a checkpoint, which one device then resumes.
    Returns {strategy: (wall s, output)}."""
    base = [sys.executable, "-m", "sph_sm_monodomain_tpu_torch",
            "--scene", "biceps_full", "--steps", str(PAR_CLI_STEPS),
            "--chunk", str(PAR_CLI_CHUNK), "--devices", str(PAR_RANKS)]
    ckpt = tmp / "halo.npz"
    procs = {}
    for par in ("gather", "fused", "halo"):
        extra = ["--save-checkpoint", str(ckpt)] if par == "halo" else []
        procs[par] = (time.perf_counter(), subprocess.Popen(
            base + ["--parallel", par] + extra, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = {}
    for par, (t0, p) in procs.items():
        text = p.communicate(timeout=PAR_TIMEOUT_S)[0]
        outs[par] = (time.perf_counter() - t0, text)
        print(f"--- cli --devices {PAR_RANKS} --parallel {par} (rc "
              f"{p.returncode}, {outs[par][0]:.1f} s wall):\n{text}",
              end="", flush=True)
        if p.returncode != 0:
            raise AssertionError(f"cli --parallel {par}: rc {p.returncode}")
        want = f"parallel impl: {par} over {PAR_RANKS} devices, transport"
        eager = "run loop eager (gloo through host copies)"
        if want not in text or eager not in text or "overflow=0" not in text:
            raise AssertionError(f"cli --parallel {par}: missing {want!r}, "
                                 f"{eager!r} or overflow=0")
    t0 = time.perf_counter()
    end = tmp / "resumed.npz"
    p = subprocess.run(base[:-2] + [
        "--steps", str(PAR_CLI_STEPS + PAR_CLI_RESUME), "--load-checkpoint",
        str(ckpt), "--save-checkpoint", str(end)], capture_output=True,
        text=True, timeout=PAR_TIMEOUT_S)
    print(f"--- cli resume of the halo checkpoint on one device (rc "
          f"{p.returncode}):\n{p.stdout}{p.stderr[-2000:]}", end="",
          flush=True)
    if p.returncode != 0:
        raise AssertionError("cli: the halo checkpoint did not resume")
    st, step = T.load_checkpoint(str(end), device="cpu")
    if step != PAR_CLI_STEPS + PAR_CLI_RESUME or \
            not torch.isfinite(st.pos[st.active]).all():
        raise AssertionError(f"cli resume: step {step} or non-finite")
    outs["resume"] = (time.perf_counter() - t0, p.stdout)
    return outs


# one NCCL group of world size 1 capturing collectives in torch.cuda.graph's
# default "global" capture mode (argv: port, tries): each try runs an eager
# all_reduce, then captures two with the capture held open for 0.25 s, long
# enough for ProcessGroupNCCL's watchdog thread to wake and query the
# finished work's events (under "global" a CUDA query from another thread
# would end the capture); prints how many captures failed
NCCL_CAPTURE_PROBE = r"""
import datetime, sys, time, torch, torch.distributed as dist
port, tries = int(sys.argv[1]), int(sys.argv[2])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        world_size=1, rank=0,
                        timeout=datetime.timedelta(seconds=60))
x = torch.ones(1024, device="cuda")
failed, last = 0, "-"
for _ in range(tries):
    dist.all_reduce(x)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            dist.all_reduce(x)
            time.sleep(0.25)
            dist.all_reduce(x)
        g.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        failed += 1
        last = str(e).splitlines()[0][:160]
print("RESULT", failed, tries, last, flush=True)
dist.destroy_process_group()
"""
NCCL_PROBE_TRIES = 8
# NCCL at world size 1: steps of each timed call on biceps_full (the fused
# slab; the halo path's on x7 are PAR_HALO_STEPS)
W1_TIMING_STEPS = 100


def probe_nccl_capture() -> dict:
    """The NCCL capture probe in a process of its own (a failed capture
    may end it): {"failed": captures that failed, "tries", "last error"};
    raises where any failed, since the run loop captures NCCL collectives
    in the default mode."""
    from sph_sm_monodomain_tpu_torch.parallel import comm as C
    p = subprocess.run(
        [sys.executable, "-c", NCCL_CAPTURE_PROBE, str(C.free_port()),
         str(NCCL_PROBE_TRIES)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=120)
    lines = [ln.split(" ", 3) for ln in p.stdout.splitlines()
             if ln.startswith("RESULT")]
    if p.returncode != 0 or not lines:
        raise AssertionError(f"NCCL capture probe: exit {p.returncode}: "
                             f"{p.stdout[-500:]}")
    found = {"failed": int(lines[-1][1]), "tries": int(lines[-1][2]),
             "last_error": lines[-1][3]}
    print(f"NCCL collectives captured at world size 1 in the global capture "
          f"mode, each capture held open 0.25 s after an eager collective: "
          f"{found['failed']} of {found['tries']} failed (last error: "
          f"{found['last_error']})", flush=True)
    if found["failed"]:
        raise AssertionError("a capture of NCCL collectives failed")
    return found


def par_chunks(make, st, steps: int, chunk: int, stim_off: int):
    """The command line's chunk loop: make(n, off)(st) a chunk of at most
    `chunk` steps, the stim-off index shifted into its chunk. Returns
    (state, largest overflow)."""
    done, ovf = 0, 0
    while done < steps:
        n = min(chunk, steps - done)
        off = stim_off - done if done <= stim_off < done + n else -1
        st, o = make(n, off)(st)
        ovf = max(ovf, int(o))
        done += n
    return st, ovf


def graphed_vs_eager(label, run) -> tuple:
    """run() -> (state, overflow) graphed, then under scan.eager(): the two
    bit for bit with the same overflow and K1 / K2 slab launches
    (asserted). Returns (graphed result, the block lengths it captured,
    its slab launches)."""
    def counted(ctx):
        fst.sweep_a3.slab_launches = fst.sweep_b3.slab_launches = 0
        with ctx:
            out = run()
        torch.cuda.synchronize()
        return out, (fst.sweep_a3.slab_launches, fst.sweep_b3.slab_launches)
    seen = []
    graphed, g_slab = counted(counting_captures(seen))
    eager, e_slab = counted(scan.eager())
    diff = differing_fields(graphed[0], eager[0])
    print(f"{label}: graphed vs eager {'bit-equal' if not diff else diff}, "
          f"overflow {int(graphed[1])} / {int(eager[1])}; captures of "
          f"{seen} steps; K1 / K2 slab launches graphed {g_slab}, eager "
          f"{e_slab}", flush=True)
    if diff or int(graphed[1]) != int(eager[1]) or g_slab != e_slab:
        raise AssertionError(f"{label}: graphed run differs from eager")
    return graphed, seen, g_slab


def w1_timing(label, run, steps: int) -> dict:
    """Graphed and eager (scan.eager()) in turns: ms/step (best of 3 calls
    ending in a host fetch), the host's kernel launch calls and the device
    operations a step (launches_per_step: a call's own set-up drops out),
    and the K1 / K2 slab launches a step of one call."""
    out = {}
    for form, ctx in (("graphed", contextlib.nullcontext),
                      ("eager", scan.eager)):
        with ctx():
            ms = best_ms_per_step(run, steps)
            per_step = launches_per_step(run)
            fst.sweep_a3.slab_launches = fst.sweep_b3.slab_launches = 0
            run(steps)
            torch.cuda.synchronize()
            slab = (fst.sweep_a3.slab_launches / steps,
                    fst.sweep_b3.slab_launches / steps)
        out[form] = {"ms_per_step": ms, **per_step, "slab_launches": slab}
    g, e = out["graphed"], out["eager"]
    print(f"{label}, NCCL world 1 ({roofline.card_line()}): graphed "
          f"{g['ms_per_step']:.4f} ms/step, eager {e['ms_per_step']:.4f}; "
          f"a step: host launch calls {g['launch_calls']:.2f} / "
          f"{e['launch_calls']:.2f}, device operations {g['kernels']:.2f} "
          f"/ {e['kernels']:.2f}, K1 / K2 slab launches "
          f"{g['slab_launches']} / {e['slab_launches']}", flush=True)
    return out


def world1_gather_grad(comm, scp) -> dict:
    """The gather path's value-and-grad at NCCL world size 1 on the padded
    biceps_full: make_sharded_simulate over PAR_GATHER_STEPS steps (stim
    off before PAR_GRAD_STIM_OFF), the PAR_GRAD_PARAMS overrides and the
    initial vel requiring grad, loss sum(pos * w): the graphed adjoint
    scan (its first call captures the forward step and the backward step,
    whose recompute holds the all_gathers and all_sums and their VJPs'
    collectives; a second call captures nothing) against the same call
    under scan.eager() bit for bit (hold_grads), then against one
    device's unfused adjoint (hold_grad_to_one_device). Graphed ms/step
    (best of 3 calls ending in a host fetch), eager ms/step, peak memory
    over the first call and over a replayed one, with the card."""
    from sph_sm_monodomain_tpu_torch.parallel import sharded_step as PS
    dev, steps = scp.state.device, PAR_GATHER_STEPS
    sim = PS.make_sharded_simulate(comm, scp.cfg, scp.neighbor_capacity,
                                   steps, PAR_GRAD_STIM_OFF)
    w = grad_weights(scp.state.capacity, dev)

    def vg():
        return gather_value_and_grad(
            lambda st, p: sim(PS.shard_state(st, comm), p)[0], scp.state, w)
    scan.clear_cache()
    seen = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with counting_all_captures(seen):
        t0 = time.perf_counter()
        first = vg()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first_peak = torch.cuda.max_memory_allocated(dev)
        captures = len(seen)
        torch.cuda.reset_peak_memory_stats(dev)
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = vg()
            float(again[0])
            best = min(best, time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
    if captures != 2 or len(seen) != captures:
        raise AssertionError(f"gather value-and-grad at world 1: {captures} "
                             f"captures on the first call, {len(seen)} "
                             "after four (want 2 and 2)")
    eager_s = []

    def timed_eager():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vg()
        float(res[0])
        eager_s.append(time.perf_counter() - t0)
        return res
    label = (f"gather path value-and-grad at NCCL world 1, biceps_full "
             f"padded to {scp.state.capacity} rows, {steps} steps")
    held = hold_grads(label, [first, again], timed_eager)
    if not held["bit_equal"]:
        raise AssertionError(f"{label}: graphed not bit for bit equal to "
                             "scan.eager()")
    one = hold_grad_to_one_device(label, first, scp, steps)
    out = {"steps": steps, "captures": captures, "first_call_s": first_s,
           "graphed_ms_per_step": best / steps * 1e3,
           "eager_ms_per_step": eager_s[0] / steps * 1e3,
           "peak_gib": peak / 2**30, "first_call_peak_gib":
           first_peak / 2**30, "held_before_gib": base / 2**30,
           "loss": float(first[0]), "grad_k_mu": [float(first[1]),
                                                  float(first[2])],
           "graphed_vs_eager": held, "vs_one_device": one}
    print(f"{label} ({roofline.card_line()}): graphed "
          f"{out['graphed_ms_per_step']:.4f} ms/step (best of 3; first call "
          f"{first_s:.3f} s with {captures} captures, forward and backward "
          f"step), eager {out['eager_ms_per_step']:.4f} ms/step; peak "
          f"allocated {out['peak_gib']:.4f} GiB over a replayed call, "
          f"{out['first_call_peak_gib']:.4f} over the first "
          f"({out['held_before_gib']:.4f} GiB held before it); loss "
          f"{out['loss']:.9g}, d/dK, d/dmu {out['grad_k_mu']}", flush=True)
    scan.clear_cache()
    return out


def halo_tool_row(tmp: Path) -> dict:
    """tools/halo_gpu.py --check on biceps_full x HALO_TOOL_ARGS[0] at world
    size 1 (NCCL), its row written to a scratch file and printed."""
    from sph_sm_monodomain_tpu_torch.tools import halo_gpu
    res = halo_gpu.main([*HALO_TOOL_ARGS, "--check", f"--row={tmp}/h.csv"])
    print(f"halo tool row: {res['row']}", flush=True)
    scan.clear_cache()
    return res


def nccl_world_one(dev, scp, x7) -> dict:
    """The three multi-device simulates over NCCL at world size 1 in this
    process, graphed (models/scan.run_steps): the fused slab on the padded
    biceps_full against one device bit for bit over PAR_PARITY_STEPS steps,
    then the PAR_STEPS protocol in chunks of PAR_CHUNK (stim off at half,
    as the command line runs it), the gather path PAR_GATHER_STEPS steps,
    the halo path on biceps_full xPAR_HALO_REPLICATE PAR_HALO_STEPS steps
    (every particle kept, overflow 0), each against its run under
    scan.eager() bit for bit; then graphed and eager timings and counts of
    the fused slab and the halo path."""
    from sph_sm_monodomain_tpu_torch.parallel import comm as C
    from sph_sm_monodomain_tpu_torch.parallel import halo_step as PH
    from sph_sm_monodomain_tpu_torch.parallel import sharded_step as PS
    probe = probe_nccl_capture()
    cfg, sq = scp.cfg, scp.sub_block
    comm = C.init(0, 1, "cuda", f"tcp://localhost:{C.free_port()}",
                  timeout_s=PAR_TIMEOUT_S)
    try:
        how = PS.run_loop(comm)[1]
        print(f"NCCL world 1: {comm.describe()}, run loop {how}",
              flush=True)
        if comm.transport != "nccl" or not how.startswith("graphed"):
            raise AssertionError(f"world 1: {comm.transport}, {how}")
        fused = lambda n, off: PS.make_sharded_simulate_fused(  # noqa: E731
            comm, cfg, n, off, sub_q=sq)
        st0 = PS.shard_state(scp.state, comm)

        # the fused slab: one device, 3 steps; the protocol
        (st3, _), _, _ = graphed_vs_eager(
            f"fused slab, {PAR_PARITY_STEPS} steps",
            lambda: fused(PAR_PARITY_STEPS, -1)(st0))
        one3 = T.simulate(scp.state, cfg, PAR_PARITY_STEPS, sub_q=sq)[0]
        diff = differing_fields(PS.gather_state(st3, comm), one3)
        print(f"fused slab at world 1 vs one device, {PAR_PARITY_STEPS} "
              f"steps: {'bit-equal' if not diff else diff}", flush=True)
        if diff:
            raise AssertionError("fused slab at world 1 differs from one "
                                 f"device: {diff}")
        scan.clear_cache()      # the protocol's first chunk captures
        t0 = time.perf_counter()
        (prot, _), prot_caps, prot_slab = graphed_vs_eager(
            f"fused slab protocol, {PAR_STEPS} steps in chunks of "
            f"{PAR_CHUNK}, stim off at {PAR_STEPS // 2}",
            lambda: par_chunks(fused, st0, PAR_STEPS, PAR_CHUNK,
                               PAR_STEPS // 2))
        prot_s = time.perf_counter() - t0
        if prot_slab != (PAR_STEPS, PAR_STEPS) or len(prot_caps) != 1:
            raise AssertionError(f"fused slab protocol: slab launches "
                                 f"{prot_slab}, captures {prot_caps}")
        check_in_world(prot, cfg, "fused slab protocol at world 1")
        def one_device(n, off):
            def chunk(st):
                st, aux = T.simulate(st, cfg, n, off, sub_q=sq)
                return st, aux.overflow
            return chunk
        one_prot = par_chunks(one_device, scp.state, PAR_STEPS, PAR_CHUNK,
                              PAR_STEPS // 2)[0]
        prot_bits = differing_fields(prot, one_prot)
        print(f"fused slab protocol at world 1 vs one device: "
              f"{'bit-equal' if not prot_bits else prot_bits}", flush=True)

        # the gather path
        (gst, govf), _, _ = graphed_vs_eager(
            f"gather path, {PAR_GATHER_STEPS} steps",
            lambda: PS.make_sharded_simulate(
                comm, cfg, scp.neighbor_capacity, PAR_GATHER_STEPS)(st0))
        if govf:
            raise AssertionError(f"gather path overflowed: {govf}")
        ggrad = world1_gather_grad(comm, scp)

        # the halo path on x7
        hst, s_cap, mig, halo = PH.shard_state_halo(
            x7.state, comm, x7.cfg, q_block=x7.sub_block)
        halo_sim = lambda n, off=-1: PH.make_halo_simulate(  # noqa: E731
            comm, x7.cfg, mig, halo, n, off, sub_q=x7.sub_block)
        (hend, hovf), _, hslab = graphed_vs_eager(
            f"halo path on biceps_full x{PAR_HALO_REPLICATE}, "
            f"{PAR_HALO_STEPS} steps (S, mig_cap, halo_cap = "
            f"{[s_cap, mig, halo]})", lambda: halo_sim(PAR_HALO_STEPS)(hst))
        act = hend.active
        ends, starts = (st.orig_pos[st.active].cpu().numpy()
                        for st in (hend, hst))
        kept = np.array_equal(ends[np.lexsort(ends.T)],
                              starts[np.lexsort(starts.T)])
        print(f"halo run at world 1: {int(act.sum())} of "
              f"{x7.num_particles} particles, every orig_pos kept {kept}, "
              f"overflow {int(hovf)}", flush=True)
        if int(hovf) or int(act.sum()) != x7.num_particles or not kept:
            raise AssertionError("halo run at world 1 lost particles or "
                                 "overflowed")
        check_fields_finite(hend, x7.cfg, "halo run at world 1")

        timing = {
            "fused_slab": w1_timing(
                "fused slab, biceps_full",
                lambda n: fused(n, -1)(st0), W1_TIMING_STEPS),
            f"halo_x{PAR_HALO_REPLICATE}": w1_timing(
                f"halo path, biceps_full x{PAR_HALO_REPLICATE}",
                lambda n: halo_sim(n)(hst), PAR_HALO_STEPS)}
        torch.cuda.synchronize()
    finally:
        C.shutdown()
    return {"transport": comm.transport, "run_loop": how,
            "gather_grad": ggrad,
            "capture_probe": probe, "protocol_wall_s": prot_s,
            "protocol_slab_launches": prot_slab,
            "protocol_vs_one_device": prot_bits or "bit-equal",
            "halo_slab_launches": hslab, "halo_caps": [s_cap, mig, halo],
            "timing": timing}


def phase_parallel(dev, report, times, bounds, launches) -> dict:
    """Phase 30: K1 / K2 slab launches against their plain versions, the
    three multi-device paths with PAR_RANKS ranks sharing the card, NCCL at
    world size 1, and the command line. Fills the slab kernels' entries
    of report / times / bounds / launches; returns the phase's numbers."""
    from sph_sm_monodomain_tpu_torch.parallel import comm as C
    from sph_sm_monodomain_tpu_torch.parallel import halo_step as PH
    t_phase = time.perf_counter()
    sc = T.build_scene("biceps_full", device=dev)
    scp = T.build_scene("biceps_full", device=dev,
                        pad_to=par_pad(sc.state.capacity, sc.sub_block))
    print(f"biceps_full padded to {scp.state.capacity} rows "
          f"({PAR_RANKS} ranks x whole {scp.sub_block}-row sub-blocks)",
          flush=True)
    errs, slab_times, slab_bounds = check_slab_kernels(dev, scp)
    gloo_cuda = probe_gloo_cuda()
    print(f"gloo collectives on CUDA tensors: {gloo_cuda}", flush=True)

    with tempfile.TemporaryDirectory() as tmpd:
        out = Path(tmpd)
        t0 = time.perf_counter()
        C.spawn(par_rank_main, PAR_RANKS, (str(out),), device_type="cuda",
                timeout_s=PAR_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        rk = [json.loads((out / f"rank{r}.json").read_text())
              for r in range(PAR_RANKS)]
        print(f"{PAR_RANKS} ranks on one card: {rk[0]['describe']}, run "
              f"loop {rk[0]['run_loop']}, ranks ran {ranks_s:.1f} s",
              flush=True)
        if any(not r["run_loop"].startswith("eager") for r in rk):
            raise AssertionError("ranks sharing the card must run eagerly")

        # the fused slab path: parity, protocol, counts
        n = scp.num_particles
        want, shuf = one_device_runs(
            lambda st: T.step_fused(st, scp.cfg, scp.sub_block)[0],
            scp.state, (1, PAR_PARITY_STEPS))
        worst = {k: hold_close(
            f"fused slab path, {k} step(s), {PAR_RANKS} ranks vs one device",
            _by_identity(torch.load(out / f"fused{k}.pt"))[0], want[k],
            shuf[k], PAR_FUSED_TOLS) for k in (1, PAR_PARITY_STEPS)}
        prot = torch.load(out / "protocol.pt")
        st_end = T.ParticleState(**{
            **{f.name: getattr(scp.state, f.name)
               for f in dataclasses.fields(scp.state)},
            **{k: v.to(dev) for k, v in prot.items()}})
        check_in_world(st_end, scp.cfg, "fused slab protocol")
        act = st_end.active
        if not bool((st_end.stim[act] == -10000.0).all()):
            raise AssertionError("fused slab protocol: stim not turned off")
        per_rank = [r["protocol"]["slab_launches"] for r in rk]
        full_form = [r["protocol"]["full_launches"] for r in rk]
        print(f"fused slab protocol: {PAR_STEPS} steps (stim off at "
              f"{PAR_STEPS // 2}) in {rk[0]['protocol']['wall_s']:.3f} s "
              f"wall; K1 / K2 slab launches per rank {per_rank}, "
              f"full-form launches {full_form}", flush=True)
        for r, (na, nb) in enumerate(per_rank):
            if (na, nb) != (PAR_STEPS, PAR_STEPS) or full_form[r] != [0, 0]:
                raise AssertionError(f"rank {r}: K1 / K2 slab launches "
                                     f"{(na, nb)}, want {PAR_STEPS} each")
        launches["sweep_a3_slab"] = sum(p[0] for p in per_rank)
        launches["sweep_b3_slab"] = sum(p[1] for p in per_rank)

        # the gather path
        g = torch.load(out / "gather.pt")
        if any(r["gather_overflow"] != [0] * PAR_GATHER_STEPS for r in rk):
            raise AssertionError("gather path overflowed")
        if not torch.isfinite(g["pos"][g["active"]]).all():
            raise AssertionError("gather path: non-finite positions")
        want, shuf = one_device_runs(
            lambda st: T.step(st, scp.cfg, scp.neighbor_capacity)[0],
            scp.state, (PAR_GATHER_STEPS,))
        gworst = hold_close(
            f"gather path, {PAR_GATHER_STEPS} steps, {PAR_RANKS} ranks vs "
            "one device's unfused step", _by_identity(g)[0],
            want[PAR_GATHER_STEPS], shuf[PAR_GATHER_STEPS], PAR_GATHER_TOLS)
        rgrad = torch.load(out / "grad.pt")
        per_rank = rgrad["params"]
        if not bool((per_rank == per_rank[0]).all()):
            raise AssertionError(f"ranks' override gradients differ: "
                                 f"{per_rank.tolist()}")
        got = [t.to(dev) for t in (rgrad["value"].float(), per_rank[0, 0],
                                   per_rank[0, 1], rgrad["vel"])]
        print(f"gather path value-and-grad, {PAR_RANKS} ranks sharing the "
              f"card ({PAR_GRAD_RANK_STEPS} steps, stim off before step "
              f"{PAR_GRAD_STIM_OFF}; {rk[0]['grad_s']:.3f} s on rank 0, "
              f"{roofline.card_line()}): "
              f"loss {float(got[0]):.9g}, every rank's d/dK, d/dmu "
              f"{per_rank.tolist()}", flush=True)
        ggrad = hold_grad_to_one_device(
            f"gather path value-and-grad, {PAR_RANKS} ranks sharing the card",
            got, scp, PAR_GRAD_RANK_STEPS)

        # the halo path on x7
        x7 = T.build_scene("biceps_full", replicate=PAR_HALO_REPLICATE,
                           device=dev)
        caps = rk[0]["halo_caps"]
        ovf = [r["halo_overflow"] for r in rk]
        if any(any(o) for o in ovf):
            raise AssertionError(f"halo path overflowed: {ovf}")
        h, n_h = _by_identity(torch.load(out / "halo.pt"))
        if n_h != x7.num_particles:
            raise AssertionError(f"halo path: {n_h} particles, want "
                                 f"{x7.num_particles}")
        want, shuf = one_device_runs(
            lambda st: T.step_fused(st, x7.cfg, x7.sub_block)[0],
            x7.state, (PAR_PARITY_STEPS,))
        herr = hold_close(
            f"halo path on biceps_full x{PAR_HALO_REPLICATE} "
            f"({x7.num_particles} particles, every one kept; S, mig_cap, "
            f"halo_cap = {caps}), {PAR_PARITY_STEPS} steps, {PAR_RANKS} "
            "ranks vs one device", h, want[PAR_PARITY_STEPS],
            shuf[PAR_PARITY_STEPS], PAR_HALO_TOLS)
        end = torch.load(out / "halo_end.pt")
        e, n_e = _by_identity(end)
        if n_e != x7.num_particles or not np.isfinite(e["pos"]).all():
            raise AssertionError(f"halo run: {n_e} particles or non-finite")
        lay, s0, _, _ = PH.halo_layout(x7.state, PAR_RANKS, x7.cfg,
                                       q_block=x7.sub_block)
        start = {k: torch.from_numpy(np.asarray(v)) for k, v in lay.items()
                 if k in PAR_FIELDS}
        rank0 = _by_identity({**start, "rank": torch.arange(
            start["active"].shape[0]) // s0})[0]["rank"]
        rank1 = _by_identity({**end, "rank": torch.arange(
            end["active"].shape[0]) // caps[0]})[0]["rank"]
        migrated = int((rank0 != rank1).sum())
        print(f"halo run: {PAR_HALO_STEPS} steps, every particle kept, "
              f"{migrated} particles ended on another rank than they "
              f"started on, overflow 0", flush=True)
        halo_k = check_halo_kernels(dev, out, x7.cfg, x7.sub_block)
        for name in errs:
            errs[name] = max(errs[name], halo_k[name])

    # the single device's ms/step on the same padded state, and NCCL at 1
    sm_inv = sm_invariants(scp.state, scp.cfg)
    holder = {"s": scp.state}

    def one():
        holder["s"], _ = T.step_fused(holder["s"], scp.cfg, scp.sub_block,
                                      sm_inv=sm_inv)
    for _ in range(3):
        one()
    one_ms = cuda_ms(one, PAR_TIMING_STEPS)
    nccl = nccl_world_one(dev, scp, x7)
    with tempfile.TemporaryDirectory() as tmpd:
        halo_tool = halo_tool_row(Path(tmpd))

    with tempfile.TemporaryDirectory() as tmpd:
        cli_runs = cli_par_runs(Path(tmpd))

    label = f"two ranks on one card ({roofline.card_line()})"
    ms = {"fused": rk[0]["fused_ms"], "gather": rk[0]["gather_ms"],
          f"halo_x{PAR_HALO_REPLICATE}": rk[0]["halo_ms"]}
    print(f"ms/step, {label}: fused slab {ms['fused']:.3f} (biceps_full), "
          f"gather {ms['gather']:.3f} (biceps_full), halo "
          f"{ms[f'halo_x{PAR_HALO_REPLICATE}']:.3f} (biceps_full "
          f"x{PAR_HALO_REPLICATE}); one device, no ranks: {one_ms:.3f} "
          "(biceps_full, CUDA events); K1 / K2 slab launches per step and "
          "rank: 1 each (fused and halo), 0 (gather). Not a multi-GPU "
          "speedup: both ranks share one card.", flush=True)
    for name in errs:
        report[name] = {"max_abs_err": errs[name]}
        times[name] = slab_times[name]
        bounds[name] = slab_bounds[name]
    phase_s = time.perf_counter() - t_phase
    print(f"phase 30 took {phase_s:.3f} s", flush=True)
    return {"label": label, "transport": rk[0]["transport"],
            "gloo_cuda": gloo_cuda, "ms_per_step": ms,
            "one_device_ms_per_step": one_ms,
            "fused_protocol_wall_s": rk[0]["protocol"]["wall_s"],
            "fused_parity": worst, "gather_parity": gworst,
            "gather_grad_ranks": {"wall_s": rk[0]["grad_s"], **ggrad},
            "halo_parity": herr, "halo_caps": caps, "migrated": migrated,
            "halo_kernel_ms": {k: v for k, v in halo_k.items()
                               if k.endswith("_ms")},
            "nccl_world1": nccl, "halo_tool": halo_tool,
            "cli_wall_s": {k: v[0] for k, v in cli_runs.items()},
            "phase_s": phase_s}


# --- phase 31: the compiled run loop (captured CUDA graphs) -----------------

# steps of each other generation's and mode's graphed-vs-eager run (chunks
# and stim-off of the protocol runs, the frame spacing of the mode runs);
# steps of the x56 run; steps of each timed call and of the profiled
# window; the command line's rendered run (steps, render spacing)
GEN_STEPS, GEN_CHUNK, GEN_STIM_OFF, GEN_FRAMES = 20, 10, 7, 5
GRAPH_BIG_STEPS, GRAPH_TIMING_STEPS, PROFILE_STEPS = 100, 100, 50
RENDER_STEPS, RENDER_EVERY = 300, 100


@contextlib.contextmanager
def eager_steps():
    """The drivers' steps run eagerly (models/scan.run_steps_eager, the
    same blocks without capture): the reference the graphed runs are held
    to, and the form whose host launches phase 27 counts."""
    with mock.patch.object(monodomain, "run_steps", scan.run_steps_eager), \
            mock.patch.object(variants, "run_steps", scan.run_steps_eager), \
            mock.patch.object(report_mod, "run_steps",
                              scan.run_steps_eager):
        yield


@contextlib.contextmanager
def counting_captures(seen: list):
    """Record the block length of every CUDA graph captured."""
    real = scan._Capture._capture

    def wrapped(self, step, length):
        seen.append(length)
        return real(self, step, length)
    with mock.patch.object(scan._Capture, "_capture", wrapped):
        yield


def differing_fields(a, b) -> dict:
    """{field: max abs difference} of the fields whose bits differ (bool
    fields as 1.0 where any differs)."""
    out = {}
    for f in FIELD_NAMES:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            same = torch.equal(x.view(torch.int32), y.view(torch.int32))
            if not same:
                out[f] = float((x - y).abs().max())
        elif not torch.equal(x, y):
            out[f] = 1.0
    return out


def first_unrepeatable_stage(sc) -> str:
    """The first stage of one fused v4 step from sc.state whose output
    differs between two runs of it (the bookkeeping, shape matching, sweep
    A, sweep B), or "none"."""
    st, cfg, sq = sc.state, sc.cfg, sc.sub_block
    inv = sm_invariants(st, cfg)

    def stages():
        order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active,
                                                       cfg, sq)
        s2 = corrected_velocity(st, cfg, sm_inv=inv)
        fs, fa = fst.build_qm_feats(s2, cx, cyz, order)
        oa = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sq)
        ob = fst.sweep_b3(oa, fst.feats_b(oa), lo, hi, cfg, sub_q=sq)
        return {"sort + window bookkeeping": torch.cat(
                    [order.double(), lo.double(), hi.double()]),
                "shape matching (corrected_velocity)": s2.corrected_vel,
                "sweep A (K1)": oa, "sweep B (K2)": ob}
    a, b = stages(), stages()
    for k in a:
        if not torch.equal(a[k], b[k]):
            return k
    return "none"


def hold_to_eager(what, graphed, eager1, eager2, stage=None) -> dict:
    """The graphed run against two eager runs of the same protocol: bit
    for bit where the two eager runs agree bit for bit, else within twice
    their spread per field, naming the stage that does not repeat."""
    spread = differing_fields(eager1, eager2)
    got = differing_fields(graphed, eager1)
    if not spread:
        print(f"{what}: eager runs bit-equal; graphed vs eager "
              f"{'bit-equal' if not got else got}", flush=True)
        if got:
            raise AssertionError(f"{what}: graphed run differs from the "
                                 f"eager loop: {got}")
        return {"bit_equal": True}
    cause = stage() if stage is not None else "not traced"
    print(f"{what}: two eager runs differ {spread} (first unrepeatable "
          f"stage: {cause}); graphed vs eager {got}", flush=True)
    bad = {f: v for f, v in got.items() if v > 2.0 * spread.get(f, 0.0)}
    if bad:
        raise AssertionError(f"{what}: graphed beyond twice the eager "
                             f"spread: {bad}")
    return {"bit_equal": False, "eager_spread": spread, "diff": got,
            "unrepeatable": cause}


def eager_v4_protocol(sc, steps: int, stim_off: int):
    """The protocol as a plain Python loop of step_fused on the card."""
    cfg = sc.cfg
    st = scan.copy_state(sc.state)
    inv = sm_invariants(st, cfg)
    for i in range(steps):
        if i == stim_off:
            st = T.stim.turn_off_stim(st, cfg)
        st = T.step_fused(st, cfg, sc.sub_block, sm_inv=inv)[0]
    return st


def graph_vs_eager_protocol(label, sc, names, **kw) -> dict:
    """run_protocol(sc, **kw) graphed, then twice eagerly: exact launch
    counts (the steps each run ran), captures, and the runs held to each
    other."""
    seen = []
    with counting_captures(seen):
        st_g, aux_g, _, got, calls, wall = counted_protocol(sc, names, **kw)
    ran = sum(n for _, n in calls)
    eager = []
    for _ in range(2):
        with eager_steps():
            st_e, aux_e, _, got_e, calls_e, wall_e = counted_protocol(
                sc, names, **kw)
        eager.append(st_e)
    print(f"{label}: graphed {ran} steps in {wall:.3f} s (simulate calls "
          f"(pack_cap, steps) {calls}, captures of {seen} steps), launches "
          f"{got}; eager {wall_e:.3f} s, launches {got_e}", flush=True)
    if calls != calls_e or got != got_e \
            or any(n != ran for n in got.values()):
        raise AssertionError(f"{label}: launches {got} / eager {got_e} for "
                             f"{ran} steps, calls {calls} / {calls_e}")
    if int(aux_g.overflow) != int(aux_e.overflow):
        raise AssertionError(f"{label}: overflow differs")
    check_fields_finite(st_g, sc.cfg, f"{label} graphed")
    return {"steps_run": ran, "simulate_calls": calls, "captures": seen,
            "launches": got, "graphed_s": wall, "eager_s": wall_e,
            **hold_to_eager(label, st_g, *eager)}


def graph_vs_eager_mode(label, run, names) -> dict:
    """A mode driver `run()` -> (state, frames) graphed, then twice
    eagerly; exact launch counts (equal in both forms), frames bit for bit
    beside the state."""
    def counted():
        for nm in names:
            getattr(KERNEL_MODULE[nm], nm).launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, frames = run()
        torch.cuda.synchronize()
        return (st, frames, {nm: getattr(KERNEL_MODULE[nm], nm).launches
                             for nm in names}, time.perf_counter() - t0)

    seen = []
    with counting_captures(seen):
        st_g, fr_g, got, wall = counted()
    with eager_steps():
        (st_1, fr_1, got_e, wall_e), (st_2, _, _, _) = counted(), counted()
    print(f"{label}: graphed {wall:.3f} s (captures of {seen} steps), "
          f"launches {got}; eager {wall_e:.3f} s, launches {got_e}",
          flush=True)
    if got != got_e:
        raise AssertionError(f"{label}: launches {got}, eager {got_e}")
    if not all(torch.equal(a, b) for a, b in zip(fr_g, fr_1)) \
            or len(fr_g) != len(fr_1):
        raise AssertionError(f"{label}: graphed frames differ from eager")
    return {"captures": seen, "launches": got, "graphed_s": wall,
            "eager_s": wall_e, **hold_to_eager(label, st_g, st_1, st_2)}


def profile_window(run, steps: int, top: int = 0) -> dict:
    """Per step of run(steps) under torch.profiler, after a warm call: the
    host's kernel launch calls and graph launches, the kernels the device
    ran, the union of their intervals (busy), the span from the first
    kernel's start to the last one's end, the device's idle share of that
    span, the profiled window's host wall (the profiler's cost
    included), and the `top` kernels by device time (name, ms a step,
    launches a step)."""
    run(steps)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ev = prof.key_averages()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - spans[0][0] if spans else 0.0
    return {"launch_calls": sum(e.count for e in ev
                                if e.key in LAUNCH_CALLS) / steps,
            "graph_launches": sum(e.count for e in ev
                                  if e.key == "cudaGraphLaunch") / steps,
            "kernels": len(spans) / steps,
            "busy_ms": busy / 1e3 / steps, "span_ms": span / 1e3 / steps,
            "idle_share": 1.0 - busy / span if span > 0 else None,
            "window_ms": window * 1e3 / steps,
            "top_kernels": [
                (e.key[:70], e.self_device_time_total / 1e3 / steps,
                 e.count / steps)
                for e in sorted((e for e in ev if e.device_type
                                 == torch.autograd.DeviceType.CUDA),
                                key=lambda e: -e.self_device_time_total)[
                                    :top]]}


def cli_render_frames(tmp: Path) -> dict:
    """The command line on biceps_full with --render-every on the card:
    the frames it renders differ chunk to chunk (the render hook keeps
    copies)."""
    kept = []

    def keep(states, *a, **kw):
        kept.extend(states)
        return []
    with mock.patch.object(render_mod, "render_frames", keep):
        rc, _, _, wall = run_cli(
            ["--scene", "biceps_full", "--steps", str(RENDER_STEPS),
             "--chunk", str(RENDER_EVERY), "--render-every",
             str(RENDER_EVERY), "--render-dir", str(tmp / "frames")])
    moved = [float((b.pos - a.pos).abs().max())
             for a, b in zip(kept, kept[1:])]
    print(f"cli --render-every {RENDER_EVERY}: rc {rc}, {len(kept)} frames "
          f"kept (device {kept[0].pos.device if kept else None}), largest "
          f"move between consecutive frames {moved}", flush=True)
    if rc != 0 or len(kept) != RENDER_STEPS // RENDER_EVERY \
            or not all(m > 0 for m in moved):
        raise AssertionError("cli rendered frames do not differ chunk to "
                             "chunk")
    return {"frames": len(kept), "moved": moved, "wall_s": wall}


def phase_graph(dev, scene, x7, big) -> dict:
    """Phase 31: the compiled run loop, graphed against eager."""
    out = {}
    cfg, sq = scene.cfg, scene.sub_block
    # A. the main path: 500 biceps_full v4 steps, graphed, against the
    # eager loop of step_fused
    before = scan.copy_state(scene.state)
    seen = []
    with counting_captures(seen):
        st_g, aux_g, _, got, calls, wall = counted_protocol(
            scene, ("sweep_a3", "sweep_b3"), num_steps=STEPS, chunk=CHUNK)
    print(f"v4 run_protocol({STEPS}, chunk {CHUNK}) graphed: {wall:.3f} s "
          f"wall, launches {got}, simulate calls {calls}, captures of {seen} "
          "steps", flush=True)
    if got != {"sweep_a3": STEPS, "sweep_b3": STEPS} or seen != [1]:
        raise AssertionError(f"v4 graphed run: launches {got}, captures "
                             f"{seen}")
    check_protocol_run(st_g, aux_g, cfg, "graphed run_protocol")
    if differing_fields(scene.state, before):
        raise AssertionError("run_protocol changed scene.state")
    mem = {t.untyped_storage().data_ptr() for t in scan._leaves(scene.state)}
    if mem & {t.untyped_storage().data_ptr() for t in scan._leaves(st_g)}:
        raise AssertionError("the graphed run shares memory with "
                             "scene.state")
    t0 = time.perf_counter()
    eager = [eager_v4_protocol(scene, STEPS, STEPS // 2) for _ in range(2)]
    torch.cuda.synchronize()
    eager_wall = (time.perf_counter() - t0) / 2
    out["v4_protocol"] = {
        "graphed_s": wall, "eager_s": eager_wall, "launches": got,
        "captures": seen, **hold_to_eager(
            f"v4 {STEPS} steps", st_g, *eager,
            stage=lambda: first_unrepeatable_stage(scene))}
    del st_g, eager

    # B. the other generations, GEN_STEPS each in chunks of GEN_CHUNK
    kw = dict(num_steps=GEN_STEPS, chunk=GEN_CHUNK,
              stim_off_step=GEN_STIM_OFF)
    sc5 = T.build_scene("biceps_full", fused_impl="v5", device=dev)
    low = max(128, sc5.pack_cap // 2 // 128 * 128)
    gens = {"v3": (T.build_scene("biceps_full", fused_impl="v3",
                                 device=dev),
                   ("sweep_a3_hash9", "sweep_b3_hash9"), {}),
            "v5_regrow": (sc5._replace(pack_cap=low),
                          ("sweep_a5", "sweep_b5"), {}),
            "v1": (T.build_scene("biceps_full", fused_impl="v1", device=dev),
                   ("sweep_a", "sweep_b"), {}),
            "v2": (T.build_scene("biceps_full", fused_impl="v2", device=dev),
                   ("sweep_a2", "sweep_b2"), {}),
            "unfused": (scene, (), {"fused": False})}
    out["generations"] = {}
    for label, (sc, names, extra) in gens.items():
        r = graph_vs_eager_protocol(label, sc, names, **kw, **extra)
        if label == "v5_regrow" and not (r["simulate_calls"][0][0] == low
                                         < r["simulate_calls"][-1][0]
                                         and len(r["captures"]) >= 2):
            raise AssertionError(f"v5 from pack_cap {low} did not regrow "
                                 "and recapture")
        out["generations"][label] = r

    # C. the modes
    sph_cfg = variants.sph_only_config(cfg)
    mtab = variants.monodomain_prepare_fused(scene.state, cfg, sub_q=sq)
    modes = {
        "sm_only": (lambda: (lambda r: (r[0], r[2]))(
            variants.simulate_sm_only(scene.state, cfg, GEN_STEPS,
                                      record_every=GEN_FRAMES)),
            ("sweep_a3",)),
        "sph_only_fused": (lambda: (lambda r: (r[0], r[2]))(
            variants.simulate_sph_only(
                scene.state, sph_cfg, scene.neighbor_capacity, GEN_STEPS,
                record_every=GEN_FRAMES, fused=True, sub_q=sq)),
            ("sweep_a3", "sweep_b3")),
        "monodomain_fused": (lambda: (lambda r: (r[0], (r[1],)))(
            variants.simulate_monodomain_only_fused(
                scene.state, mtab, cfg, GEN_STEPS, record_every=GEN_FRAMES,
                sub_q=sq)), ("sweep_lap3",))}
    want = {"sm_only": {"sweep_a3": 0},
            "sph_only_fused": {"sweep_a3": GEN_STEPS, "sweep_b3": GEN_STEPS},
            "monodomain_fused": {"sweep_lap3": GEN_STEPS}}
    out["modes"] = {}
    for label, (run, names) in modes.items():
        r = graph_vs_eager_mode(label, run, names)
        if r["launches"] != want[label]:
            raise AssertionError(f"{label}: launches {r['launches']}, want "
                                 f"{want[label]}")
        out["modes"][label] = r

    # D. biceps_full x56 coupled, with the peak memory of the graphed run
    # and the graph pool's peak as hbm_footprint --scan measures it
    scan.clear_cache()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    st_b, aux_b, _, got, calls, wall = counted_protocol(
        big, ("sweep_a3", "sweep_b3"), num_steps=GRAPH_BIG_STEPS,
        chunk=GRAPH_BIG_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"x{REPLICATE}: run_protocol({GRAPH_BIG_STEPS}) graphed in "
          f"{wall:.3f} s, launches {got}, overflow {int(aux_b.overflow)}, "
          f"peak {(peak - base) / 2**30:.4f} GiB above the "
          f"{base / 2**30:.4f} GiB held", flush=True)
    if got != {"sweep_a3": GRAPH_BIG_STEPS, "sweep_b3": GRAPH_BIG_STEPS} \
            or int(aux_b.overflow):
        raise AssertionError(f"x{REPLICATE} graphed: launches {got}")
    check_fields_finite(st_b, big.cfg, f"x{REPLICATE} graphed")
    del st_b
    scan.clear_cache()
    pools = {}
    for label, sc in (("biceps_full", scene), (f"x{REPLICATE}", big)):
        held = torch.cuda.memory_allocated(dev)
        res, pk = hbm_footprint.footprint(sc, scan=GRAPH_BIG_STEPS,
                                          donate=True)
        pools[label] = {"resident": res - held, "peak": pk - held,
                        "bytes_per_particle": (pk - held) / sc.num_particles}
    print(f"hbm_footprint --scan {GRAPH_BIG_STEPS} --donate: {pools}",
          flush=True)
    out["x56"] = {"wall_s": wall, "launches": got,
                  "peak_above_held": peak - base, "footprint_scan": pools}

    # E. ms/step graphed and eager, in turns, and a profiled window each
    runs = {
        "biceps_full": lambda k: T.simulate(scene.state, cfg, k, sub_q=sq),
        "x7": lambda k: T.simulate(x7.state, x7.cfg, k),
        f"x{REPLICATE}": lambda k: T.simulate(big.state, big.cfg, k),
        f"sm_only_x{REPLICATE}": lambda k: variants.simulate_sm_only(
            big.state, big.cfg, k),
        "monodomain_fused": lambda k: (
            variants.simulate_monodomain_only_fused(scene.state, mtab, cfg,
                                                    k, sub_q=sq),)}
    timing = {}
    for label, run in runs.items():
        g1 = best_ms_per_step(run, GRAPH_TIMING_STEPS)
        with eager_steps():
            e1 = best_ms_per_step(run, GRAPH_TIMING_STEPS)
        g2 = best_ms_per_step(run, GRAPH_TIMING_STEPS)
        timing[label] = {"graphed_ms": [g1, g2], "eager_ms": e1}
        print(f"{label}: ms/step graphed {g1:.4f} / {g2:.4f}, eager "
              f"{e1:.4f} (best of 3 x {GRAPH_TIMING_STEPS} steps, each "
              "call ending in a host fetch)", flush=True)
        scan.clear_cache()
    prof = {"graphed": profile_window(runs["biceps_full"], PROFILE_STEPS)}
    with eager_steps():
        prof["eager"] = profile_window(runs["biceps_full"], PROFILE_STEPS)
    print(f"biceps_full v4, per step over a profiled {PROFILE_STEPS}-step "
          f"window: {prof}", flush=True)
    out["timing"] = {"card": roofline.card_line(), "ms_per_step": timing,
                     "profile": prof}

    # F. the command line's rendered frames after a graphed run
    with tempfile.TemporaryDirectory() as tmp:
        out["cli_frames"] = cli_render_frames(Path(tmp))
    scan.clear_cache()
    return out


@contextlib.contextmanager
def counting_all_captures(seen: list):
    """Record every CUDA graph models/scan.py captures, forward block or
    backward step."""
    real = scan._capture

    def wrapped(body, pool):
        seen.append(body)
        return real(body, pool)
    with mock.patch.object(scan, "_capture", wrapped):
        yield


def checkpoint_rollout(scene, sm_inv, log_theta, steps: int, snaps: int,
                       fused: bool):
    """The flagship's displacement snapshots from a Python loop of its step
    under torch.utils.checkpoint (the fit's rollout before the adjoint
    scan): the reference phase 32 holds the adjoint scan to."""
    from torch.utils.checkpoint import checkpoint
    params = {"k_stiffness": torch.exp(log_theta[0]),
              "mu_viscosity": torch.exp(log_theta[1])}
    cfg = scene.cfg

    def body(s):
        if fused:
            return T.step_fused_diff(s, cfg, scene.sub_block, sm_inv=sm_inv,
                                     params=params)
        return T.step(s, cfg, scene.neighbor_capacity, sm_inv=sm_inv,
                      params=params)[0]

    s, disp = scene.state, []
    for _ in range(snaps):
        for _ in range(steps // snaps):
            s = checkpoint(body, s, use_reentrant=False,
                           preserve_rng_state=False)
        disp.append(fit.displacement(s))
    return torch.stack(disp)


def hold_grads(what, graphed: list, eager_run, ref=None) -> dict:
    """Value-and-grad results ([value, grad, ...] each) of the graphed
    adjoint against eager ones (`eager_run()` under scan.eager()): two
    eager runs, and where they differ in any bit two more. Each graphed
    result must lie within twice the eager runs' spread (their largest
    pairwise difference, per output) of their mean: bit for bit where they
    agree. The first eager run is held to `ref` within GRAD_RTOL
    (relative, per element)."""
    with scan.eager():
        eager = [eager_run(), eager_run()]
        if any(not torch.equal(a, b) for a, b in zip(*eager)):
            eager += [eager_run(), eager_run()]
    outs = list(zip(*eager))
    spread = [max(float((a - b).abs().max()) for a in xs for b in xs)
              for xs in outs]
    center = [xs[0] + torch.stack([x - xs[0] for x in xs]).mean(0)
              for xs in outs]
    diffs = [[float((a - c).abs().max()) for a, c in zip(g, center)]
             for g in graphed]
    rel = None
    if ref is not None:
        rel = max(float(((a - b).abs() / b.abs()).max())
                  for a, b in zip(eager[0], ref))
    print(f"{what}: {len(eager)} eager adjoint runs, spread {spread} (max "
          f"abs per output); graphed calls vs their mean {diffs}"
          + ("" if rel is None else f"; eager adjoint vs the "
             f"torch.utils.checkpoint loop max rel {rel:.3g} (tolerance "
             f"{GRAD_RTOL:g})"), flush=True)
    for d in diffs:
        if any(x > 2.0 * sp for x, sp in zip(d, spread)):
            raise AssertionError(f"{what}: graphed adjoint beyond twice the "
                                 f"eager spread: {d} vs {spread}")
    if rel is not None and not rel <= GRAD_RTOL:
        raise AssertionError(f"{what}: adjoint vs checkpoint loop {rel}")
    if not all(bool(torch.isfinite(x).all()) for x in eager[0]):
        raise AssertionError(f"{what}: non-finite value or gradient")
    return {"eager_runs": len(eager), "eager_spread": spread,
            "graphed_vs_eager": diffs, "bit_equal": not any(spread)
            and not any(map(any, diffs)), "vs_checkpoint_loop_rel": rel}


def grad_profile(scene, inv, th0, steps: int = 20) -> dict:
    """profile_window over one graphed value-and-grad of a `steps`-step
    fused flagship rollout (one snapshot): per step, what the device ran
    in the forward and the backward graphs, and the largest kernels."""
    target = torch.zeros((1,) + tuple(scene.state.pos.shape),
                         device=scene.state.pos.device)
    loss = fit.make_loss(scene, inv, target, steps, 1)
    res = profile_window(lambda n: fit.value_and_grad(loss, th0), steps,
                         top=8)
    print(f"value-and-grad of {steps} fused steps under torch.profiler, per "
          f"step: {res['kernels']:.1f} kernels, {res['busy_ms']:.4f} ms "
          f"busy in a {res['span_ms']:.4f} ms span (idle share "
          f"{res['idle_share']}), {res['launch_calls']:.1f} launch "
          f"calls and {res['graph_launches']:.2f} graph launches; largest "
          f"kernels (name, ms a step, launches a step) "
          f"{res['top_kernels']}", flush=True)
    return res


def gather_backward_s(scene) -> dict:
    """Wall seconds of one gather of a field through the unfused step's
    neighbor table on `scene` and its backward (an index_put with
    accumulation): with the table's own indices, every masked slot on
    particle 0, and with ops/sph.gather_index's, whose masked slots read
    their query's row."""
    from sph_sm_monodomain_tpu_torch.ops.grid import build_neighbor_table
    from sph_sm_monodomain_tpu_torch.ops.sph import gather_index
    st = scene.state
    nbr = build_neighbor_table(st.pos, st.pos, st.active, scene.cfg,
                               scene.neighbor_capacity)
    src = st.vm.detach().clone().requires_grad_()
    spread = gather_index(nbr)
    cot = torch.ones(spread.shape, device=src.device)
    torch.autograd.grad(src[spread], src, cot)          # warm-up
    out = {}
    for name, idx in (("gather_index", spread),
                      ("table_index", nbr.idx.long())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (g,) = torch.autograd.grad(src[idx], src, cot)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        out[f"{name}_grad_sum"] = float(g.sum())
    print(f"one gather through the unfused table, forward and backward: "
          f"{out['gather_index']:.4f} s with gather_index, "
          f"{out['table_index']:.4f} s with the table's own indices "
          f"({int((~nbr.mask).sum())} of {nbr.mask.numel()} slots masked)",
          flush=True)
    return out


def phase_grad(dev, scene) -> dict:
    """Phase 32: the compiled gradient paths on biceps_full."""
    cfg = scene.cfg
    inv = sm_invariants(scene.state, cfg)
    th_true = fit.theta_of(fit.TRUE_K, fit.TRUE_MU, dev)
    th0 = fit.theta_of(*fit.THETA0, dev)
    out = {}
    for label, fused, steps, snaps in (
            ("flagship_fused", True, FLAG_VG_STEPS, FLAG_SNAPS),
            ("flagship_unfused", False, FLAG_UNFUSED_STEPS,
             FLAG_UNFUSED_SNAPS)):
        scan.clear_cache()
        with torch.no_grad():
            target = fit.rollout_disp(scene, inv, th_true, steps, snaps,
                                      fused)
        loss = fit.make_loss(scene, inv, target, steps, snaps, fused)

        def vg():
            return list(fit.value_and_grad(loss, th0))

        for name, _, _, mod in KERNELS:
            getattr(mod, name).launches = 0
        seen = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with counting_all_captures(seen):
            first = vg()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            # the first call's peak: its eager warm-up step and the
            # capture, whose graph pool the cache then holds
            first_peak = torch.cuda.max_memory_allocated(dev)
            held = torch.cuda.memory_allocated(dev)
            got = {name: getattr(mod, name).launches
                   for name, _, _, mod in KERNELS}
            want = {name: 0 for name, _, _, _ in KERNELS}
            if fused:
                want.update(sweep_a3=2 * steps, sweep_b3=2 * steps,
                            sweep_bwd_a=steps, sweep_bwd_b=steps)
            if got != want:
                raise AssertionError(f"{label}: launches {got}, want {want}")
            captures = len(seen)
            torch.cuda.reset_peak_memory_stats(dev)
            best = float("inf")
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = vg()
                float(again[0])
                best = min(best, time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated(dev)
        if len(seen) != captures:
            raise AssertionError(f"{label}: a replayed call captured anew")
        eager_s = []

        def timed_eager():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = vg()
            float(res[0])
            eager_s.append(time.perf_counter() - t0)
            return res
        ref = fit.value_and_grad(
            lambda lt: fit.misfit(checkpoint_rollout(scene, inv, lt, steps,
                                                     snaps, fused), target),
            th0)
        out[label] = {
            "steps": steps, "snapshots": snaps, "captures": captures,
            "first_call_s": first_s, "launches": {k: v for k, v in
                                                  got.items() if v},
            "graphed_ms_per_step": best / steps * 1e3,
            "peak_gib": peak / 2**30, "held_before_gib": base / 2**30,
            "first_call_peak_gib": first_peak / 2**30,
            "held_after_first_gib": held / 2**30,
            "loss": float(first[0]), "grad": first[1].tolist(),
            **hold_grads(label, [first, again], timed_eager, list(ref))}
        out[label]["eager_ms_per_step"] = eager_s[0] / steps * 1e3
        print(f"{label}: {steps} steps, value-and-grad graphed "
              f"{out[label]['graphed_ms_per_step']:.4f} ms/step (best of 3; "
              f"first call {first_s:.3f} s with {captures} captures), eager "
              f"{out[label]['eager_ms_per_step']:.4f} ms/step; peak "
              f"allocated {peak / 2**30:.4f} GiB over a replayed call, "
              f"{first_peak / 2**30:.4f} over the first ({base / 2**30:.4f}"
              f" GiB held before it, {held / 2**30:.4f} after it); "
              f"launches {out[label]['launches']}; loss "
              f"{out[label]['loss']:.9g}, grad {out[label]['grad']}",
              flush=True)
        if fused:
            out["profile"] = grad_profile(scene, inv, th0)
    scan.clear_cache()
    out["gather_backward_s"] = gather_backward_s(scene)

    with torch.no_grad():
        target = fit.rollout_disp(scene, inv, th_true, FLAG_STEPS, FLAG_SNAPS)
    loss = fit.make_loss(scene, inv, target, FLAG_STEPS, FLAG_SNAPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log_theta, losses, _ = fit.adam_fit(loss, th0, FIT_ITERS,
                                        log=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    k_fit, mu_fit = torch.exp(log_theta).tolist()
    losses = [float(v) for v in losses]
    out["fit"] = {"steps": FLAG_STEPS, "iters": FIT_ITERS, "losses": losses,
                  "k": k_fit, "mu": mu_fit,
                  "wall_s": time.perf_counter() - t0}
    print(f"graphed fit, {FLAG_STEPS} steps, {FIT_ITERS} Adam iterations: "
          f"losses {losses}, K {k_fit:.6g}, mu {mu_fit:.6g}, "
          f"{out['fit']['wall_s']:.3f} s", flush=True)
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("graphed fit: the loss did not fall")
    scan.clear_cache()

    t0 = time.perf_counter()
    stim = fit_stimulus_demo.main(["4", "3"])
    mat = fit_material_demo.main(["6", "100"])
    fst.sweep_lap3.launches = 0
    demo = fhn.main(["biceps_full", str(FHN_STEPS), str(FHN_ITERS),
                     "--device", str(dev)])
    lap = fst.sweep_lap3.launches
    out["demos"] = {"stimulus_err": stim["err"],
                    "material_err_k": mat["err_k"],
                    "material_err_mu": mat["err_mu"], "fhn_err": demo["err"],
                    "fhn_lap_launches": lap,
                    "wall_s": time.perf_counter() - t0}
    print(f"demos through the graphed adjoint: {out['demos']}", flush=True)
    if not (stim["err"] < 0.01 and max(mat["err_k"], mat["err_mu"]) < 0.2
            and demo["err"] <= 0.01
            and lap == 1 + FHN_STEPS + FHN_ITERS * 3 * FHN_STEPS):
        raise AssertionError(f"demos: {out['demos']}")
    scan.clear_cache()

    def sim_vg():
        th = fit.theta_of(0.6, 80.0, dev).requires_grad_()
        st = T.simulate(scene.state, cfg, SIM_GRAD_STEPS, fused=False,
                        neighbor_capacity=scene.neighbor_capacity,
                        params={"k_stiffness": torch.exp(th[0]),
                                "mu_viscosity": torch.exp(th[1])})[0]
        val = (fit.displacement(st) ** 2).sum() * 1e6
        return [val.detach(), *torch.autograd.grad(val, th)]

    graphed = [sim_vg(), sim_vg()]
    out["simulate_unfused"] = {"steps": SIM_GRAD_STEPS,
                               **hold_grads("simulate(fused=False) under "
                                            "grad", graphed, sim_vg)}
    scan.clear_cache()
    return out


# --- phase 33: the main path against the committed JAX trajectory ----------

def phase_trajectory() -> None:
    """Phase 33: tools/trajectory_parity.py on the card (the graphed
    run_protocol from both starts, runs of LAP_STEP and STEPS steps) with
    exact K1 / K2 counts; every field's ratio printed, none above 1."""
    tp = trajectory_parity
    want = len(tp.STARTS) * (tp.LAP_STEP + sum(tp.STEPS))
    fst.sweep_a3.launches = 0
    fst.sweep_b3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tp.check("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sweep_a3": fst.sweep_a3.launches,
                "sweep_b3": fst.sweep_b3.launches}
    print(f"trajectory: {want} steps run in {wall:.3f} s wall, launches "
          f"{launches}", flush=True)
    if launches != {"sweep_a3": want, "sweep_b3": want}:
        raise AssertionError(f"trajectory launches {launches}, want {want}")
    if not tp.report(res) <= 1.0:
        raise AssertionError("trajectory: the card left the JAX trajectory")


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
    # value-and-grad (the checkpointed adjoint scan) one forward sweep per
    # step, and per step of its backward pass one recomputed forward and
    # one backward sweep (the backward step is one graph for every step,
    # the first one's too)
    want = {"sweep_a3": 1,
            "sweep_lap3": 1 + FHN_STEPS + FHN_ITERS * 3 * FHN_STEPS}
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
    phase(f"24 multi-muscle coupled step: biceps_full x7 and x{REPLICATE}, "
          "cluster ids, forms, run_protocol, the independent-run oracle")
    t0 = time.perf_counter()
    x7 = T.build_scene("biceps_full", replicate=7, device=dev)
    torch.cuda.synchronize()
    print(f"biceps_full x7: {x7.num_particles} particles, built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    multi = phase_multi_muscle(dev, scene, {7: x7, REPLICATE: big})
    phase(f"25 susane x{SMALL_REPLICATE}: {SMALL_STEPS} coupled and "
          f"{SMALL_STEPS} SM-only steps, card against CPU")
    phase_small_replicate(dev)
    phase(f"26 SM-only on biceps_full x{REPLICATE}, {SM_BIG_STEPS} steps")
    sm_big = phase_sm_only_big(big)
    phase("27 timing: coupled x7, coupled and SM-only "
          f"x{REPLICATE}; peak memory; launches per step")
    multi_timing = phase_multi_timing(dev, big, x7)
    phase("28 demos: contraction_demo, fit_stimulus_demo, fit_material_demo")
    demos = phase_demos()
    phase("29 the command line on biceps_full: coupled with report, "
          "profile, trajectory and checkpoint; resume; the modes; the tools")
    t0 = time.perf_counter()
    cli_out = phase_cli(dev)
    cli_out["phase_s"] = time.perf_counter() - t0
    print(f"phase 29 took {cli_out['phase_s']:.3f} s", flush=True)
    phase(f"30 multi-device: K1 / K2 on slabs of rows, the fused slab, "
          f"gather and halo paths with {PAR_RANKS} ranks on the card, the "
          "three simulates graphed over NCCL at world size 1, the gather "
          "path's value-and-grad, the halo pricing tool, the command line "
          "with --devices")
    par = phase_parallel(dev, report, times, bounds, launches)
    phase("31 graph: the compiled run loop (captured CUDA graphs) against "
          "eager runs; launch counts from replays; timing and idle share")
    t0 = time.perf_counter()
    graph = phase_graph(dev, scene, x7, big)
    graph["phase_s"] = time.perf_counter() - t0
    print(f"phase 31 took {graph['phase_s']:.3f} s", flush=True)
    phase("32 grad: the compiled gradient paths (the checkpointed adjoint "
          "scan's captured graphs) on biceps_full")
    t0 = time.perf_counter()
    grad = phase_grad(dev, scene)
    grad["phase_s"] = time.perf_counter() - t0
    print(f"phase 32 took {grad['phase_s']:.3f} s", flush=True)
    phase("33 trajectory: the main path on biceps_full against the "
          "committed JAX trajectory, from the scene as built and from a "
          "seeded vm field")
    t0 = time.perf_counter()
    phase_trajectory()
    print(f"phase 33 took {time.perf_counter() - t0:.3f} s", flush=True)

    library = {"sweep_lap3": spmv_ms}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name)}
        for name, source, replaces, _ in KERNELS + SLAB_KERNELS],
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
                      "peak_gib": big_peak / 2**30},
        "multi_muscle": {**multi, "sm_only": sm_big,
                         "timing": multi_timing},
        "demos": demos, "cli": cli_out, "parallel": par,
        "graph": graph, "grad": grad}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
