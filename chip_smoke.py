"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's two paths on the card at the full width of
`build_scene("biceps_full")` (18,475 particles): the chunked `run_protocol`
of the v4 fused step, through the two hand-written CUDA sweep kernels, and
the flagship (K, mu) material fit through the differentiable step, whose
backward pass runs the two hand-written backward sweep kernels. Phases,
each printing its lines; any failure raises and exits non-zero:

  1. device   needs torch.cuda; prints the card's name and power limit
  2. build    nvcc builds csrc/*.cu, one process per source (timed, with
              ptxas usage)
  3. kernels  the sort + window bookkeeping on the card equals the CPU's;
              sweep A / sweep B kernels against their plain PyTorch
              versions on the biceps_full step-0 inputs, per column
  4. main     run_protocol(500 steps, chunk 100, stim off at 250); each
              forward kernel's launch count must be exactly 500
  5. small    6 steps of a 462-particle biceps slice through the kernels on
              the card against the plain versions on the CPU (the CPU path
              is the one the tests hold to the JAX package)
  6. timing   ms/step (CUDA events) of the kernel path and the plain path,
              and per-kernel times at biceps_full shapes
  7. bwd      backward sweep A / B kernels against their plain versions on
              the biceps_full step-0 inputs with seeded random cotangents,
              per column
  8. grad     value and grad of a 3-step checkpointed rollout loss w.r.t.
              log(K, mu) on the 462-particle slice, card (kernels) against
              CPU (plain versions)
  9. fit      the fit driver's functions on biceps_full: a 20-step rollout,
              4 snapshots, 6 Adam iterations from (0.3, 150); finite loss
              and grads, a falling loss, and exact launch counts
 10. timing   backward kernels against their plain versions, forward and
              grad ms/step of the fit's rollout, its peak memory, and each
              kernel's bound from the pairs these inputs need

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.examples import fit_material_flagship as fit
from sph_sm_monodomain_tpu_torch.models import monodomain
from sph_sm_monodomain_tpu_torch.ops import cuda_lib
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as fad
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.grid import (auto_cell_capacity,
                                                  auto_window_capacity)
from sph_sm_monodomain_tpu_torch.ops.shape_matching import (
    corrected_velocity, sm_invariants)
from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3
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
# name, source, TPU kernel replaced, module holding the wrapper
KERNELS = (
    ("sweep_a3", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:446", fst),
    ("sweep_b3", "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
     "sph_sm_monodomain_tpu/ops/fused_step.py:522", fst),
    ("sweep_bwd_a", "sph_sm_monodomain_tpu_torch/csrc/fused_adjoint.cu",
     "sph_sm_monodomain_tpu/ops/fused_adjoint.py:94", fad),
    ("sweep_bwd_b", "sph_sm_monodomain_tpu_torch/csrc/fused_adjoint.cu",
     "sph_sm_monodomain_tpu/ops/fused_adjoint.py:173", fad),
)
# Bound: the larger of the kernel's FLOPs over the fp32 peak outside the
# tensor cores and its bytes (each input read once, each output written
# once) over the memory rate; H100 SXM data-sheet peaks at 700 W.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# FLOPs per pair of each kernel body (csrc/*.cu; a fused multiply-add
# counts 2, rsqrtf, fmaxf and a compare-select 1), charged only to the
# pairs the function needs: every pair that passes the full per-axis cell
# mask pays its distance and support test (8 + 2); then, inside the support
# of the kernel's weights (a pair outside it adds exactly 0):
#   sweep A: 15 for r < h (Poly6 density + XSPH)
#   sweep B: 40 for 1e-12 < r^2 < 4h^2 (rsqrt, Spiky pressure + viscosity,
#            B-spline Vm Laplacian)
#   bwd A:   43 for r < h (9 accumulators, both pair roles)
#   bwd B:   129 for 1e-12 < r^2 < 4h^2 (rsqrt, r, r/h, then 10
#            accumulators, both pair roles)
PAIR_FLOPS = {
    "sweep_a3": (("full", 10), ("h", 15)),
    "sweep_b3": (("full", 10), ("2h", 40)),
    "sweep_bwd_a": (("full", 10), ("h", 43)),
    "sweep_bwd_b": (("full", 10), ("2h", 129)),
}


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of `fn` over `reps` chained calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step0_inputs(scene, dev):
    """The sorted sweep inputs of the scene's first step."""
    st, cfg = scene.state, scene.cfg
    order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                     scene.sub_block)
    st = corrected_velocity(st, cfg, sm_inv=sm_invariants(st, cfg))
    fs, feats_a = fst.build_qm_feats(st, cx, cyz, order)
    return fs, feats_a, lo, hi


def pair_counts(fs, lo, hi, cfg, sub_q):
    """Pairs the sweeps need on these inputs, counted on the card from the
    sub-blocks' windows and the exact full cell mask (query and candidate
    live): {"full": every pair the mask passes, "h": of those, r^2 < h^2,
    "2h": 1e-12 < r^2 < 4h^2}."""
    gm = float(fst._g_mid(cfg))
    h2 = cfg.kernel_h * cfg.kernel_h
    lo_l, hi_l = lo.tolist(), hi.tolist()
    acc = torch.zeros(3, dtype=torch.int64, device=fs.device)
    for b in range(fs.shape[0] // sub_q):
        q = fs[b * sub_q:(b + 1) * sub_q, None, :]
        for r in range(3):
            w_lo, w_hi = lo_l[4 * b + r], hi_l[4 * b + r]
            if w_hi <= w_lo:
                continue
            c = fs[None, w_lo:w_hi]
            full = ((q[..., 13] + (r - 1) * gm - c[..., 13]).abs() <= 1.0) \
                & ((q[..., 12] - c[..., 12]).abs() <= 1.0) \
                & (q[..., 12] >= 0.0) & (c[..., 12] >= 0.0)
            d = q[..., 0:3] - c[..., 0:3]
            r2 = (d * d).sum(-1)
            acc += torch.stack([full.sum(), (full & (r2 < h2)).sum(),
                                (full & (r2 > 1e-12)
                                 & (r2 < 4.0 * h2)).sum()])
    return dict(zip(("full", "h", "2h"), acc.tolist()))


def bound(name, counts, n_rows):
    """(bound ms, "bytes" or "operations", FLOPs, bytes) of one launch:
    (N, 16) query matrix, (16, N) features, window bounds, the 32-slot
    constants and the (N, 16) output."""
    flops = sum(counts[k] * f for k, f in PAIR_FLOPS[name])
    nbytes = 4 * (3 * 16 * n_rows + 2 * (n_rows // 128) * 4 + 32)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def column_errors(got, want):
    """(max abs error, worst err / (KERNEL_TOL * max(1, max|want col|)))."""
    err = (got - want).abs().amax(dim=0)
    bound = KERNEL_TOL * torch.clamp(want.abs().amax(dim=0), min=1.0)
    return float(err.max()), float((err / bound).max()), err.tolist()


def slice_scene(dev):
    pts = T.read_cloud_csv(ASSETS_DIR / "biceps_simple_out_18475.csv")[::40]
    cfg = T.SimConfig()
    st = T.stim.turn_on_stim_mesh(T.init_fluid(pts, cfg, device=dev), pts,
                                  cfg)
    return T.Scene(state=st, cfg=cfg,
                   cell_capacity=auto_cell_capacity(pts, cfg),
                   neighbor_capacity=auto_window_capacity(pts, cfg),
                   num_particles=pts.shape[0], name="biceps_every40")


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False — this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(card_line(), flush=True)
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
    kern_a = fst.sweep_a3(fs, feats_a, lo, hi, cfg, sub_q=sub_q)
    feats_b = fst.feats_b(plain_a)  # B compared on the same OUT_A
    plain_b = fst.sweep_b3_plain(plain_a, feats_b, cfg)
    kern_b = fst.sweep_b3(plain_a, feats_b, lo, hi, cfg, sub_q=sub_q)
    torch.cuda.synchronize()
    report = {}
    for name, got, want in (("sweep_a3", kern_a, plain_a),
                            ("sweep_b3", kern_b, plain_b)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        max_err, ratio, per_col = column_errors(got, want)
        report[name] = {"max_abs_err": max_err}
        print(f"{name}: max_abs_err {max_err:.6g}, worst column at "
              f"{ratio:.4g} of the bound {KERNEL_TOL:g}*max(1,max|plain|); "
              f"per column {[f'{e:.3g}' for e in per_col]}", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"{name} disagrees with its plain version")

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
    act = state.active
    pos = state.pos[act]
    world = torch.tensor(cfg.world_size, device=dev)
    if not torch.isfinite(pos).all():
        raise AssertionError("non-finite positions")
    if not ((pos >= 0.0) & (pos <= world)).all():
        raise AssertionError("positions outside the world box")
    if not (state.stim[act] == -10000.0).all():
        raise AssertionError("stim != -10000 after stim-off")
    if int(aux.overflow) != 0:
        raise AssertionError(f"overflow {int(aux.overflow)}")
    orig = scene.state.orig_pos[act]
    for step in (250, 500):
        d = torch.linalg.vector_norm(traj["pos"][step // 50 - 1][act] - orig,
                                     dim=-1)
        print(f"mean displacement at step {step}: {float(d.mean()):.6g} "
              f"(max {float(d.max()):.6g})", flush=True)

    phase("5 small input: kernels on the card vs plain versions on the CPU")
    small = slice_scene(dev)
    sc_cpu = small._replace(state=small.state.to("cpu"))
    got, _, _ = T.run_protocol(small, num_steps=6, chunk=4, stim_off_step=3)
    want, _, _ = T.run_protocol(sc_cpu, num_steps=6, chunk=4,
                                stim_off_step=3)
    a = want.active.numpy()
    g, w = T.state_to_numpy(got), T.state_to_numpy(want)
    for name, atol in SLICE_TOLS.items():
        err = float(np.abs(g[name][a] - w[name][a]).max())
        print(f"slice {name}: max abs diff {err:.3g} (tolerance {atol:g})",
              flush=True)
        if not err <= atol:
            raise AssertionError(f"slice {name} diverged")
    rel = float((np.abs(g["dens"][a] - w["dens"][a]) / np.abs(w["dens"][a]))
                .max())
    print(f"slice dens: max rel diff {rel:.3g} (tolerance "
          f"{SLICE_DENS_RTOL:g})", flush=True)
    if not rel <= SLICE_DENS_RTOL:
        raise AssertionError("slice dens diverged")

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
    for name, (k_ms, p_ms) in times.items():
        print(f"{name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)

    phase("7 backward kernels vs plain versions (biceps_full step-0 "
          "inputs, seeded random cotangents)")
    rng = np.random.default_rng(0)
    cot = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    n_rows = fs.shape[0]
    qm_a = fad.bwd_a_query(fs, cot(n_rows), cot(n_rows, 3))
    qm_b = fad.bwd_b_query(plain_a, cot(n_rows, 3), cot(n_rows))
    feats_ba, feats_bb = qm_a.T.contiguous(), qm_b.T.contiguous()
    for name, got, want in (
            ("sweep_bwd_a",
             fad.sweep_bwd_a(qm_a, feats_ba, lo, hi, cfg, sub_q),
             fad.sweep_bwd_a_plain(qm_a, feats_ba, cfg)),
            ("sweep_bwd_b",
             fad.sweep_bwd_b(qm_b, feats_bb, lo, hi, cfg, sub_q),
             fad.sweep_bwd_b_plain(qm_b, feats_bb, cfg))):
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
            "sweep_bwd_a": FIT_STEPS * FIT_ITERS,
            "sweep_bwd_b": FIT_STEPS * FIT_ITERS}
    if fit_launches != want:
        raise AssertionError(f"fit launches {fit_launches}, want {want}")
    launches.update(sweep_bwd_a=fit_launches["sweep_bwd_a"],
                    sweep_bwd_b=fit_launches["sweep_bwd_b"])

    phase("10 timing: backward kernels, the fit's rollout, bounds")
    times["sweep_bwd_a"] = (
        cuda_ms(lambda: fad.sweep_bwd_a(qm_a, feats_ba, lo, hi, cfg, sub_q),
                200),
        cuda_ms(lambda: fad.sweep_bwd_a_plain(qm_a, feats_ba, cfg), 5))
    times["sweep_bwd_b"] = (
        cuda_ms(lambda: fad.sweep_bwd_b(qm_b, feats_bb, lo, hi, cfg, sub_q),
                200),
        cuda_ms(lambda: fad.sweep_bwd_b_plain(qm_b, feats_bb, cfg), 5))
    for name in ("sweep_bwd_a", "sweep_bwd_b"):
        print(f"{name}: kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms", flush=True)
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
    counts = pair_counts(fs, lo, hi, cfg, sub_q)
    print(f"pairs the sweeps need (biceps_full step 0): {counts}",
          flush=True)
    bounds = {}
    for name, *_ in KERNELS:
        bounds[name] = bound(name, counts, n_rows)
        b_ms, by, flops, nbytes = bounds[name]
        print(f"{name}: {flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB, "
              f"bound {b_ms * 1e3:.4f} us ({by}), kernel at "
              f"{b_ms / times[name][0] * 100:.3f}% of it", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, source, replaces, _ in KERNELS],
        "step_ms": kernel_ms, "plain_step_ms": plain_ms,
        "fit_fwd_ms_per_step": fwd_ms, "fit_grad_ms_per_step": grad_ms,
        "fit_peak_gib": peak / 2**30}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
