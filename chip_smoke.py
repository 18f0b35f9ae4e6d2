"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path — `build_scene("biceps_full")` (18,475
particles) and the chunked `run_protocol` of the v4 fused step — on the
card, through the two hand-written CUDA sweep kernels. Phases, each
printing its lines; any failure raises and exits non-zero:

  1. device   needs torch.cuda; prints the card's name and power limit
  2. build    nvcc builds csrc/fused_sweeps.cu (timed, with ptxas usage)
  3. kernels  the sort + window bookkeeping on the card equals the CPU's;
              sweep A / sweep B kernels against their plain PyTorch
              versions on the biceps_full step-0 inputs, per column
  4. main     run_protocol(500 steps, chunk 100, stim off at 250); each
              kernel's launch count must grow by exactly 500
  5. small    6 steps of a 462-particle biceps slice through the kernels on
              the card against the plain versions on the CPU (the CPU path
              is the one the tests hold to the JAX package)
  6. timing   ms/step (CUDA events) of the kernel path and the plain path,
              and per-kernel times at biceps_full shapes

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
from sph_sm_monodomain_tpu_torch.models import monodomain
from sph_sm_monodomain_tpu_torch.ops import cuda_lib
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
KERNELS = (
    ("sweep_a3", "sph_sm_monodomain_tpu/ops/fused_step.py:446"),
    ("sweep_b3", "sph_sm_monodomain_tpu/ops/fused_step.py:522"),
)


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


def feats_b_of(out_a):
    vol = torch.where(out_a[:, 8] > 0.0, out_a[:, 10] / out_a[:, 8],
                      torch.zeros_like(out_a[:, 8]))
    return fst.feats_from_out_a(out_a, vol)


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
    feats_b = feats_b_of(plain_a)  # B compared on the same OUT_A
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

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "sph_sm_monodomain_tpu_torch/csrc/fused_sweeps.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, replaces in KERNELS],
        "step_ms": kernel_ms, "plain_step_ms": plain_ms}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
