"""Price the halo path at world size 1 (the port's counterpart of the JAX
repository's tools/halo_tpu.py, which prices it on a one-device TPU mesh).

World size 1 runs the whole halo program, its migration and plane
exchanges with a single participant, every capacity and padding path
taken: NCCL on the card, gloo with `--device cpu`. Per scene scale
(biceps_full x `replicate`):
  - with `--check`, the numerics: 3 halo steps against 3 one-device v4
    steps, matched by particle identity (orig_pos) after unshard, each
    field within max(4 x v4's own noise floor, 1e-5), the floor being
    v4's change when the same particles start in shuffled row order (the
    JAX tool's bar);
  - the halo simulate's ms/step (graphed on the card, best of 4 calls
    after the warm-up and capture call), the one-device v4 simulate's in
    the same session, and the overhead ratio.

Usage:
  python -m sph_sm_monodomain_tpu_torch.tools.halo_gpu [replicate]
      [scan_length] [--check] [--slack=S] [--row[=PATH]] [--device cpu]

(replicate 7 = 129,325 particles, 56 = 1,034,600.) `--row` appends the
measurement as one line of results_gpu_halo.csv (or PATH), in the JAX
tool's format, the card's name and power limit in its backend column.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..models.monodomain import simulate, step_fused
from ..ops.shape_matching import sm_invariants
from ..parallel import comm as C
from ..parallel import halo_step as PH
from ..parallel.sharded_step import gather_state
from ..state import FIELD_NAMES, ParticleState
from ..utils.io import build_scene
from .roofline import card_line

DEFAULT_ROW = "results_gpu_halo.csv"
CHECK_STEPS, TIMED_CALLS = 3, 4
CHECK_FIELDS = ("pos", "vel", "vm", "dens", "iion", "w")

HALO_ROW_HEADER = ("scene;particles;devices;Halo Step Duration;"
                   "v4 Anchor Step;Overhead;Padded Rows;Scan Length;"
                   "Compile s;backend")


def append_halo_row(path, scene, n, devices, halo_s, v4_s, pad_factor,
                    length, compile_s, backend):
    """Append one halo pricing row (report-style ;-separated, %g values),
    the JAX tool's row; a new file starts with a comment naming the
    backend (the card and its power limit) and the header."""
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as f:
        if new:
            f.write("# The halo path priced at world size 1 "
                    "(sph_sm_monodomain_tpu_torch/tools/halo_gpu.py), on "
                    f"{backend}.\n"
                    "# Overhead = halo/v4 same-session; it buys O(N/D) "
                    "state+compute per device\n"
                    "# (break-even D ~= Overhead). Durations in seconds"
                    " per step, best of graphed calls.\n")
            f.write(HALO_ROW_HEADER + "\n")
        f.write(f"{scene};{n};{devices};{halo_s:g};{v4_s:g};"
                f"{halo_s / v4_s:g};{pad_factor:g};{length};"
                f"{compile_s:g};{backend}\n")


def parse_args(argv) -> dict:
    """The JAX tool's arguments: [replicate] [scan_length] [--check]
    [--slack=S] [--row[=PATH]] (--row takes its path only as --row=PATH,
    so `--row 56` means replicate 56), and [--device cuda|cpu]."""
    row_out, device, kept = None, "cuda", []
    it = iter(argv)
    for a in it:
        if a == "--row":
            row_out = DEFAULT_ROW
        elif a.startswith("--row="):
            row_out = a.split("=", 1)[1] or DEFAULT_ROW
        elif a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            kept.append(a)
    args = [a for a in kept if not a.startswith("--")]
    return {"replicate": int(args[0]) if args else 7,
            "length": int(args[1]) if len(args) > 1 else 20,
            "check": "--check" in kept,
            "slack": next((float(a.split("=", 1)[1]) for a in kept
                           if a.startswith("--slack=")), 1.2),
            "row": row_out, "device": device}


def by_identity(state, n_expect: int) -> dict:
    """The active rows' CHECK_FIELDS sorted by particle identity (orig_pos
    is unique and migration-invariant), as numpy."""
    act = state.active.detach().cpu().numpy()
    op = state.orig_pos.detach().cpu().numpy()[act]
    assert op.shape[0] == n_expect, (op.shape[0], n_expect)
    order = np.lexsort((op[:, 2], op[:, 1], op[:, 0]))
    return {f: getattr(state, f).detach().cpu().numpy()[act][order]
            for f in CHECK_FIELDS}


def _v4_steps(state, cfg, sub_q: int, steps: int):
    sm_inv = sm_invariants(state, cfg)
    for _ in range(steps):
        state, _ = step_fused(state, cfg, sub_q, impl="v4", sm_inv=sm_inv)
    return state


def _shuffled(state, cfg, n: int):
    """The state with its live rows in a seeded order (within each
    cluster tile where the clustered moments need tile-contiguous rows)."""
    rng = np.random.default_rng(0)
    full = np.arange(state.capacity)
    tile_r = cfg.sm_tile_rows
    if tile_r > 0:
        for lo in range(0, n, tile_r):
            hi = min(lo + tile_r, n)
            full[lo:hi] = lo + rng.permutation(hi - lo)
    else:
        full[:n] = rng.permutation(n)
    perm = torch.from_numpy(full).to(state.device)
    return ParticleState(**{f: getattr(state, f) if f == "is_stim_on"
                            else getattr(state, f)[perm]
                            for f in FIELD_NAMES})


def check(comm, sc, halo0, mig: int, hcap: int, sub_q: int) -> dict:
    """CHECK_STEPS halo steps against as many one-device v4 steps, by
    identity: {field: (error, v4's shuffle floor, limit)}; raises where a
    field is off by its limit or more, or the halo run overflowed."""
    cfg, n = sc.cfg, sc.num_particles
    t0 = time.perf_counter()
    step = PH.make_halo_step(comm, cfg, mig, hcap, sub_q=sub_q)
    h = halo0
    for _ in range(CHECK_STEPS):
        h, ovf = step(h)
    if int(ovf):
        raise AssertionError(f"halo overflow {int(ovf)}")
    # unshard raises where the active count is not n (a particle lost)
    dense = PH.unshard_state_halo(gather_state(h, comm), n, cfg)
    print(f"halo {CHECK_STEPS}-step + unshard ok, {n} of {n} particles "
          f"kept ({time.perf_counter() - t0:.1f} s incl. the kernels' "
          "first launches)", flush=True)
    a = by_identity(dense, n)
    b = by_identity(_v4_steps(sc.state, cfg, sub_q, CHECK_STEPS), n)
    floor = by_identity(_v4_steps(_shuffled(sc.state, cfg, n), cfg, sub_q,
                                  CHECK_STEPS), n)
    out, bad = {}, []
    for f in CHECK_FIELDS:
        err = float(np.abs(a[f] - b[f]).max())
        nf = float(np.abs(floor[f] - b[f]).max())
        tol = max(4.0 * nf, 1e-5)
        out[f] = (err, nf, tol)
        print(f"  max|halo - v4| {f}: {err:.2e} (v4 shuffle-noise floor "
              f"{nf:.2e}, tol {tol:.2e})", flush=True)
        if err >= tol:
            bad.append((f, err, nf))
    if bad:
        raise AssertionError(f"diverged beyond the v4 noise floor: {bad}")
    print("numerics: halo matches one-device v4 within v4's own "
          "reduction-order noise", flush=True)
    return out


def _best_s_per_step(run, length: int) -> tuple[float, float]:
    """(seconds of the first call: warm-up step and capture on the card;
    best seconds per step over TIMED_CALLS more, each ending in a host
    fetch)."""
    best, first = float("inf"), None
    for _ in range(1 + TIMED_CALLS):
        t0 = time.perf_counter()
        ovf = int(run())
        dt = time.perf_counter() - t0
        if ovf:
            raise AssertionError(f"overflow {ovf}")
        if first is None:
            first = dt
        else:
            best = min(best, dt / length)
    return first, best


def main(argv=None) -> dict:
    """Run the tool (module docstring); returns what it printed as a
    dict."""
    opt = parse_args(sys.argv[1:] if argv is None else argv)
    rep, length, device = opt["replicate"], opt["length"], opt["device"]
    sc = build_scene("biceps_full", replicate=rep, device=device)
    cfg, n = sc.cfg, sc.num_particles
    sub_q = sc.sub_block or 128
    dev = sc.state.device
    backend = card_line() if dev.type == "cuda" else "cpu"
    comm = C.init(0, 1, dev.type, f"tcp://localhost:{C.free_port()}")
    try:
        print(f"x{rep}: N={n} on {backend}, {comm.describe()}, "
              f"sub_q={sub_q}", flush=True)
        halo0, s_cap, mig, hcap = PH.shard_state_halo(
            sc.state, comm, cfg, slack=opt["slack"], q_block=sub_q)
        print(f"halo capacities: S={s_cap} ({s_cap / n:.2f}x rows) "
              f"mig={mig} halo={hcap}", flush=True)
        out = {"backend": backend, "particles": n, "caps": [s_cap, mig,
                                                            hcap]}
        if opt["check"]:
            out["check"] = check(comm, sc, halo0, mig, hcap, sub_q)

        sim = PH.make_halo_simulate(comm, cfg, mig, hcap, length,
                                    sub_q=sub_q)
        compile_s, halo_s = _best_s_per_step(lambda: sim(halo0)[1], length)
        print(f"halo_d1: {halo_s * 1e3:.4f} ms/step (first call "
              f"{compile_s:.1f} s, scan {length})", flush=True)
        _, v4_s = _best_s_per_step(lambda: simulate(
            sc.state, cfg, length, sub_q=sub_q, impl="v4")[1].overflow,
            length)
        print(f"v4 one-device anchor: {v4_s * 1e3:.4f} ms/step", flush=True)
        print(f"slab overhead: {halo_s / v4_s:.2f}x (sorts + exchanges + "
              f"{s_cap / n:.2f}x padded rows)", flush=True)
        out.update(halo_ms=halo_s * 1e3, v4_ms=v4_s * 1e3,
                   overhead=halo_s / v4_s, compile_s=compile_s)
        if opt["row"]:
            append_halo_row(opt["row"], f"halo_d1_x{rep}", n, 1, halo_s,
                            v4_s, s_cap / n, length, compile_s,
                            backend)
            with open(opt["row"]) as f:
                out["row"] = f.read().splitlines()[-1]
            print(f"row appended to {opt['row']}: {out['row']}", flush=True)
    finally:
        C.shutdown()
    return out


if __name__ == "__main__":
    main()
