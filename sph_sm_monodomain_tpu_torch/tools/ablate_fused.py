"""Ablation timings of the fused coupled step's components (mirror of the
JAX repository's tools/ablate_fused.py, its configs `full book sort gath
swpa swpb sm`).

Each config is STEPS chained calls of one body, every call's input the
previous call's output (so each depends on the last), run as one scan
after one warm-up run (utils/report._chain_time): on the card replays of
a captured CUDA graph timed between CUDA events, on the CPU eager calls
under time.perf_counter; the best of REPS chains, in ms per call:

  full  the v4 fused step (sweeps K1 / K2)
  book  the v1 per-query run bookkeeping (ablation.legacy_sweeps)
  sort  cell ids + stable argsort
  gath  the two (N, 16) permute gathers (sorted order and back)
  swpa  v1 sweep A alone (K8), bookkeeping hoisted
  swpb  v1 sweep B alone (K8), bookkeeping hoisted
  sm    shape matching (corrected_velocity), invariants not hoisted

Usage:
  python -m sph_sm_monodomain_tpu_torch.tools.ablate_fused [scene]
      [config ...] [--device cuda|cpu] [--steps 100]
"""

from __future__ import annotations

import argparse
import sys

import torch

CONFIGS = ("full", "book", "sort", "gath", "swpa", "swpb", "sm")
STEPS = 100
REPS = 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", nargs="?", default="biceps_full")
    ap.add_argument("configs", nargs="*",
                    help=f"configs to run, of {' '.join(CONFIGS)} "
                         "(default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    only = set(args.configs)
    if only - set(CONFIGS):
        ap.error(f"unknown configs {sorted(only - set(CONFIGS))}")

    from ..ablation.legacy_sweeps import sweep_a, sweep_b, sweep_bookkeeping
    from ..models.monodomain import step_fused
    from ..ops.grid import cell_coords
    from ..ops.shape_matching import corrected_velocity
    from ..utils.io import build_scene
    from ..utils.report import _chain_time

    sc = build_scene(args.scene, device=args.device)
    st, cfg = sc.state, sc.cfg
    sub_q = sc.sub_block or 128
    print(f"scene={args.scene} n={sc.num_particles} cap={st.capacity} "
          f"sub_q={sub_q} device={st.device}", flush=True)
    out = {}

    def run(name, fn, init):
        if only and name not in only:
            return
        ms = _chain_time(fn, init, length=args.steps, reps=REPS) * 1e3
        out[name] = ms
        print(f"{name:6s} {ms:8.3f} ms/step", flush=True)

    run("full", lambda s: step_fused(s, cfg, sub_q)[0], st)

    def f_book(p):
        o = sweep_bookkeeping(p, st.active, cfg, sub_q)[0]
        return p + (o[0] % 2).to(p.dtype) * 1e-7
    run("book", f_book, st.pos)

    gx, gy, gz = cfg.grid_size

    def f_sort(p):
        c = cell_coords(p, cfg)
        x, y, z = c[:, 0], c[:, 1], c[:, 2]
        inside = ((x >= 0) & (x < gx) & (y >= 0) & (y < gy)
                  & (z >= 0) & (z < gz))
        ids = torch.where(inside & st.active, x + gx * (y + gy * z),
                          cfg.num_cells)
        o = torch.argsort(ids, stable=True)
        return p + (o[0] % 2).to(p.dtype) * 1e-7
    run("sort", f_sort, st.pos)

    order, inv, qs, qe, bs, bl = sweep_bookkeeping(st.pos, st.active, cfg,
                                                   sub_q)

    def f_gath(f):
        return f * (1.0 - 1e-12) + 1e-12 * f[order][inv]
    run("gath", f_gath, st.pos[:, :1].repeat(1, 16))

    pos_s, mass_s = st.pos[order], st.mass[order]
    vol0 = mass_s / st.dens[order]
    bounds = (qs, qe, bs, bl)

    def f_swpa(cv):
        dens, xsph = sweep_a(pos_s, cv, vol0, mass_s, *bounds, cfg)
        return cv + 1e-9 * xsph + 1e-12 * dens[:, None]
    run("swpa", f_swpa, torch.zeros_like(pos_s))

    zeros = torch.zeros_like(mass_s)

    def f_swpb(iv):
        acc, lap = sweep_b(pos_s, iv, vol0, zeros, zeros, *bounds, cfg)
        return iv + 1e-9 * acc + 1e-12 * lap[:, None]
    run("swpb", f_swpb, torch.zeros_like(pos_s))

    def f_sm(s):
        s = corrected_velocity(s, cfg)
        return s.replace(pos=s.pos + 1e-9 * s.corrected_vel)
    run("sm", f_sm, st)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
