"""How far tile 0 of a replicated scene drifts from the x1 run, and why.

The independent-run oracle (chip_smoke.py phase 24, tests/test_sm_clusters.py)
runs biceps_full xK (K muscles tiled along x, one shape-matching cluster
each) and the x1 scene for a few steps and holds tile 0 to the x1 run.
Tile 0's rows see the same physics in both; what differs is rounding:
  - the clustered shape-matching form: "blocked" (the cluster axis folded
    into the columns of one product; xK with 3K <= 128), "contig" (a
    batched product over each tile's contiguous rows; x56) or "onehot",
    where x1 takes the global sums;
  - the warp-slice count of K1 / K2 (csrc/sweep_common.cuh `warp_slices`:
    2 to 16 by the row count; 16 on x1, 4 on x7, 2 on x56), which splits
    each sub-block's candidates among warps whose partial sums are added
    in a fixed order;
  - the shape-matching formula: x1 takes the single-cluster moments about
    the world origin, every xK the clustered ones about each tile's rest
    center (ops/shape_matching.py);
  - the sort order: the v4 hash puts the axis of the widest grid slowest
    (ops/sweeps.hash_axis_perm), so every xK (K > 1) sorts tile 0 in
    y-fastest order where x1 sorts it x-fastest; tile 0 comes first in
    xK's order, in the same order for every K.

This tool reruns the oracle with one of them at a time switched, and
beside every distance prints the x1 run's own spread: the largest change
of x1's positions when every live position starts one float32 ulp up, or
one down (the yardstick of tests/torch_parity.py). Each run is
`simulate(..., num_steps=steps)` (the v4 step, graphed on the card, the
capture cache dropped between runs); tile 0's distance is the largest
|pos - x1 pos| over its rows, with the row and position where it lies.

    python -m sph_sm_monodomain_tpu_torch.tools.tile_drift \\
        [--scene biceps_full] [--replicates 7 56] [--steps 3] \\
        [--slices 2 4 16] [--device cuda|cpu]

The slice variants rebuild the kernels with `warp_slices` returning a
fixed count (as compare_builds.py --slices does) and run on the card only:
the CPU runs the kernels' plain versions, which have no slices.
"""

from __future__ import annotations

import argparse
import contextlib
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import monodomain, scan
from ..models.monodomain import simulate
from ..ops import cuda_lib
from ..ops import shape_matching as sm
from ..utils.io import build_scene

# the line of warp_slices (csrc/sweep_common.cuh) a slice variant replaces
SLICES_FILE, SLICES_LINE = "sweep_common.cuh", "  int slices = 2;\n"
FORMS = ("blocked", "contig", "onehot")


def warp_slices(n: int) -> int:
    """The slice count csrc/sweep_common.cuh's warp_slices gives n rows on
    this card."""
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    slices = 2
    while slices < 16 and (n // 32) * slices < 64 * sms:
        slices *= 2
    return slices


def slices_csrc(k: int):
    """(csrc, build dir) of a copy of csrc/ under build/ whose sliced
    launches all take k warp slices."""
    out = cuda_lib.BUILD_DIR.parent / "tile_drift" / f"slices{k}"
    d = out / "csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC_DIR, d)
    src = (d / SLICES_FILE).read_text()
    if SLICES_LINE not in src:
        raise RuntimeError("warp_slices changed: update SLICES_LINE")
    (d / SLICES_FILE).write_text(src.replace(
        SLICES_LINE, f"  int slices = {k};\n  if (slices) return slices;\n"))
    return d, out


def slices_libraries(slices) -> dict:
    """{k: the bound kernel library with every sliced launch at k warp
    slices}, built in parallel."""
    jobs = {k: slices_csrc(k) for k in slices}
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        paths = dict(zip(jobs, pool.map(
            lambda j: cuda_lib.build(csrc=j[0], build_dir=j[1]),
            jobs.values())))
    return {k: cuda_lib.bind(p) for k, p in paths.items()}


@contextlib.contextmanager
def library(lib):
    """Inside, every kernel launches from `lib` (None: the checkout's)."""
    saved = cuda_lib._lib
    if lib is not None:
        cuda_lib._lib = lib
    scan.clear_cache()
    try:
        yield
    finally:
        cuda_lib._lib = saved
        scan.clear_cache()


@contextlib.contextmanager
def form(name: str | None, k: int):
    """Inside, a K-cluster scene's shape matching takes the form `name`
    (None: the one its size picks): blocked by widening
    shape_matching._BLOCKED_MAX_LANES to 3K, contig and onehot by closing
    it (onehot also needs cfg.sm_tile_rows = 0: `form_cfg`)."""
    saved = sm._BLOCKED_MAX_LANES
    if name is not None:
        sm._BLOCKED_MAX_LANES = 3 * k if name == "blocked" else 0
    scan.clear_cache()
    try:
        yield
    finally:
        sm._BLOCKED_MAX_LANES = saved
        scan.clear_cache()


@contextlib.contextmanager
def clustered_x1():
    """Inside, a one-cluster scene runs the clustered shape matching (K =
    1: the moments about its rest center) in place of the global one."""
    saved = monodomain.sm_invariants

    def invariants(state, cfg, comm=None):
        if cfg.sm_clusters != 1:
            return saved(state, cfg, comm)
        return sm._clustered_invariants(state, cfg, *sm._masses(state, cfg),
                                        comm)
    monodomain.sm_invariants = invariants
    scan.clear_cache()
    try:
        yield
    finally:
        monodomain.sm_invariants = saved
        scan.clear_cache()


def form_cfg(cfg, name: str | None):
    return cfg.replace(sm_tile_rows=0) if name == "onehot" else cfg


def built_form(sc) -> str:
    inv = sm.sm_invariants(sc.state, sc.cfg)
    return sm._segment_form(inv, sc.cfg, sc.state.capacity)


def bump_pos(state, toward: float):
    """The state with every live row's pos moved one float32 ulp toward
    `toward`."""
    pos = state.pos.clone()
    act = state.active
    pos[act] = torch.nextafter(pos[act], torch.full_like(pos[act], toward))
    return state.replace(pos=pos)


def run(sc, steps: int, state=None, cfg=None):
    """The positions after `steps` v4 steps of the scene (or of `state`
    under `cfg`)."""
    st = sc.state if state is None else state
    return simulate(st, cfg or sc.cfg, num_steps=steps,
                    sub_q=sc.sub_block)[0].pos


def distance(pos, ref, rows: int) -> dict:
    """The largest |pos - ref| over the first `rows` rows, with the row
    and its reference position."""
    d = (pos[:rows] - ref[:rows]).abs().amax(dim=1)
    i = int(d.argmax())
    return {"distance": float(d[i]), "row": i,
            "at": [round(float(v), 6) for v in ref[i]]}


def drift(scene: str = "biceps_full", replicates=(7, 56), steps: int = 3,
          slices=(2, 4, 16), device="cuda") -> dict:
    """{"spread": x1's own spread, "rows": tile rows, "runs": [{"label",
    "what", "distance", "row", "at"} or {"label", "what", "skipped"}]}:
    tile 0's distance from the x1 run in each variant."""
    on_card = torch.device(device).type == "cuda"
    x1 = build_scene(scene, device=device)
    r = x1.num_particles
    ref = run(x1, steps)
    runs = []

    def add(label, what, pos):
        runs.append({"label": label, "what": what, **distance(pos, ref, r)})

    def skip(label, what):
        runs.append({"label": label, "what": what,
                     "skipped": "card only (the CPU has no warp slices)"})

    bumped = [distance(run(x1, steps, bump_pos(x1.state, t)), ref, r)
              for t in (np.inf, -np.inf)]
    spread = max(b["distance"] for b in bumped)
    for t, b in zip(("+", "-"), bumped):
        runs.append({"label": f"x1 {t}1 ulp", "what": "x1's own spread", **b})
    with clustered_x1():
        add("x1 clustered (K = 1)", "shape-matching formula", run(x1, steps))
    libs = slices_libraries(slices) if on_card else {}
    for s in slices:
        if not on_card:
            skip(f"x1 at {s} slices", "slice count")
            continue
        with library(libs[s]):
            add(f"x1 at {s} slices", "slice count", run(x1, steps))
    for k in replicates:
        sc = build_scene(scene, replicate=k, device=device)
        wide = x1.cfg.replace(world_size=sc.cfg.world_size)
        with library(None):
            add(f"x1 in x{k}'s world", "sort order (hash axes)",
                run(x1, steps, cfg=wide))
        with clustered_x1():
            add(f"x1 clustered in x{k}'s world", "formula and sort order",
                run(x1, steps, cfg=wide))
        own = built_form(sc)
        own_s = warp_slices(sc.state.capacity) if on_card else None
        with library(None), form(None, k):
            add(f"x{k} as built ({own}"
                + (f", {own_s} slices)" if on_card else ")"), "baseline",
                run(sc, steps))
        for f in FORMS:
            if f == own:
                continue
            with form(f, k):
                add(f"x{k} {f} form", "shape-matching form",
                    run(sc, steps, cfg=form_cfg(sc.cfg, f)))
        for s in slices:
            if on_card and s == own_s:
                continue
            if not on_card:
                skip(f"x{k} at {s} slices", "slice count")
                continue
            with library(libs[s]):
                add(f"x{k} at {s} slices", "slice count", run(sc, steps))
        del sc
        if on_card:
            torch.cuda.empty_cache()
    return {"spread": spread, "rows": r, "steps": steps, "runs": runs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="biceps_full")
    ap.add_argument("--replicates", type=int, nargs="+", default=[7, 56])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--slices", type=int, nargs="*", default=[2, 4, 16])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    out = drift(a.scene, tuple(a.replicates), a.steps, tuple(a.slices),
                a.device)
    s = out["spread"]
    print(f"{a.scene}, {a.steps} steps on {a.device}: tile 0 ({out['rows']} "
          f"rows) from the x1 run; x1's own +-1-ulp spread {s:.4g}",
          flush=True)
    for v in out["runs"]:
        if "skipped" in v:
            print(f"  {v['label']:<32} {v['what']:<24} skipped: "
                  f"{v['skipped']}", flush=True)
            continue
        ratio = v["distance"] / s if s > 0 else float("inf")
        print(f"  {v['label']:<32} {v['what']:<24} {v['distance']:.4g} "
              f"({ratio:.2f} x spread) at row {v['row']} {v['at']}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
