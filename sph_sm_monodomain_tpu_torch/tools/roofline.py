"""Efficiency denominator for the fused sweeps on the card (mirror of the
JAX repository's tools/roofline.py): enumerated candidate slots,
useful-pair counts, and the sweeps' share of the measured fp32 peak, per
scene.

    python -m sph_sm_monodomain_tpu_torch.tools.roofline --scene biceps_full \
        [--impl v4|v3|v5|v1|v2] [--steps 200] [--peak FLOPS]

For a scene it reports, beside the card's name and power limit:

  slots/query     candidate rows the scene's sweep kernels walk per query
                  row, from the first step's bookkeeping (the kernels walk
                  each window, slab or v1 run exactly)
  pairs/query     of the pairs that pass the full cell mask, those inside
                  the B-spline (1e-12 < r^2 < 4h^2) and Poly6 (r < h)
                  supports, counted exactly at the first step (pair_counts)
  peak            fp32 FLOP/s of the FMA-chain probe (K10, csrc/roofline.cu)
                  measured on this card, an FMA counted as 2
  % of peak       the sweeps' FLOPs per step over the step time (CUDA
                  events) over the measured peak

FLOPs are counted from the CUDA kernel bodies (csrc/*.cu), not from the
Pallas bodies of the JAX tool's FLOPS_PER_SLOT_A / B: MASK_FLOPS for the
cell test of each enumerated slot, then PAIR_FLOPS for each pair the
function needs, as pair_counts counts them; chip_smoke.py's kernel bounds
take the same two functions.

The module also holds the card's data-sheet peaks, PEAK_FLOPS and
PEAK_BYTES, which bound every kernel in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from ..ablation.legacy_sweeps import sweep_bookkeeping
from ..ops import cuda_lib
from ..ops import fused_step as fst
from ..ops.sweeps import (hash_axis_perm, sweep_bookkeeping2,
                          sweep_bookkeeping3, sweep_bookkeeping5)

# H100 SXM data sheet (NVIDIA): fp32 outside the tensor cores, HBM3 rate;
# both assume the 700 W power limit
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# FLOPs per pair of each sweep body (csrc/*.cu; a fused multiply-add counts
# 2, rsqrtf, sqrtf, fmaxf and a compare-select 1), charged only to the pairs
# the function needs: every pair that passes the full per-axis cell mask
# pays its distance and support test (8 + 2); then, inside the support of
# the kernel's weights (a pair outside it adds exactly 0):
#   sweep A: 15 for r < h (Poly6 density + XSPH)
#   sweep B: 40 for 1e-12 < r^2 < 4h^2 (rsqrt, Spiky pressure + viscosity,
#            B-spline Vm Laplacian)
#   bwd A:   43 for r < h (9 accumulators, both pair roles)
#   bwd B:   129 for 1e-12 < r^2 < 4h^2 (rsqrt, r, r/h, then 10
#            accumulators, both pair roles)
#   lap:     16 for 1e-12 < r^2 < 4h^2 (rsqrt, r, r/h, the q >= 2 test,
#            the relu-form B-spline W2 with its constant (8), vol*W2, two
#            accumulations (3))
# The v3 (hash9), v5 (slab), v2 and v1 sweeps compute sweep A's and sweep
# B's pair sums: the pairs they need do not depend on the enumeration
# (hash9's wrap pairs lie outside every support and add exactly 0), so they
# take K1's and K2's pair counts and FLOPs.
PAIR_FLOPS = {
    "sweep_a3": (("full", 10), ("h", 15)),
    "sweep_b3": (("full", 10), ("2h", 40)),
    "sweep_lap3": (("full", 10), ("2h", 16)),
    "sweep_bwd_a": (("full", 10), ("h", 43)),
    "sweep_bwd_b": (("full", 10), ("2h", 129)),
}
PAIR_FLOPS.update({a: PAIR_FLOPS["sweep_a3"] for a in (
    "sweep_a3_hash9", "sweep_a5", "sweep_a", "sweep_a2")})
PAIR_FLOPS.update({b: PAIR_FLOPS["sweep_b3"] for b in (
    "sweep_b3_hash9", "sweep_b5", "sweep_b", "sweep_b2")})
# the cell test of one enumerated slot (sweep A, sweep B), per generation:
# v4 |q - c| <= 1 on cyz (sub, abs, compare), and on cx too in sweep B
# (and in A on a grid finer than h); v3 / v2 the same on the linear hash;
# v5 the three per-axis tests; v1 none (its runs are exact)
MASK_FLOPS = {"v4": (3, 6), "v3": (3, 3), "v2": (3, 3), "v5": (9, 9),
              "v5s": (9, 9), "v1": (0, 0)}

# K10: chains per thread (csrc/roofline.cu kChains), threads per block,
# blocks per SM, and the two chain lengths measure_vpu_peak times
FMA_CHAINS, FMA_THREADS, FMA_BLOCKS_PER_SM = 16, 256, 4
FMA_ITERS = (100_000, 900_000)
FMA_MULT = 1.0000001
# the kernel against its plain version: float32 ulps of the chain sum (both
# round each step once; see fma_chains_plain)
FMA_ULP_TOL = 2.0


def fma_chains_plain(x: torch.Tensor, iters: int,
                     chains: int = FMA_CHAINS) -> torch.Tensor:
    """Plain PyTorch version of the FMA-chain probe: for each element of
    x, `chains` chains a_k = x * (1 + 0.001 k), then `iters` times a_k =
    fmaf(a_k, 1.0000001f, 0.5f), summed in chain order. Each chain step is
    rounded to float32 once, as fmaf rounds it: the product of two float32
    is exact in float64, and so is its sum with 0.5 while |a_k| >= 2^-6
    (the bits then span at most 53), so the one rounding to float32 is
    fmaf's. A smaller |a_k| (an input near 0, or a chain crossing 0) rounds
    in float64 first, which moves the float32 step only on an exact tie,
    and then by one float32 ulp of that step."""
    mult = torch.tensor([1.0 + 0.001 * k for k in range(chains)],
                        dtype=x.dtype, device=x.device)
    fma_m = torch.tensor([float(np.float32(FMA_MULT))], dtype=torch.float64,
                         device=x.device)
    half = torch.tensor([0.5], dtype=torch.float64, device=x.device)
    a = x[None, :] * mult[:, None]
    for _ in range(iters):
        # float32 * (1,) float64 promotes to float64: exact product
        a = torch.addcmul(half, a, fma_m).to(x.dtype)
    s = a[0]
    for k in range(1, chains):
        s = s + a[k]
    return s


def ulp_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in float32 ulps of want (the spacing above
    |want|): how the FMA-chain kernel is held to its plain version."""
    w = want.abs()
    ulp = torch.nextafter(w, torch.full_like(w, float("inf"))) - w
    return float(((got - want).abs() / ulp).max())


def fma_chains(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The FMA-chain probe over the f32 vector x, one thread per element
    (FMA_CHAINS chains each): on a CUDA tensor the K10 kernel, on a CPU
    tensor its plain version."""
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 vector")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return fma_chains_plain(x, iters)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = cuda_lib.load().sph_fma_chains(x.data_ptr(), out.data_ptr(),
                                            x.numel(), iters, FMA_THREADS,
                                            stream)
    if rc != 0:
        raise RuntimeError(f"sph_fma_chains: CUDA error {rc} "
                           f"({cuda_lib.error_string(rc)})")
    fma_chains.launches += 1
    return out


fma_chains.launches = 0


def fma_probe_input(device) -> torch.Tensor:
    """The probe's input: FMA_BLOCKS_PER_SM blocks of FMA_THREADS threads
    on every SM of the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return torch.ones(sms * FMA_BLOCKS_PER_SM * FMA_THREADS, device=device)


def measure_vpu_peak(device="cuda", reps: int = 3) -> float:
    """Achieved fp32 FLOP/s of the FMA-chain kernel (an FMA counts 2, the
    JAX probe's multiply + add) on the card. As in the JAX tool, two
    launches of different lengths are timed (CUDA events, best of `reps`
    after a warm-up) and the FLOP difference is divided by the time
    difference, so launch overhead cancels. Raises without a GPU: there is
    no CPU timing."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("measure_vpu_peak needs an NVIDIA GPU")
    x = fma_probe_input(device)
    best = {}
    for it in FMA_ITERS:
        fma_chains(x, it)
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fma_chains(x, it)
            end.record()
            torch.cuda.synchronize(device)
            best[it] = min(best.get(it, float("inf")),
                           start.elapsed_time(end) * 1e-3)
    small, big = FMA_ITERS
    flops = (big - small) * FMA_CHAINS * 2 * x.numel()
    return flops / max(best[big] - best[small], 1e-12)


def scene_slot_stats(pts: np.ndarray, cfg, impl: str, sub_q: int,
                     kb: int = 0, w_chunk: int = 128) -> dict:
    """Host-side recount of the JAX kernels' tested and true candidate
    lanes over the initial cloud (a copy of the JAX tool's function, with
    its 128-aligned v4 windows and w_chunk-wide chunks: the TPU's
    enumeration, kept for comparison; `walked_per_row` counts what the
    port's kernels walk). Unlike the JAX one it returns no subsample of
    query points: `pair_counts` counts every needed pair exactly. impl "v5" counts the packed slabs, any other the
    v4 merged windows."""
    fa, ma, sa = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]
    num_cells = cfg.num_cells
    coords = (pts / cfg.cell_size).astype(np.int64)
    g = np.asarray(cfg.grid_size)
    inside = ((coords >= 0) & (coords < g[None, :])).all(1)
    ids = np.where(inside, coords[:, fa] + gf * (coords[:, ma]
                                                 + gm * coords[:, sa]),
                   num_cells)
    cap = ((len(ids) + 127) // 128) * 128
    s = np.full(cap, num_cells, np.int64)
    s[:len(ids)] = np.sort(ids)
    b = cap // sub_q
    h_lo = s[::sub_q][:b]
    h_hi = s[sub_q - 1::sub_q][:b]

    if impl == "v5":
        offs = np.array([gf * dm + gf * gm * ds
                         for ds in (-1, 0, 1) for dm in (-1, 0, 1)])
        lo = np.searchsorted(s, np.clip(h_lo[:, None] + offs - 1,
                                        0, num_cells))
        hi = np.searchsorted(s, np.clip(h_hi[:, None] + offs + 2,
                                        0, num_cells))
        lo2 = lo.copy()
        for r in range(1, 9):
            lo2[:, r] = np.maximum(lo2[:, r], hi[:, r - 1])
        tot = np.maximum(hi - lo2, 0).sum(1)
        trips = np.maximum(
            (np.minimum(tot, kb or 10 ** 9) + w_chunk - 1) // w_chunk, 1)
        slots = int((trips * w_chunk).sum()) * sub_q
        pool = b * (kb or int(trips.max() * w_chunk))
    else:  # v4 merged windows
        d = (np.array([-1, 0, 1], np.int64) * (gf * gm))[None, :]
        lo = np.searchsorted(s, np.clip(h_lo[:, None] + d - (gf + 1),
                                        0, num_cells))
        hi = np.searchsorted(s, np.clip(h_hi[:, None] + d + (gf + 2),
                                        0, num_cells))
        start = (lo // 128) * 128
        trips = np.maximum(0, -(-(hi - start) // w_chunk))
        slots = int((trips * w_chunk).sum()) * sub_q
        pool = 0

    # stencil-true + within-2h counts via cell occupancy
    c = coords[inside]
    occ = np.zeros(tuple(g), np.int64)
    np.add.at(occ, (c[:, 0], c[:, 1], c[:, 2]), 1)
    pad = np.pad(occ, 1)
    sten = sum(pad[1 + dx:g[0] + 1 + dx, 1 + dy:g[1] + 1 + dy,
                   1 + dz:g[2] + 1 + dz]
               for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1))
    stencil_true = int(sten[c[:, 0], c[:, 1], c[:, 2]].sum())

    return {"slots_per_query": slots / cap, "stencil_true":
            stencil_true / max(len(c), 1), "pool_slots": pool,
            "n": len(c), "cap": cap}


def pair_counts(fs, lo, hi, cfg, sub_q: int) -> dict:
    """Pairs the sweeps need on these sorted inputs (a QM matrix fs and
    the v4 windows lo / hi of its sub_q-row sub-blocks), counted on fs's
    device from the windows and the exact full cell mask (query and
    candidate live): {"full": every pair the mask passes, "h": of those,
    r^2 < h^2, "2h": 1e-12 < r^2 < 4h^2}. The windows hold every pair the
    mask passes, so the counts do not depend on sub_q."""
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


def scene_pair_counts(scene, sub_q: int = 128) -> dict:
    """pair_counts over the scene's first-step cloud (v4 bookkeeping at
    sub_q-row sub-blocks, whatever generation the scene runs: the pairs
    the sweeps need do not depend on how they enumerate candidates)."""
    st, cfg = scene.state, scene.cfg
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                   sub_q)
    fs, _ = fst.build_qm_feats(st, cx, cyz, order)
    return pair_counts(fs, lo, hi, cfg, sub_q)


def pair_flops(name: str, counts: dict) -> int:
    """FLOPs the kernel `name` needs for these pair counts (PAIR_FLOPS)."""
    return sum(counts[k] * f for k, f in PAIR_FLOPS[name])


def walked_per_row(scene) -> float:
    """Candidate rows the scene's sweep kernels walk per query row (the
    mean over all rows, padding included) at the scene's first step: v4 /
    v3 / v2 each sub-block's windows, v5 its slab's filled chunks, v1 each
    row's own runs."""
    st, cfg, impl = scene.state, scene.cfg, scene.fused_impl
    n, sub_q = st.capacity, scene.sub_block
    if impl == "v1":
        _, _, qs, qe, _, _ = sweep_bookkeeping(st.pos, st.active, cfg, sub_q)
        return float((qe - qs).sum()) / n
    if impl in ("v5", "v5s"):
        trips = sweep_bookkeeping5(st.pos, st.active, cfg, sub_q,
                                   scene.pack_cap, scene.block_window)[3]
        per = trips * scene.block_window
        return float(torch.clamp(per, max=scene.pack_cap).sum()) * sub_q / n
    book = sweep_bookkeeping3 if impl == "v4" else sweep_bookkeeping2
    lo, hi = book(st.pos, st.active, cfg, sub_q)[2:4]
    return float((hi - lo).sum()) * sub_q / n


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0]


def step_ms(scene, steps: int) -> float:
    """Device ms per fused step of the scene's generation, CUDA events over
    `steps` chained steps after a warm-up step."""
    from ..models.monodomain import simulate

    def run(k):
        return simulate(scene.state, scene.cfg, k, sub_q=scene.sub_block,
                        impl=scene.fused_impl, pack_cap=scene.pack_cap,
                        w_chunk=scene.block_window)

    with torch.no_grad():
        run(1)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run(steps)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def report(scene_name: str = "biceps_full", impl: str | None = None,
           steps: int = 200, peak: float | None = None,
           replicate: int = 1) -> dict:
    """Print the scene's roofline report (see the module docstring) and
    return its numbers: {"card", "walked", "pairs", "step_ms",
    "peak_flops", "sweep_flops", "share_of_peak"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline tool measures the card: it needs "
                           "an NVIDIA GPU")

    from ..utils.io import build_scene, scene_positions
    card = card_line()
    sc = build_scene(scene_name, replicate=replicate, fused_impl=impl)
    cfg = sc.cfg
    pts = scene_positions(scene_name, cfg, replicate)
    stats = scene_slot_stats(pts, cfg, sc.fused_impl, sc.sub_block or 128,
                             sc.pack_cap, w_chunk=sc.block_window)

    counts = scene_pair_counts(sc)
    walked = walked_per_row(sc)
    ms = step_ms(sc, steps)
    peak = peak or measure_vpu_peak()
    n, rows = stats["n"], sc.state.capacity
    mask_a, mask_b = MASK_FLOPS[sc.fused_impl]
    if sc.fused_impl == "v4" and cfg.cell_size < cfg.kernel_h:
        mask_a = mask_b
    flops = (rows * walked * (mask_a + mask_b) + pair_flops("sweep_a3", counts)
             + pair_flops("sweep_b3", counts))
    share = flops / (ms * 1e-3) / peak
    print(f"card: {card}")
    print(f"scene={scene_name} n={n} impl={sc.fused_impl} "
          f"sub_q={sc.sub_block} kb={sc.pack_cap}")
    print(f"  slots/query walked : {walked:8.1f} (the JAX tool's lane "
          f"count: {stats['slots_per_query']:.1f})")
    print(f"  in-stencil   /query: {counts['full'] / n:8.1f} (useful "
          f"fraction {counts['full'] / (rows * walked):.2f}; the cell "
          f"occupancy count: {stats['stencil_true']:.1f})")
    print(f"  within-2h    /query: {counts['2h'] / n:8.1f}   within-h: "
          f"{counts['h'] / n:6.1f}")
    print(f"  step time          : {ms:.4f} ms on {card} "
          f"({2 * rows * walked / (ms * 1e-3) / 1e9:.2f} G slots/s)")
    print(f"  measured fp32 peak : {peak / 1e12:.2f} TFLOP/s on {card} "
          f"(data sheet {PEAK_FLOPS / 1e12:.0f})")
    print(f"  sweep FLOPs / step : {flops / 1e6:.2f} M, "
          f"{share * 100.0:.3f}% of the measured peak over the whole step "
          "(sweeps only; glue and bookkeeping excluded from the FLOPs)",
          flush=True)
    return {"card": card, "walked": walked, "pairs": counts, "step_ms": ms,
            "peak_flops": peak, "sweep_flops": float(flops),
            "share_of_peak": float(share)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="biceps_full")
    ap.add_argument("--replicate", type=int, default=1)
    ap.add_argument("--impl", default=None,
                    choices=("v1", "v2", "v3", "v4", "v5", "v5s"))
    ap.add_argument("--steps", type=int, default=200,
                    help="fused steps timed with CUDA events")
    ap.add_argument("--peak", type=float, default=None,
                    help="known fp32 peak in FLOP/s (from a prior run of "
                         "measure_vpu_peak on this card); omit to measure")
    args = ap.parse_args(argv)
    report(args.scene, args.impl, args.steps, args.peak, args.replicate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
