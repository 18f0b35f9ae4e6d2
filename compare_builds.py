"""Hold this checkout's CUDA kernels against another build of csrc/ on the
card.

A redesign of some kernels must leave every other kernel bit-identical, and
its gain is read against the old build in the same call. This script builds
the checkout's `sph_sm_monodomain_tpu_torch/csrc/` and another copy of that
directory (for example a parent commit's, unpacked into a git-ignored
directory with `git archive <commit> sph_sm_monodomain_tpu_torch/csrc | tar
-x -C build/parent`) side by side, then on the biceps_full step-0 inputs:

  1. holds the warp-sliced kernels of this build, sweep A (K1) and sweep B
     (K2), each with and without EP and with dynp, the Laplacian sweep
     (K3: forward and backward forms), the backward sweeps (K4, and K5
     with and without dynp, on seeded random cotangents), the v3 hash9
     sweeps (K6 A and B, with and without EP and with dynp), the v5 slab
     sweeps (K7 A and B, with and without EP, over the trips and the whole
     slab), the v2 raw-sum sweeps (K9 A and B at sub_q 128 and 32, on
     the inputs the v2 step gives them) and the v1 run sweeps (K8 A and
     B, on the inputs the v1 step gives them), to their plain versions
     per column within 1e-5 * max(1, max|plain|), and two launches of each
     to the same bits;
  2. prints, for every kernel this csrc/ did not redesign (`REDESIGNED`:
     K8 here, so K1-K7, K9 and K10), whether the two builds give the same
     bits, and fails where they do not;
  3. times K1-K5, K6 A / B, K7 A / B, K8 A / B, K9 A / B (sub_q 128 and
     32) and a CSR SpMV of K3's operator in both builds in turns (other,
     this, this, other), then K1, K3, K4, K5, K6 A / B, K8 A / B and K9 A
     / B on biceps_full x56 the same way;
  4. with --slices, also builds this csrc/ with the warp-slice count of
     the sliced kernels fixed to each value, checks each against the plain
     versions, and times them in turns beside the build's own choice, on
     biceps_full and on x56;
  5. reads both builds' sliced kernels and the SpMV once more from a
     torch.profiler trace: device time only, without the wrappers' host
     overhead.

Run on the card, from the checkout's root:
    python3 compare_builds.py --other build/parent/sph_sm_monodomain_tpu_torch/csrc \\
        [--slices 2 4 8 16]
Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.models import variants
from sph_sm_monodomain_tpu_torch.ops import cuda_lib
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as fad
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3
from sph_sm_monodomain_tpu_torch.tools import roofline

OUT_DIR = cuda_lib.BUILD_DIR.parent / "compare"
# the kernels timed in turns: (label, entry of the sliced kernels)
TIMED = (("K1", "K1"), ("K2", "K2"), ("K3", "K3 forward"), ("K4", "K4"),
         ("K5", "K5"), ("K6 A", "K6 A"), ("K6 B", "K6 B"), ("K7 A", "K7 A"),
         ("K7 B", "K7 B"), ("K8 A", "K8 A"), ("K8 B", "K8 B"),
         ("K9 A", "K9 A"), ("K9 B", "K9 B"),
         ("K9 A sub_q 32", "K9 A sub_q 32"),
         ("K9 B sub_q 32", "K9 B sub_q 32"))
# what torch.profiler's kernel names hold, by kernel
KERNEL_NAMES = {"K1": "sweep_a3_xyz3", "K2": "sweep_b3_xyz3",
                "K3": "sweep_lap3", "K4": "sweep_bwd_a", "K5": "sweep_bwd_b",
                "K6 A": "sweep_a3_hash9", "K6 B": "sweep_b3_hash9",
                "K7 A": "sweep_a5", "K7 B": "sweep_b5", "K8 A": "sweep_a1",
                "K8 B": "sweep_b1", "K9 A": "sweep_a2",
                "K9 B": "sweep_b2", "K9 A sub_q 32": "sweep_a2",
                "K9 B sub_q 32": "sweep_b2"}
# the kernels this csrc/ redesigned: they may differ from the other build
# in the last bits; every other kernel must not
REDESIGNED = ("K8",)
# chip_smoke.hash9_sweeps' and v1_sweeps' kernels by label
BIG_LABELS = {"sweep_a3_hash9": "K6 A", "sweep_b3_hash9": "K6 B",
              "sweep_a2": "K9 A", "sweep_b2": "K9 B", "sweep_a": "K8 A",
              "sweep_b": "K8 B"}
# the line of warp_slices (csrc/sweep_common.cuh) that --slices overrides
SLICES_FILE, SLICES_LINE = "sweep_common.cuh", "  int slices = 2;\n"


def fixed_slices_csrc(k: int) -> Path:
    """A copy of this csrc/ whose sliced launches (every kernel but K10)
    take k warp slices."""
    d = OUT_DIR / f"slices{k}" / "csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC_DIR, d)
    src = (d / SLICES_FILE).read_text()
    if SLICES_LINE not in src:
        raise RuntimeError("warp_slices changed: update SLICES_LINE")
    (d / SLICES_FILE).write_text(src.replace(
        SLICES_LINE, f"  int slices = {k};\n  if (slices) return slices;\n"))
    return d


def build_all(other: Path, slices) -> dict:
    """{label: bound library}: this build, the other, and the fixed-slice
    variants, compiled in parallel."""
    jobs = {"this": (None, None), "other": (other, OUT_DIR / "other")}
    jobs.update({k: (fixed_slices_csrc(k), OUT_DIR / f"slices{k}")
                 for k in slices})
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(
            lambda j: cuda_lib.build(csrc=j[0], build_dir=j[1]),
            jobs.values())))
    return {label: cuda_lib.bind(p) for label, p in paths.items()}


def run_on(lib, fn):
    """fn() with every wrapper launching from `lib`, synchronized."""
    saved, cuda_lib._lib = cuda_lib._lib, lib
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        cuda_lib._lib = saved


def flat(out):
    """A kernel's output, or a tuple of them, as one 1-D tensor."""
    if torch.is_tensor(out):
        return out.reshape(-1)
    return torch.cat([flat(t) for t in out])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="another copy of sph_sm_monodomain_tpu_torch/csrc")
    ap.add_argument("--slices", type=int, nargs="*", default=[],
                    choices=[2, 4, 8, 16])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_builds.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(roofline.card_line(), flush=True)
    libs = build_all(args.other.resolve(), args.slices)
    cuda_lib._lib = libs["this"]
    fails = []

    def check(name, got, want):
        _, ratio, _ = cs.column_errors(got, want)
        ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
        print(f"{name}: worst column at {ratio:.4g} of the bound -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fails.append(name)

    scene = T.build_scene("biceps_full", device=dev)
    cfg, sq = scene.cfg, scene.sub_block
    fs, fa, lo, hi = cs.step0_inputs(scene, dev)
    out_a = fst.sweep_a3_plain(fs, fa, cfg)
    fb = fst.feats_b(out_a)
    dynp = fst.build_dynp(T.resolve_params(cfg, {"k_stiffness": 0.8,
                                                 "mu_viscosity": 40.0}), dev)
    rng = np.random.default_rng(0)
    n = fs.shape[0]

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    tab = variants.monodomain_prepare_fused(scene.state, cfg, sub_q=sq)
    vm_r, g_r = rand(n) * 10.0, rand(n)
    geom = (tab.pos_s, tab.cx_s, tab.cyz_s)
    lap_in = {"forward": variants._lap_inputs(vm_r, tab.vol_s, vm_r, *geom),
              "backward": variants._lap_inputs(torch.zeros_like(g_r),
                                               torch.ones_like(g_r), g_r,
                                               *geom)}
    sc5 = T.build_scene("biceps_full", fused_impl="v5", device=dev)
    fs5, src5, trips5, _ = cs.step0_inputs_v5(sc5)
    pa5 = fst.pack_feats_a5(fs5, src5, sc5.pack_cap)
    oa5 = fst.sweep_a5_plain(fs5, pa5, cfg)
    pb5 = fst.pack_feats_b5(oa5, fst.vol_now(oa5), src5, sc5.pack_cap)
    kw5 = dict(sub_q=sc5.sub_block, w_chunk=sc5.block_window)
    qa = fad.bwd_a_query(fs, rand(n), rand(n, 3))
    qb = fad.bwd_b_query(out_a, rand(n, 3), rand(n))
    fqa, fqb = qa.T.contiguous(), qb.T.contiguous()
    forms = {"": {}, " no_ep": {"with_ep": False}, " dynp": {"dynp": dynp}}
    forms5 = {"": {}, " no_ep": {"with_ep": False},
              " static": {"static_trips": True}}
    sc3 = T.build_scene("biceps_full", fused_impl="v3", device=dev)
    fs3, fa3, lo3, hi3 = cs.step0_inputs_v3(sc3)
    oa3 = fst.sweep_a3_plain(fs3, fa3, cfg, stencil="hash9")
    fb3 = fst.feats_b(oa3)
    sq3 = sc3.sub_block
    sc2 = T.build_scene("biceps_full", fused_impl="v2", device=dev)
    raw = {}
    for sq9 in (sc2.sub_block, 32):
        calls = cs.raw_sweep_calls(sc2._replace(sub_block=sq9))
        tag = "" if sq9 == sc2.sub_block else f" sub_q {sq9}"
        for k, name in zip(("A", "B"), cs.RAW_SWEEPS["v2"]):
            raw[f"K9 {k}{tag}"] = cs.raw_launchers(name, calls[name])
    calls = cs.raw_sweep_calls(T.build_scene("biceps_full", fused_impl="v1",
                                             device=dev))
    for k, name in zip(("A", "B"), cs.RAW_SWEEPS["v1"]):
        raw[f"K8 {k}"] = cs.raw_launchers(name, calls[name])
    sliced = {
        **{f"K1{tag}": (lambda kw=kw: fst.sweep_a3(fs, fa, lo, hi, cfg,
                                                   sub_q=sq, **kw),
                        lambda kw=kw: fst.sweep_a3_plain(
                            fs, fa, cfg, kw.get("with_ep", True),
                            kw.get("dynp")))
           for tag, kw in forms.items()},
        **{f"K2{tag}": (lambda kw=kw: fst.sweep_b3(out_a, fb, lo, hi, cfg,
                                                   sub_q=sq, **kw),
                        lambda kw=kw: fst.sweep_b3_plain(out_a, fb, cfg,
                                                         **kw))
           for tag, kw in forms.items()},
        **{f"K3 {form}": (lambda q=q, f=f: fst.sweep_lap3(
            q, f, tab.blk_lo, tab.blk_hi, cfg, sq),
                          lambda q=q, f=f: fst.sweep_lap3_plain(q, f, cfg))
           for form, (q, f) in lap_in.items()},
        "K4": (lambda: fad.sweep_bwd_a(qa, fqa, lo, hi, cfg, sq),
               lambda: fad.sweep_bwd_a_plain(qa, fqa, cfg)),
        **{f"K5{tag}": (lambda d=d: fad.sweep_bwd_b(qb, fqb, lo, hi, cfg, sq,
                                                    dynp=d),
                        lambda d=d: fad.sweep_bwd_b_plain(qb, fqb, cfg, d))
           for tag, d in (("", None), (" dynp", dynp))},
        **{f"K6 A{tag}": (lambda kw=kw: fst.sweep_a3_hash9(
            fs3, fa3, lo3, hi3, cfg, sub_q=sq3, **kw),
                          lambda kw=kw: fst.sweep_a3_plain(
                              fs3, fa3, cfg, kw.get("with_ep", True),
                              kw.get("dynp"), "hash9"))
           for tag, kw in forms.items()},
        **{f"K6 B{tag}": (lambda kw=kw: fst.sweep_b3_hash9(
            oa3, fb3, lo3, hi3, cfg, sub_q=sq3, **kw),
                          lambda kw=kw: fst.sweep_b3_plain(
                              oa3, fb3, cfg, kw.get("with_ep", True),
                              kw.get("dynp"), "hash9"))
           for tag, kw in forms.items()},
        **raw,
        **{f"K7 A{tag}": (lambda kw=kw: fst.sweep_a5(fs5, pa5, trips5, cfg,
                                                     **kw5, **kw),
                          lambda kw=kw: fst.sweep_a5_plain(
                              fs5, pa5, cfg, kw.get("with_ep", True)))
           for tag, kw in forms5.items()},
        **{f"K7 B{tag}": (lambda kw=kw: fst.sweep_b5(oa5, pb5, trips5, cfg,
                                                     **kw5, **kw),
                          lambda kw=kw: fst.sweep_b5_plain(
                              oa5, pb5, cfg, kw.get("with_ep", True)))
           for tag, kw in forms5.items()}}
    want = {name: plain() for name, (_, plain) in sliced.items()}
    for label in ["this"] + args.slices:
        for name, (kernel, _) in sliced.items():
            a, b = run_on(libs[label], kernel), run_on(libs[label], kernel)
            tag = name if label == "this" else f"{name} at {label} slices"
            check(tag, a, want[name])
            if not torch.equal(a, b):
                fails.append(f"{tag}: two launches differ")
        if label == "this":
            for name, (kernel, _) in sliced.items():
                d = (run_on(libs["this"], kernel)
                     - run_on(libs["other"], kernel)).abs().max()
                print(f"{name}: max abs difference from the other build "
                      f"{float(d):.4g}", flush=True)

    # every kernel not redesigned since the other build: the same bits
    x = rand(roofline.fma_probe_input(dev).numel())
    others = {
        "K10": lambda: roofline.fma_chains(x, 4096),
        **{name: kernel for name, (kernel, _) in sliced.items()
           if not name.startswith(REDESIGNED)}}
    identical = {}
    for name, fn in others.items():
        identical[name] = torch.equal(flat(run_on(libs["this"], fn)),
                                      flat(run_on(libs["other"], fn)))
        print(f"{name}: bit-identical to the other build: "
              f"{identical[name]}", flush=True)
        if not identical[name]:
            fails.append(f"{name} differs from the other build")

    # times in turns
    qm_f, ft_f = lap_in["forward"]
    csr = cs.laplacian_csr(qm_f, ft_f, cfg)
    vcol = vm_r[:, None]
    big = T.build_scene("biceps_full", replicate=cs.REPLICATE, device=dev)
    bt = variants.monodomain_prepare_fused(big.state, big.cfg,
                                           sub_q=big.sub_block)
    vb = torch.from_numpy(np.random.default_rng(1).standard_normal(
        big.state.capacity).astype(np.float32) * 10.0).to(dev)
    qb_, fb_ = variants._lap_inputs(vb, bt.vol_s, vb, bt.pos_s, bt.cx_s,
                                    bt.cyz_s)
    order_b, _, lo_b, hi_b, cx_b, cyz_b = sweep_bookkeeping3(
        big.state.pos, big.state.active, big.cfg, big.sub_block)
    fs_b, fa_b = fst.build_qm_feats(big.state.replace(vm=vb), cx_b, cyz_b,
                                    order_b)
    nb, bsq = big.state.capacity, big.sub_block
    oa_b = fst.sweep_a3(fs_b, fa_b, lo_b, hi_b, big.cfg, sub_q=bsq)
    qa_b = fad.bwd_a_query(fs_b, rand(nb), rand(nb, 3))
    qb_b = fad.bwd_b_query(oa_b, rand(nb, 3), rand(nb))
    fqa_b, fqb_b = qa_b.T.contiguous(), qb_b.T.contiguous()
    big_runs = {
        "K1": lambda: fst.sweep_a3(fs_b, fa_b, lo_b, hi_b, big.cfg,
                                   sub_q=bsq),
        "K3": lambda: fst.sweep_lap3(qb_, fb_, bt.blk_lo, bt.blk_hi,
                                     big.cfg, bsq),
        "K4": lambda: fad.sweep_bwd_a(qa_b, fqa_b, lo_b, hi_b, big.cfg, bsq),
        "K5": lambda: fad.sweep_bwd_b(qb_b, fqb_b, lo_b, hi_b, big.cfg,
                                      bsq),
        **{BIG_LABELS[name]: launch for name, (launch, _, _) in {
            **cs.hash9_sweeps(*cs.hash9_inputs(big.state, big.cfg, bsq),
                              big.cfg, bsq),
            **cs.v1_sweeps(big.state, big.cfg, bsq)}.items()}}
    for kname, run in big_runs.items():
        ref = run_on(libs["this"], run)
        for label in args.slices:
            d = float((run_on(libs[label], run) - ref).abs().max())
            print(f"x{cs.REPLICATE} {kname} at {label} slices: max abs "
                  f"difference from this build's {d:.4g} (max |{kname}| "
                  f"{float(ref.abs().max()):.4g})", flush=True)
    order = (["other", "this", "this", "other"] + args.slices
             + args.slices[::-1])
    times = []
    for label in order:
        cuda_lib._lib = libs[label]
        t = {"build": label,
             **{k: cs.cuda_ms(sliced[r][0], 200) for k, r in TIMED},
             "SpMV": cs.cuda_ms(lambda: csr @ vcol, 200),
             **{f"x{cs.REPLICATE} {k}": cs.cuda_ms(run, 20)
                for k, run in big_runs.items()}}
        times.append(t)
        name = label if isinstance(label, str) else f"{label} slices"
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()
                                      if k != "build"), flush=True)
    device = {}
    for label in ("this", "other"):
        cuda_lib._lib = libs[label]
        device[label] = {
            **{k: cs.device_ms(sliced[r][0], 50, KERNEL_NAMES[k])
               for k, r in TIMED},
            "SpMV": cs.device_ms(lambda: csr @ vcol, 50),
            **{f"x{cs.REPLICATE} {k}": cs.device_ms(run, 10, KERNEL_NAMES[k])
               for k, run in big_runs.items()}}
        print(f"device time per launch (torch.profiler), {label} build: "
              + ", ".join(f"{k} {v:.4f} ms"
                          for k, v in device[label].items()), flush=True)
    cuda_lib._lib = libs["this"]
    print(json.dumps({"fails": fails, "identical": identical,
                      "times": times, "device_ms": device}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
