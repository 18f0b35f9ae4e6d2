"""The walk of the warp-trimmed v4 sweeps (csrc/sweep_common.cuh
for_each_warp_candidate, run by the sweep-B and Laplacian kernels), modelled
in numpy on the CPU: every pair that the plain versions' full cell mask
admits is staged by exactly one warp slice, in the window whose offset
admits it, and the staged candidates are fewer than the windows hold.

The model follows the kernel step for step: 32 consecutive sorted rows a
warp, `slices` warps each taking the slice-th equal part of the sub-block's
three windows laid end to end, and a candidate staged when its cell lies in
[min qcyz + d - 1, max qcyz + d + 1] x [min qcx - 1, max qcx + 1] over the
warp's live rows. The kernel itself is held to the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3
from sph_sm_monodomain_tpu_torch.utils.io import ASSETS_DIR


def _state(case):
    rng = np.random.default_rng(7)
    cfg = T.SimConfig()
    if case == "slice":
        pts = T.read_cloud_csv(ASSETS_DIR / "biceps_simple_out_18475.csv")[::40]
    elif case == "sparse":   # two clusters far apart: overlapping windows
        pts = np.concatenate([rng.random((48, 3)) * 0.08 + 0.05,
                              rng.random((48, 3)) * 0.08 + 1.3])
    else:                    # scattered: short and empty windows
        pts = rng.random((40, 3)) * 1.4 + 0.05
    return cfg, T.init_fluid(np.asarray(pts, np.float32), cfg, device="cpu")


def staged_pairs(cx, cyz, lo, hi, sub_q, g_mid, slices):
    """{(query row, candidate row, window): times staged} for the rows the
    kernel's warps would pair, and the number of staged (warp, candidate)
    slots."""
    n = cx.shape[0]
    live = cx >= 0.0
    got, slots = {}, 0
    for w0 in range(0, n, 32):
        rows = np.arange(w0, w0 + 32)
        lv = rows[live[rows]]
        if lv.size == 0:
            continue
        b = w0 // sub_q
        xlo, xhi = cx[lv].min() - 1.0, cx[lv].max() + 1.0
        clo, chi = cyz[lv].min(), cyz[lv].max()
        los, lens = lo[4 * b:4 * b + 3], np.maximum(
            hi[4 * b:4 * b + 3] - lo[4 * b:4 * b + 3], 0)
        total = int(lens.sum())
        for s in range(slices):
            s0, s1 = total * s // slices, total * (s + 1) // slices
            off = 0
            for r in range(3):
                a = los[r] + max(s0 - off, 0)
                e = los[r] + min(s1 - off, lens[r])
                off += lens[r]
                d = float((r - 1) * g_mid)
                for j in range(a, e):
                    if not (clo + d - 1.0 <= cyz[j] <= chi + d + 1.0
                            and xlo <= cx[j] <= xhi):
                        continue
                    slots += 1
                    for q in lv:
                        if (abs(cyz[q] + d - cyz[j]) <= 1.0
                                and abs(cx[q] - cx[j]) <= 1.0):
                            key = (int(q), int(j), r)
                            got[key] = got.get(key, 0) + 1
    return got, slots


# csrc/fused_sweeps.cu warp_slices picks 2, 4, 8 or 16 warps per 32 rows
@pytest.mark.parametrize("slices", [2, 4, 16])
@pytest.mark.parametrize("case", ["slice", "sparse", "scattered"])
@pytest.mark.parametrize("sub_q", [32, 128])
def test_warp_walk_stages_every_admitted_pair_once(case, sub_q, slices):
    cfg, st = _state(case)
    if st.capacity % sub_q:
        pytest.fail(f"capacity {st.capacity} is not a multiple of {sub_q}")
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                   sub_q)
    cx_s, cyz_s = cx[order].numpy(), cyz[order].numpy()
    g_mid = fst._g_mid(cfg)
    got, slots = staged_pairs(cx_s, cyz_s, lo.numpy(), hi.numpy(), sub_q,
                              g_mid, slices)
    # the plain versions' mask (fused_step._stencil, full), dense
    q = torch.from_numpy(np.stack([cx_s, cyz_s], 1))
    fs = torch.zeros((cx_s.shape[0], 16))
    fs[:, 12:14] = q
    want = fst._stencil(fs, fs.T, float(g_mid), True).numpy()
    pairs = {(int(i), int(j)) for i, j in zip(*np.nonzero(want))}
    assert {(i, j) for i, j, _ in got} == pairs
    assert all(v == 1 for v in got.values())
    # a pair passes under one window offset only (G_mid >= 3)
    assert len(got) == len(pairs)
    windows = int((hi - lo).clamp(min=0).sum()) * sub_q
    assert slots * 32 <= windows
