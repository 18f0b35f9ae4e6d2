"""The walks of the warp-trimmed sweeps (csrc/sweep_common.cuh), modelled
in numpy on the CPU.

- for_each_warp_candidate (the v4 sweeps A, B and the Laplacian sweep):
  every pair that the plain versions' full cell mask admits is staged by
  exactly one warp slice, in the window whose offset admits it, and the
  staged candidates are fewer than the windows hold. The model follows the
  kernel step for step: 32 consecutive sorted rows a warp, `slices` warps
  each taking the slice-th equal part of the sub-block's three windows
  laid end to end, and a candidate staged when its cell lies in
  [min qcyz + d - 1, max qcyz + d + 1] x [min qcx - 1, max qcx + 1] over
  the warp's live rows.
- Sweep A's x-trim: where Poly6's support fits one cell (cell_size >= h)
  the plain sweep A masks on cyz alone; the pairs it admits and the walk
  drops (|dcx| >= 2) have Poly6 t = max(h^2 - r^2, 0) == 0, or are dead
  candidates with zero mass and volume, so they add nothing.
- The backward sweeps (K4, K5) walk the cell features at rows 12 and 13
  of their feature matrix, the transposed backward query matrix: over
  those columns of bwd_a_query / bwd_b_query the walk stages every pair
  of the plain backward sweeps' stencil exactly once.
- for_each_warp_slab_candidate (the v5 slab sweeps): every (row, slot)
  pair of the plain slab mask is staged exactly once, at sub_q 16 (a
  warp's rows span two slabs), 32 and 64, and by the same slice whether
  the walk covers the trips' slots or the whole slab (v5s).

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as fad
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.sweeps import (auto_sweep5_params,
                                                    sweep_bookkeeping3,
                                                    sweep_bookkeeping5)
from sph_sm_monodomain_tpu_torch.utils.io import ASSETS_DIR


def _state(case):
    rng = np.random.default_rng(7)
    cfg = T.SimConfig()
    if case == "biceps_full":
        return cfg, T.build_scene("biceps_full", device="cpu").state
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


# csrc/sweep_common.cuh warp_slices picks 2, 4, 8 or 16 warps per 32 rows
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


@pytest.mark.parametrize("sweep", ["bwd_a", "bwd_b"])
def test_backward_walk_stages_every_stencil_pair_once(sweep):
    """The backward sweeps' query matrices keep the cells where the kernels'
    walk reads them: over the cx / cyz columns (12, 13) of bwd_a_query /
    bwd_b_query, at biceps_full's 16 slices, the walk stages every pair of
    the plain backward sweeps' stencil (fused_step._stencil over the query
    matrix and its transpose) exactly once."""
    cfg, st = _state("slice")
    sub_q, n = 128, st.capacity
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                   sub_q)
    fs, fa = fst.build_qm_feats(st, cx, cyz, order)
    rng = np.random.default_rng(3)
    cot = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    if sweep == "bwd_a":
        qm = fad.bwd_a_query(fs, cot(n), cot(n, 3))
    else:
        qm = fad.bwd_b_query(fst.sweep_a3_plain(fs, fa, cfg), cot(n, 3),
                             cot(n))
    assert torch.equal(qm[:, 12:14], fs[:, 12:14])
    g_mid = fst._g_mid(cfg)
    got, _ = staged_pairs(qm[:, 12].numpy(), qm[:, 13].numpy(), lo.numpy(),
                          hi.numpy(), sub_q, g_mid, 16)
    want = fst._stencil(qm, qm.T, float(g_mid), True).numpy()
    pairs = {(int(i), int(j)) for i, j in zip(*np.nonzero(want))}
    assert len(pairs) > n
    assert {(i, j) for i, j, _ in got} == pairs
    assert len(got) == len(pairs) and all(v == 1 for v in got.values())


@pytest.mark.parametrize("case", ["slice", "sparse", "scattered",
                                  "biceps_full"])
def test_sweep_a_x_trim_drops_only_zero_weights(case):
    """At the default cell_size == h, every live pair that sweep A's
    cyz-only mask admits and the walk's x-range drops (|dcx| >= 2) lies
    more than h apart: its float32 r^2 exceeds h^2 (t == 0), and so does
    its float64 r^2 by a margin far beyond any rounding of the kernel's
    r^2 (fused or not). The dead candidates it drops carry zero mass and
    volume in the sweep-A features."""
    cfg, st = _state(case)
    assert not fst._mask_a_full(cfg)
    sub_q = 128
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                   sub_q)
    fs, fa = fst.build_qm_feats(st, cx, cyz, order)
    pos, q_cx, q_cyz = fs[:, :3].numpy(), fs[:, 12].numpy(), \
        fs[:, 13].numpy()
    live = q_cx >= 0.0
    dead = ~live
    assert not fa[6:8].numpy()[:, dead].any()
    h2 = np.float32(fst.kernel_params(cfg, None, "cpu")[16 + 1])
    g_mid = fst._g_mid(cfg)
    lo, hi = lo.numpy(), hi.numpy()
    dropped, margin = 0, np.inf
    for b in range(pos.shape[0] // sub_q):
        q = np.arange(b * sub_q, (b + 1) * sub_q)
        q = q[live[q]]
        for r in range(3):
            j = np.arange(lo[4 * b + r], hi[4 * b + r])
            j = j[live[j]]
            d = float((r - 1) * g_mid)
            m = ((np.abs(q_cyz[q][:, None] + d - q_cyz[j][None, :]) <= 1.0)
                 & (np.abs(q_cx[q][:, None] - q_cx[j][None, :]) > 1.0))
            qi, ji = np.nonzero(m)
            if qi.size == 0:
                continue
            dp = pos[q[qi]] - pos[j[ji]]                    # float32
            r2 = dp[:, 0] * dp[:, 0] + dp[:, 1] * dp[:, 1] \
                + dp[:, 2] * dp[:, 2]
            assert (np.maximum(h2 - r2, np.float32(0.0)) == 0.0).all()
            dp64 = pos[q[qi]].astype(np.float64) - pos[j[ji]]
            margin = min(margin, float(((dp64 * dp64).sum(1) / h2).min()))
            dropped += qi.size
    assert dropped > 0 or case in ("sparse", "scattered")
    # float32 r^2 (fused or not) is within a few ulp (~1e-6) of float64
    assert margin > 1.0 + 1e-4, margin


def staged_slab_pairs(qc, slab_c, count, sub_q, slices):
    """{(query row, slab, slot, slice): times staged} and the number of
    staged (warp, slot) entries of the v5 slab walk: qc (N, 3) sorted query
    cells (cf < 0 on dead rows), slab_c (B, 3, kb) the slabs' cells, count
    (B,) the slots walked a slab."""
    n = qc.shape[0]
    got, slots = {}, 0
    for r0 in range(0, n, 32):
        rows = np.arange(r0, min(r0 + 32, n))
        live = qc[rows, 0] >= 0.0
        for b in range(r0 // sub_q, (rows[-1]) // sub_q + 1):
            mem = rows[live & (rows // sub_q == b)]
            if mem.size == 0:
                continue
            lo, hi = qc[mem].min(0) - 1.0, qc[mem].max(0) + 1.0
            for s in range(slices):
                # every slices-th pass of 32 slots, from pass s on
                for j in [j for p in range(s, -(-count[b] // 32), slices)
                          for j in range(32 * p, min(32 * p + 32,
                                                     count[b]))]:
                    c = slab_c[b, :, j]
                    if not ((c >= lo) & (c <= hi)).all():
                        continue
                    slots += 1
                    for q in mem[(np.abs(qc[mem] - c) <= 1.0).all(1)]:
                        key = (int(q), b, j, s)
                        got[key] = got.get(key, 0) + 1
    return got, slots


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("slices", [2, 16])
@pytest.mark.parametrize("case", ["slice", "sparse", "scattered"])
@pytest.mark.parametrize("sub_q", [16, 32, 64])
def test_slab_walk_stages_every_admitted_slot_once(case, sub_q, slices,
                                                   static):
    """Every (live row, slot) pair that the plain v5 sweeps' mask admits
    over the row's whole slab is staged exactly once by the walk over the
    trips' slots (or the whole slab, static_trips), and the staged slots
    are fewer than the slabs' walked slots times the warps that share
    them."""
    cfg, st = _state(case)
    pts = st.pos[st.active].numpy()
    w_chunk = 128
    kb = auto_sweep5_params(pts, cfg, sub_qs=(sub_q,))[1]
    order, _, src, trips, over, cf, cm, cs = sweep_bookkeeping5(
        st.pos, st.active, cfg, sub_q, kb, w_chunk)
    assert int(over) == 0
    cells = torch.stack([cf, cm, cs], 1)[order].numpy()
    pad = np.asarray([[fst._COORD_SENTINEL, 0.0, 0.0]], np.float32)
    nb = cells.shape[0] // sub_q
    slab_c = np.concatenate([cells, pad])[src.numpy()].reshape(
        nb, kb, 3).transpose(0, 2, 1)
    count = (np.full(nb, kb) if static
             else np.minimum(trips.numpy() * w_chunk, kb))
    got, slots = staged_slab_pairs(cells, slab_c, count, sub_q, slices)
    # the slice of a staged pair follows from its slot alone
    assert got == staged_slab_pairs(cells, slab_c, np.full(nb, kb), sub_q,
                                    slices)[0]
    q_live = np.nonzero(cells[:, 0] >= 0.0)[0]
    want = set()
    for q in q_live:
        b = q // sub_q
        ok = (np.abs(slab_c[b] - cells[q][:, None]) <= 1.0).all(0)
        want |= {(int(q), b, int(j)) for j in np.nonzero(ok)[0]}
    assert {k[:3] for k in got} == want and len(want) > 0
    assert len(got) == len(want) and all(v == 1 for v in got.values())
    warps_a_slab = max(sub_q // 32, 1)
    assert slots <= int(count.sum()) * warps_a_slab
