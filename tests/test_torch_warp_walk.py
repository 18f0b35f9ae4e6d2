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
- The same walk under HashWindows (the v3 sweeps K6 and the v2 sweeps K9):
  nine run windows a sub-block at stride 16 of the bounds, the linear
  hash in row 12, each window first trimmed by binary search to the run
  of hashes in [min qh + d_r - 1, max qh + d_r + 1] over the warp's live
  rows. Every pair that the plain hash9 mask admits is staged exactly once,
  by one slice, in the window whose offset admits it; fewer candidates are
  staged than the windows hold; and the trim is exact because the hash is
  nondecreasing inside every window and the windows hold live rows only.
- for_each_warp_run_candidate (the v1 sweeps K8): window r of a row warp
  is the union of its rows' nonempty runs r, cut at the widest gap
  between them where no run crosses. Every (row, j) pair of the plain v1
  mask (legacy_sweeps._run_sums) is staged exactly once, by one slice, in
  the window of the run that holds it, and a warp stages no more slots
  than the union of its rows' nonempty runs holds. Planted faults each
  fail it: an empty run (at row 0) counted into the union, a window's
  last row dropped, a slice end one row too far, a slice that skips its
  last pass of 32 slots, a window's end one row short. On biceps_full the
  mask's pairs come from the run bounds (run_pairs_from_bounds), which
  the small cases hold to the plain mask walked row chunk by row chunk.
- for_each_warp_slab_candidate (the v5 slab sweeps): every (row, slot)
  pair of the plain slab mask is staged exactly once, at sub_q 16 (a
  warp's rows span two slabs), 32 and 64, and by the same slice whether
  the walk covers the trips' slots or the whole slab (v5s).

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ablation import legacy_sweeps as tls
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as fad
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.sweeps import (RUN_OFFSETS,
                                                    auto_sweep5_params,
                                                    sweep_bookkeeping2,
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


def hash9_warp_walk(h, lo, hi, sub_q, gx, gy, slices):
    """The v3 / v2 hash walk (for_each_warp_candidate under HashWindows),
    step for step over sorted hashes h (N,) (negative on dead rows) and the
    bounds lo / hi (B * 16,): for each row warp with a live row, (its live
    rows, and for each staged candidate in staging order its row, window,
    slice and window offset d_r)."""
    n = h.shape[0]
    offs = np.asarray([gx * (dy + gy * dz) for dy, dz in RUN_OFFSETS],
                      np.float64)
    for w0 in range(0, n, 32):
        lv = np.arange(w0, w0 + 32)
        lv = lv[h[lv] >= 0.0]
        if lv.size == 0:
            continue                 # a warp with no live row returns
        b = w0 // sub_q              # sub_q % 32 == 0: one sub-block a warp
        klo, khi = h[lv].min(), h[lv].max()
        wlo = lo[16 * b:16 * b + 9]
        whi = np.maximum(hi[16 * b:16 * b + 9], wlo)
        # the trim: lane r's lower and lane 16 + r's upper binary search
        a = np.asarray([wlo[r] + np.searchsorted(
            h[wlo[r]:whi[r]], klo + offs[r] - 1.0, "left") for r in range(9)])
        e = np.asarray([wlo[r] + np.searchsorted(
            h[wlo[r]:whi[r]], khi + offs[r] + 1.0, "right")
            for r in range(9)])
        lens = e - a
        total = int(lens.sum())
        # the windows laid end to end; slice s takes [total*s // slices,
        # total*(s+1) // slices)
        j = np.concatenate([np.arange(a[r], e[r]) for r in range(9)])
        win = np.repeat(np.arange(9), lens)
        cuts = np.asarray([total * s // slices for s in range(slices + 1)])
        sl = np.searchsorted(cuts, np.arange(total), "right") - 1
        d = offs[win]
        take = (h[j] >= klo + d - 1.0) & (h[j] <= khi + d + 1.0)
        yield lv, j[take], win[take], sl[take], d[take]


def staged_hash9_pairs(h, lo, hi, sub_q, gx, gy, slices):
    """(int64 keys q * N + j of every (query row, candidate row) pair that a
    live row of the hash walk pairs, in staging order; the window and the
    slice each pair was staged in; the number of staged (warp, candidate)
    slots)."""
    n = h.shape[0]
    keys, wins, sls, slots = [], [], [], 0
    for lv, j, win, sl, d in hash9_warp_walk(h, lo, hi, sub_q, gx, gy,
                                             slices):
        slots += j.size
        # every live row against every staged slot, in staging order
        m = np.abs(h[lv][:, None] + d[None, :] - h[j][None, :]) <= 1.0
        qi, ci = np.nonzero(m.T)
        keys.append(lv[ci] * n + j[qi])
        wins.append(win[qi])
        sls.append(sl[qi])
    if not keys:
        return (np.zeros(0, np.int64),) * 3 + (slots,)
    return (np.concatenate(keys), np.concatenate(wins), np.concatenate(sls),
            slots)


def _hash9_case(case, sub_q):
    """(sorted hashes, blk_lo, blk_hi, gx, gy) of a case's v3 bookkeeping."""
    cfg, st = _state(case)
    if st.capacity % sub_q:
        pytest.fail(f"capacity {st.capacity} is not a multiple of {sub_q}")
    order, _, lo, hi, chash = sweep_bookkeeping2(st.pos, st.active, cfg,
                                                 sub_q)
    gx, gy, _ = cfg.grid_size
    return (chash[order].numpy().astype(np.float64), lo.numpy(), hi.numpy(),
            gx, gy)


@functools.lru_cache(maxsize=None)
def _hash9_mask_pairs(case):
    """Sorted keys q * N + j of every pair that the plain versions' hash9
    mask (fused_step._stencil_hash9, the mask of sweep_a3_plain(...,
    stencil="hash9") and the v2 plain sums) admits, over the rows in
    sorted order, 512 query rows at a time."""
    cfg, st = _state(case)
    order, _, _, _, chash = sweep_bookkeeping2(st.pos, st.active, cfg, 128)
    gx, gy, _ = cfg.grid_size
    fs = torch.zeros((chash.shape[0], 16))
    fs[:, 12] = chash[order]
    n, out = fs.shape[0], []
    for s in range(0, n, 512):
        qi, ci = torch.nonzero(fst._stencil_hash9(fs[s:s + 512], fs.T, gx,
                                                  gy), as_tuple=True)
        out.append((qi + s).numpy().astype(np.int64) * n + ci.numpy())
    return np.sort(np.concatenate(out))


@pytest.mark.parametrize("slices", [2, 4, 16])
@pytest.mark.parametrize("case", ["biceps_full", "slice", "sparse",
                                  "scattered"])
@pytest.mark.parametrize("sub_q", [32, 128])
def test_hash_walk_stages_every_admitted_pair_once(case, sub_q, slices):
    h, lo, hi, gx, gy = _hash9_case(case, sub_q)
    keys, wins, sls, slots = staged_hash9_pairs(h, lo, hi, sub_q, gx, gy,
                                                slices)
    n = h.shape[0]
    want = _hash9_mask_pairs(case)
    assert want.size > 0
    got, counts = np.unique(keys, return_counts=True)
    # every admitted pair staged exactly once (so by one slice), no other
    assert np.array_equal(got, want)
    assert (counts == 1).all()
    # ... in the window whose offset admits it: the offsets differ by >=
    # Gx > 2, so one window's offset passes |qh + d_r - ch| <= 1
    q, j = keys // n, keys % n
    offs = np.asarray([gx * (dy + gy * dz) for dy, dz in RUN_OFFSETS])
    hit = np.abs(h[q][:, None] + offs[None, :] - h[j][:, None]) <= 1.0
    assert (hit.sum(1) == 1).all() and (hit.argmax(1) == wins).all()
    assert ((sls >= 0) & (sls < slices)).all()
    # each warp stages at most its sub-block's window rows, and fewer where
    # several warps share a sub-block (its windows span all their ranges)
    windows = int(np.maximum(hi - lo, 0).sum()) * (sub_q // 32)
    assert slots <= windows and (sub_q == 32 or slots < windows)


@pytest.mark.parametrize("case", ["biceps_full", "slice", "sparse",
                                  "scattered"])
@pytest.mark.parametrize("sub_q", [32, 128])
def test_hash_windows_hold_sorted_live_hashes(case, sub_q):
    """What the walk's binary-search trim needs: inside every one of a
    sub-block's nine windows the hash (feature row 12) is nondecreasing and
    no row is dead (dead rows sort past every window), so the candidates a
    warp can accept in a window form one run; the seven unused bound slots
    of each 16 are empty."""
    h, lo, hi, _, _ = _hash9_case(case, sub_q)
    lo, hi = lo.reshape(-1, 16), hi.reshape(-1, 16)
    assert (lo[:, 9:] == hi[:, 9:]).all()
    held = 0
    for b in range(lo.shape[0]):
        for r in range(9):
            w = h[lo[b, r]:hi[b, r]]
            assert (w >= 0.0).all() and (np.diff(w) >= 0.0).all()
            held += w.size
    assert held > 0


def run_warp_walk(qstart, qend, slices):
    """The v1 run walk (for_each_warp_run_candidate), step for step over
    sweep_bookkeeping's run bounds qstart / qend (N, 16): for each row warp
    with a nonempty run, (its rows, and for each staged candidate in
    staging order its row, run r and slice). Window r is the union of the
    rows' nonempty runs r (an empty run sits at row 0, not at the row's
    place), cut in two at the widest gap between a nonempty run's end and
    the next nonempty run's start (in lane order), where no run crosses
    the cut; the 18 pieces are laid end to end and sliced."""
    n = qstart.shape[0]
    for w0 in range(0, n, 32):
        rows = np.arange(w0, min(w0 + 32, n))
        pieces = []
        for r in range(9):
            s, e = qstart[rows, r], qend[rows, r]
            ne = e > s
            if not ne.any():
                pieces += [(0, 0), (0, 0)]
                continue
            lo, hi = s[ne].min(), e[ne].max()
            idx = np.nonzero(ne)[0]
            gap = s[idx[1:]] - e[idx[:-1]]
            cut = None
            if gap.size and gap.max() > 0:
                i = int(np.argmax(gap))         # the lowest lane at the max
                a, b = e[idx[i]], s[idx[i + 1]]
                if not (ne & (s < b) & (e > a)).any():
                    cut = (a, b)
            pieces += ([(lo, cut[0]), (cut[1], hi)] if cut
                       else [(lo, hi), (hi, hi)])
        total = sum(b - a for a, b in pieces)
        if total == 0:
            continue                 # a warp with no nonempty run returns
        j, win, sl = [], [], []
        for s in range(slices):      # warp s of the block
            s0, s1 = total * s // slices, total * (s + 1) // slices
            off = 0
            for k, (lo, hi) in enumerate(pieces):
                if off >= s1:
                    break
                a, e = lo + max(s0 - off, 0), lo + min(s1 - off, hi - lo)
                off += hi - lo
                j.append(np.arange(a, e))
                win.append(np.full(max(e - a, 0), k // 2))
                sl.append(np.full(max(e - a, 0), s))
        yield rows, np.concatenate(j), np.concatenate(win), np.concatenate(sl)


def staged_run_pairs(qstart, qend, slices):
    """(int64 keys q * N + j of every (query row, candidate row) pair that a
    row of the run walk pairs under its own exact mask qstart[q, r] <= j <
    qend[q, r], in staging order; the run and the slice each pair was
    staged in; the staged slots of each row warp; the union [min qstart,
    max qend) of each warp's nonempty runs, summed over r)."""
    n = qstart.shape[0]
    keys, wins, sls, slots, unions = [], [], [], [], []
    for rows, j, win, sl in run_warp_walk(qstart, qend, slices):
        slots.append(j.size)
        s, e = qstart[rows, :9], qend[rows, :9]
        ne = e > s
        unions.append(sum(int(e[ne[:, r], r].max() - s[ne[:, r], r].min())
                          for r in range(9) if ne[:, r].any()))
        m = (s[:, win] <= j[None, :]) & (j[None, :] < e[:, win])
        qi, ci = np.nonzero(m.T)
        keys.append(rows[ci] * n + j[qi])
        wins.append(win[qi])
        sls.append(sl[qi])
    return (np.concatenate(keys), np.concatenate(wins), np.concatenate(sls),
            np.asarray(slots), np.asarray(unions))


def _run_case(case):
    """sweep_bookkeeping's (qstart, qend) of a case, as numpy."""
    cfg, st = _state(case)
    _, _, qs, qe, _, _ = tls.sweep_bookkeeping(st.pos, st.active, cfg, 128)
    return qs.numpy(), qe.numpy()


def run_pairs_from_bounds(qs, qe):
    """Sorted keys q * N + j of every pair that the plain v1 sweeps' mask
    admits, and the run r that holds each, from the run bounds alone: the
    mask's own conditions qs[q, r] <= j < qe[q, r] over r < 9 and 0 <= j <
    N, one slot a pair (O(pairs), where the plain mask is (rows, N))."""
    n = qs.shape[0]
    s = np.clip(qs[:, :9].astype(np.int64), 0, n).reshape(-1)
    e = np.clip(qe[:, :9].astype(np.int64), 0, n).reshape(-1)
    length = np.maximum(e - s, 0)
    run = np.repeat(np.arange(n * 9), length)          # q * 9 + r a pair
    first = np.cumsum(length) - length
    j = np.repeat(s - first, length) + np.arange(int(length.sum()))
    key = run // 9 * n + j
    o = np.argsort(key, kind="stable")
    key = key[o]
    assert (np.diff(key) > 0).all()  # the runs of a row are disjoint
    return key, (run % 9)[o]


def plain_run_mask_pairs(qs, qe):
    """run_pairs_from_bounds' pairs as the plain v1 sweeps see them: the
    (rows, N) mask that legacy_sweeps._run_sums hands its pair terms,
    walked chunk by chunk (minutes on biceps_full)."""
    qs, qe = torch.from_numpy(qs), torch.from_numpy(qe)
    n = qs.shape[0]
    seen = []

    def terms(q, c, m):
        seen.append(torch.nonzero(m).numpy())
        return torch.zeros((q.shape[0], 4))

    tls._run_sums(torch.zeros((n, 16)), torch.zeros((16, n)), qs, qe, terms)
    # _run_sums walks the query rows in chunks of equal size
    chunk = fst._rows_per_chunk(9 * n, torch.device("cpu"))
    qi = np.concatenate([s[:, 0] + k * chunk for k, s in enumerate(seen)])
    ji = np.concatenate([s[:, 1] for s in seen])
    key = qi.astype(np.int64) * n + ji
    hit = ((qs[qi, :9].numpy() <= ji[:, None])
           & (ji[:, None] < qe[qi, :9].numpy()))
    assert (hit.sum(1) == 1).all()   # the runs of a row are disjoint
    o = np.argsort(key)
    return key[o], hit.argmax(1)[o]


@functools.lru_cache(maxsize=None)
def _run_mask_pairs(case):
    """The pairs of the plain v1 mask of a case, and the run of each: the
    plain mask walked on the small cases, derived from the run bounds on
    biceps_full (test_run_pairs_from_bounds_match_the_plain_mask holds
    the derivation to the walk)."""
    qs, qe = _run_case(case)
    if case == "biceps_full":
        return run_pairs_from_bounds(qs, qe)
    return plain_run_mask_pairs(qs, qe)


@pytest.mark.parametrize("case", ["slice", "sparse", "scattered"])
def test_run_pairs_from_bounds_match_the_plain_mask(case):
    """The pairs derived from the run bounds are the plain v1 mask's, each
    in the run that holds it."""
    key, run = run_pairs_from_bounds(*_run_case(case))
    want, want_r = _run_mask_pairs(case)
    assert want.size > 0
    assert np.array_equal(key, want)
    assert np.array_equal(run, want_r)


@pytest.mark.parametrize("slices", [2, 4, 16])
@pytest.mark.parametrize("case", ["biceps_full", "slice", "sparse",
                                  "scattered"])
def test_run_walk_stages_every_run_pair_once(case, slices):
    """Every (row, j) pair of the plain v1 mask is staged exactly once, by
    one slice, in window r, the run that holds it; no other pair is; and
    a warp stages no more slots than the union of its rows' nonempty runs
    holds."""
    qs, qe = _run_case(case)
    keys, wins, sls, slots, unions = staged_run_pairs(qs, qe, slices)
    want, want_r = _run_mask_pairs(case)
    assert want.size > 0
    got, first, counts = np.unique(keys, return_index=True,
                                   return_counts=True)
    assert np.array_equal(got, want)
    assert (counts == 1).all()
    assert np.array_equal(wins[first], want_r)
    assert ((sls >= 0) & (sls < slices)).all()
    assert (slots <= unions).all()


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


if __name__ == "__main__":
    # Staged candidates per row warp of the hash walk (v3 / v2 sweeps) at
    # sub_q 128 and of the run walk (v1 sweeps), on biceps_full and on
    # biceps_full x56, where a hash warp whose live rows span a hash range
    # of a whole x-row (Gx cells) or more stages every candidate of that
    # range, and a run warp's union of runs would too but for its cut:
    #   PYTHONPATH=.:tests python tests/test_torch_warp_walk.py
    for rep in (1, 56):
        sc = T.build_scene("biceps_full", replicate=rep, device="cpu")
        order, _, lo, hi, chash = sweep_bookkeeping2(
            sc.state.pos, sc.state.active, sc.cfg, 128)
        h = chash[order].numpy().astype(np.float64)
        gx, gy, _ = sc.cfg.grid_size
        staged, span = [], []
        for lv, j, *_ in hash9_warp_walk(h, lo.numpy(), hi.numpy(), 128, gx,
                                         gy, 2):
            staged.append(j.size)
            span.append(h[lv].max() - h[lv].min())
        staged, span = np.asarray(staged), np.asarray(span)
        wide = span >= gx
        rows = int((hi - lo).clamp(min=0).sum()) / (lo.numel() // 16)
        print(f"biceps_full x{rep} (Gx {gx}): hash walk: {staged.size} row "
              f"warps, staged a warp mean {staged.mean():.1f}, median "
              f"{np.median(staged):.0f}, max {staged.max()}; window rows a "
              f"sub-block {rows:.1f}; {int(wide.sum())} warps span >= Gx "
              f"cells, staging {staged[wide].sum() / staged.sum():.4f} of "
              "all")
        _, _, qs, qe, _, _ = tls.sweep_bookkeeping(
            sc.state.pos, sc.state.active, sc.cfg, 128)
        qs, qe = qs.numpy(), qe.numpy()
        staged, union = [], []
        for rws, j, *_ in run_warp_walk(qs, qe, 2):
            staged.append(j.size)
            s, e = qs[rws, :9], qe[rws, :9]
            ne = e > s
            union.append(sum(int(e[ne[:, r], r].max() - s[ne[:, r], r].min())
                             for r in range(9) if ne[:, r].any()))
        staged, union = np.asarray(staged), np.asarray(union)
        pairs = int(np.clip(qe[:, :9] - qs[:, :9], 0, None).sum())
        live = int(sc.state.active.sum())
        print(f"biceps_full x{rep}: run walk: {staged.size} row warps, "
              f"staged a warp mean {staged.mean():.1f}, median "
              f"{np.median(staged):.0f}, max {staged.max()} (the union of "
              f"the runs uncut: mean {union.mean():.1f}, max {union.max()});"
              f" {pairs / live:.1f} pairs a live row, "
              f"{pairs / staged.sum() / 32:.4f} of the staged slots a row")
