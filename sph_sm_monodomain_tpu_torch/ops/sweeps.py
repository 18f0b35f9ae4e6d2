"""Sort + window bookkeeping for the fused sweeps (mirror of the
bookkeeping half of `sph_sm_monodomain_tpu.ops.pallas_sweeps`: `:64`,
`:109-453`).

v4 (`sweep_bookkeeping3`): particles are sorted by a linear cell hash whose
fast axis is the one with the smallest grid extent. For each sub-block of
`win_block` consecutive sorted rows, three candidate windows (one per
slow-axis offset) cover the full 3x3 (fast, mid) footprint of the
sub-block's hash interval in that plane. Windows are iteration bounds only:
the sweep kernels re-derive the exact stencil from the per-row cell
features `cx` and `cyz`.

v3 (`sweep_bookkeeping2`): the x-major hash x + Gx*(y + Gy*z) with no axis
permutation, nine (dy, dz) run windows per sub-block, and the linear hash
itself as the stencil feature.

v5 (`sweep_bookkeeping5`): the nine tight dilated runs of each sub-block,
clamped disjoint and left-packed into `kb` slots, as sorted-row indices
that the step gathers into per-sub-block candidate slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from .constants import const_tensor

_PAIR_EPS = 1e-12  # INF guard, SPH_SM_monodomain.h:24
_COORD_SENTINEL = -1048576.0  # marks out-of-grid / inactive particles
# (dy, dz) run offsets of the v3 windows, z-major like the reference
# stencil loop (cpp:462-464)
RUN_OFFSETS = tuple((dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1))


def _sort_cells(ids: torch.Tensor):
    """(sorted ids, order, inv) of a stable sort by cell id: the JAX
    package's combined-key sort of (id << 15 | index) for n <= 32768 and
    its stable argsort above give this same order."""
    sorted_ids, order = torch.sort(ids, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(ids.shape[0], device=ids.device)
    return sorted_ids, order, inv


def hash_axis_perm(cfg: SimConfig) -> tuple[int, int, int]:
    """(fast, mid, slow) axis indices for the sort hash: ascending grid
    extent, ties by axis index (x-major on the standard cubic world)."""
    g = cfg.grid_size
    return tuple(sorted(range(3), key=lambda a: (g[a], a)))


def hash_cells_perm(pos: torch.Tensor, active: torch.Tensor,
                    cfg: SimConfig):
    """Axis-permuted cell coordinates and linear sort hash.

    Returns (cf, cm, cs, valid, ids): int32 per-axis cell coords in
    (fast, mid, slow) order, the in-grid & active mask, and ids = cf +
    Gf*(cm + Gm*cs) with a num_cells sentinel on invalid rows. Coordinates
    truncate toward zero (`.to(int32)`), like the JAX package's
    `astype(int32)`; the division is a true fp32 division by the cell size.
    """
    fa, ma, sa = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]
    cell = const_tensor(cfg.cell_size, pos.device)
    coords = (pos / cell).to(torch.int32)
    gxyz = const_tensor(tuple(cfg.grid_size), pos.device, torch.int32)
    inside = ((coords >= 0) & (coords < gxyz[None, :])).all(dim=-1)
    valid = inside & active
    cf, cm, cs = coords[:, fa], coords[:, ma], coords[:, sa]
    ids = torch.where(valid, cf + gf * (cm + gm * cs),
                      torch.full_like(cf, cfg.num_cells))
    return cf, cm, cs, valid, ids


def sweep_bookkeeping3(pos: torch.Tensor, active: torch.Tensor,
                       cfg: SimConfig, win_block: int):
    """Sort + merged slow-plane window bookkeeping for the v4 sweeps.

    Returns (order, inv, blk_lo, blk_hi, cx, cyz):
      order (N,) int64   sorted row -> original index (stable sort)
      inv (N,) int64     original index -> sorted row
      blk_lo/hi (B*4,)   int32 window rows per sub-block, 3 used of each 4
      cx (N,) f32        fast-axis cell coordinate, ORIGINAL order;
                         sentinel on out-of-grid / inactive rows
      cyz (N,) f32       mid + G_mid*slow cell coordinate, ORIGINAL order;
                         0 on invalid rows
    Window r of sub-block b spans the hash interval
    [h_lo + ds*Gf*Gm - Gf - 1, h_hi + ds*Gf*Gm + Gf + 2), ds = r - 1, with
    h_lo / h_hi the sub-block's first and last sorted hash.
    """
    n = pos.shape[0]
    num_cells = cfg.num_cells
    fa, ma, _ = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]

    cf, cm, cs, valid, ids = hash_cells_perm(pos, active, cfg)
    sorted_ids, order, inv = _sort_cells(ids)

    b = n // win_block
    h_lo = sorted_ids[::win_block][:b]
    h_hi = sorted_ids[win_block - 1::win_block][:b]
    d = const_tensor((-gf * gm, 0, gf * gm), pos.device, torch.int32)
    blo = torch.clamp(h_lo[:, None] + d[None, :] - (gf + 1), 0, num_cells)
    bhi = torch.clamp(h_hi[:, None] + d[None, :] + (gf + 2), 0, num_cells)
    lo = torch.searchsorted(sorted_ids, blo.contiguous(), out_int32=True)
    hi = torch.searchsorted(sorted_ids, bhi.contiguous(), out_int32=True)

    cx = torch.where(valid, cf.to(torch.float32),
                     torch.full_like(pos[:, 0], _COORD_SENTINEL))
    cyz = torch.where(valid, (cm + gm * cs).to(torch.float32),
                      torch.zeros_like(pos[:, 0]))
    flat4 = lambda a: torch.nn.functional.pad(a, (0, 1)).reshape(-1)  # noqa: E731
    return order, inv, flat4(lo), flat4(hi), cx, cyz


def sweep_bookkeeping2(pos: torch.Tensor, active: torch.Tensor,
                       cfg: SimConfig, win_block: int):
    """Sort + per-sub-block run windows for the v3 (hash9) sweeps.

    Returns (order, inv, blk_lo, blk_hi, chash):
      order / inv        as in sweep_bookkeeping3
      blk_lo/hi (B*16,)  int32 window rows per sub-block, 9 used of each
                         16, in RUN_OFFSETS order
      chash (N,) f32     linear cell hash x + Gx*(y + Gy*z), ORIGINAL
                         order; sentinel on out-of-grid / inactive rows
    Window r of sub-block b spans the hash interval [h_lo + d_r - 1, h_hi
    + d_r + 2), d_r = Gx*(dy + Gy*dz). The windows are not clamped
    disjoint: run offsets differ by >= Gx > 2, so the in-kernel test
    |qh + d_r - ch| <= 1 accepts a pair under at most one of them. The hash
    is x-major on every world (no hash_axis_perm)."""
    n = pos.shape[0]
    gx, gy, gz = cfg.grid_size
    num_cells = cfg.num_cells
    cell = const_tensor(cfg.cell_size, pos.device)
    x, y, z = (pos / cell).to(torch.int32).unbind(-1)
    valid = ((x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
             & active)
    ids = torch.where(valid, x + gx * (y + gy * z),
                      torch.full_like(x, num_cells))
    sorted_ids, order, inv = _sort_cells(ids)

    b = n // win_block
    h_lo = sorted_ids[::win_block][:b]
    h_hi = sorted_ids[win_block - 1::win_block][:b]
    d = const_tensor(tuple(gx * (dy + gy * dz) for dy, dz in RUN_OFFSETS),
                     pos.device, torch.int32)
    blo = torch.clamp(h_lo[:, None] + d[None, :] - 1, 0, num_cells)
    bhi = torch.clamp(h_hi[:, None] + d[None, :] + 2, 0, num_cells)
    lo = torch.searchsorted(sorted_ids, blo.contiguous(), out_int32=True)
    hi = torch.searchsorted(sorted_ids, bhi.contiguous(), out_int32=True)

    chash = torch.where(valid, ids.to(torch.float32),
                        torch.full_like(pos[:, 0], _COORD_SENTINEL))
    flat16 = lambda a: torch.nn.functional.pad(a, (0, 7)).reshape(-1)  # noqa: E731
    return order, inv, flat16(lo), flat16(hi), chash


def _dilated_offsets(gf: int, gm: int) -> tuple:
    """The nine (mid, slow) run offsets gf*dm + gf*gm*ds of the v5 slabs."""
    return tuple(gf * dm + gf * gm * ds for ds in (-1, 0, 1)
                 for dm in (-1, 0, 1))


def sweep_bookkeeping5(pos: torch.Tensor, active: torch.Tensor,
                       cfg: SimConfig, sub_q: int, kb: int,
                       w_chunk: int = 128):
    """Sort + per-sub-block PACKED candidate bookkeeping for the v5 sweeps.

    Each sub-block of `sub_q` sorted rows gets the nine tight dilated hash
    runs of its query span, [h_lo + off_r - 1, h_hi + off_r + 1] for the
    (mid, slow) offsets off_r (_dilated_offsets), clamped disjoint against
    their predecessor (so no row is packed twice) and left-packed into
    `kb` slots.

    Returns (order, inv, src, trips, overflow, cf, cm, cs):
      order / inv (N,)   as in sweep_bookkeeping3
      src (B*kb,) int64  SORTED row feeding each packed slot; N (a zero
                         feature row with a sentinel cf) for empty slots
      trips (B,) int32   ceil(min(total, kb) / w_chunk), clipped to
                         [1, kb / w_chunk]: the w_chunk-wide chunks of the
                         slab a block's union fills
      overflow () int32  candidates dropped where a block's union exceeded
                         kb (regrow kb and redo)
      cf/cm/cs (N,) f32  per-axis cell coords (fast, mid, slow per
                         hash_axis_perm), ORIGINAL order; cf carries the
                         sentinel on out-of-grid / inactive rows, cm / cs
                         are 0 there
    """
    n = pos.shape[0]
    num_cells = cfg.num_cells
    fa, ma, _ = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]
    if n % sub_q:
        raise ValueError(f"capacity {n} not divisible by sub_q={sub_q}")
    if kb % 128:
        raise ValueError(f"kb={kb} must be a multiple of 128")
    if kb % w_chunk:
        raise ValueError(f"kb={kb} not divisible by w_chunk={w_chunk}")

    c_f, c_m, c_s, valid, ids = hash_cells_perm(pos, active, cfg)
    sorted_ids, order, inv = _sort_cells(ids)

    b = n // sub_q
    h_lo = sorted_ids[::sub_q][:b]
    h_hi = sorted_ids[sub_q - 1::sub_q][:b]
    d = const_tensor(_dilated_offsets(gf, gm), pos.device, torch.int32)
    lo_h = torch.clamp(h_lo[:, None] + d[None, :] - 1, 0, num_cells)
    hi_h = torch.clamp(h_hi[:, None] + d[None, :] + 2, 0, num_cells)
    seg_s = torch.searchsorted(sorted_ids, lo_h.contiguous(), out_int32=True)
    seg_e = torch.searchsorted(sorted_ids, hi_h.contiguous(), out_int32=True)
    # seg_e is non-decreasing in r, so only the predecessor can overlap
    seg_s = torch.cat([seg_s[:, :1],
                       torch.maximum(seg_s[:, 1:], seg_e[:, :-1])], dim=1)
    cum = torch.cumsum(torch.clamp(seg_e - seg_s, min=0), dim=1,
                       dtype=torch.int32)                       # (B, 9)
    total = cum[:, -1]
    overflow = torch.clamp(total - kb, min=0).sum().to(torch.int32)
    trips = torch.clamp((torch.clamp(total, max=kb) + w_chunk - 1)
                        // w_chunk, 1, kb // w_chunk).to(torch.int32)

    # slot k of block b holds sorted row seg_s[b, r] + (k - cum[b, r-1]),
    # r its segment
    k = torch.arange(kb, device=pos.device, dtype=torch.int32)[None, :]
    src = torch.full((b, kb), n, dtype=torch.int32, device=pos.device)
    start = torch.zeros((b, 1), dtype=torch.int32, device=pos.device)
    for r in range(9):
        end = cum[:, r:r + 1]
        src = torch.where((k >= start) & (k < end),
                          seg_s[:, r:r + 1] + (k - start), src)
        start = end
    zero = torch.zeros_like(pos[:, 0])
    return (order, inv, src.reshape(-1).to(torch.int64), trips, overflow,
            torch.where(valid, c_f.to(torch.float32),
                        torch.full_like(zero, _COORD_SENTINEL)),
            torch.where(valid, c_m.to(torch.float32), zero),
            torch.where(valid, c_s.to(torch.float32), zero))


def auto_sweep5_params(positions: np.ndarray, cfg: SimConfig,
                       headroom: float = 1.15,
                       sub_qs: tuple[int, ...] = (16, 32, 64)
                       ) -> tuple[int, int, int]:
    """(sub_q, kb, w_chunk) for the v5 packed sweeps, host-side, once per
    scene: the JAX package's tuner. It rebuilds sweep_bookkeeping5's
    dilated unions over the initial cloud and picks the sub-block size that
    minimizes tested pair slots plus slab traffic; kb is the largest union
    times `headroom`, rounded up to 128 (at least 256). Its cost constants
    were fit on the TPU."""
    num_cells = cfg.num_cells
    fa, ma, sa = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]
    coords = (np.asarray(positions) / cfg.cell_size).astype(np.int64)
    g = np.asarray(cfg.grid_size)
    inside = ((coords >= 0) & (coords < g[None, :])).all(1)
    ids = np.where(inside, coords[:, fa] + gf * (coords[:, ma]
                                                 + gm * coords[:, sa]),
                   num_cells)
    cap = ((len(ids) + 127) // 128) * 128
    s = np.full(cap, num_cells, np.int64)
    s[:len(ids)] = np.sort(ids)
    offs = np.array(_dilated_offsets(gf, gm))
    best = None
    for sub_q in sub_qs:
        b = cap // sub_q
        h_lo = s[::sub_q][:b]
        h_hi = s[sub_q - 1::sub_q][:b]
        lo = np.searchsorted(s, np.clip(h_lo[:, None] + offs - 1,
                                        0, num_cells))
        hi = np.searchsorted(s, np.clip(h_hi[:, None] + offs + 2,
                                        0, num_cells))
        lo2 = lo.copy()
        for r in range(1, 9):
            lo2[:, r] = np.maximum(lo2[:, r], hi[:, r - 1])
        tot = np.maximum(hi - lo2, 0).sum(1)
        kb = max(int(np.ceil(tot.max() * headroom / 128)) * 128, 256)
        trips = np.maximum((tot + 127) // 128, 1)
        cost = (trips * 128).sum() * sub_q + trips.sum() * 8 * sub_q \
            + int(3.7 * b * kb)
        if best is None or cost < best[0]:
            best = (cost, sub_q, kb)
    return best[1], best[2], 128


def auto_sweep4_params(positions: np.ndarray, cfg: SimConfig,
                       sub_q: int = 128) -> tuple[int, int]:
    """(sub_q, w_chunk) for the v4 sweeps, host-side, once per scene: the
    JAX package's tuner (candidate lanes + a per-chunk overhead over Wc in
    {128, 256, 384}), kept so `Scene` matches field for field. Its cost
    constants were fit on the TPU; the port's CUDA kernels iterate each
    window exactly and do not read `w_chunk`."""
    num_cells = cfg.num_cells
    fa, ma, sa = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]
    coords = (np.asarray(positions) / cfg.cell_size).astype(np.int64)
    g = np.asarray(cfg.grid_size)
    inside = ((coords >= 0) & (coords < g[None, :])).all(1)
    ids = np.where(inside, coords[:, fa] + gf * (coords[:, ma]
                                                 + gm * coords[:, sa]),
                   num_cells)
    s = np.sort(ids)
    n = len(s)
    b = max(n // sub_q, 1)
    h_lo = s[::sub_q][:b]
    h_hi = s[sub_q - 1::sub_q][:b]
    d = (np.array([-1, 0, 1], np.int64) * (gf * gm))[None, :]
    lo = np.searchsorted(s, np.clip(h_lo[:, None] + d - (gf + 1),
                                    0, num_cells))
    hi = np.searchsorted(s, np.clip(h_hi[:, None] + d + (gf + 2),
                                    0, num_cells))
    start = (lo // 128) * 128
    best = None
    for wc in (128, 256, 384):
        trips = np.maximum(0, -(-(hi - start) // wc))
        cost = (trips * wc).sum() + trips.sum() * 8
        if best is None or cost < best[0]:
            best = (cost, wc)
    return sub_q, best[1]
