"""Sort + window bookkeeping for the v4 fused sweeps (mirror of the
bookkeeping half of `sph_sm_monodomain_tpu.ops.pallas_sweeps`: `:109`,
`:171-257`, `:415-453`).

Particles are sorted by a linear cell hash whose fast axis is the one with
the smallest grid extent. For each sub-block of `win_block` consecutive
sorted rows, three candidate windows (one per slow-axis offset) cover the
full 3x3 (fast, mid) footprint of the sub-block's hash interval in that
plane. Windows are iteration bounds only: the sweep kernels re-derive the
exact stencil from the per-row cell features `cx` and `cyz`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from .constants import const_tensor

_PAIR_EPS = 1e-12  # INF guard, SPH_SM_monodomain.h:24
_COORD_SENTINEL = -1048576.0  # marks out-of-grid / inactive particles


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
    sorted_ids, order = torch.sort(ids, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=pos.device)

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
