"""Uniform hash-grid neighbor table of the unfused reference step, and the
host-side capacity sizers used at scene build (mirror of
`sph_sm_monodomain_tpu.ops.grid`, `:33-200`; reference
SPH_SM_monodomain.cpp:127-213, 462-481).

`build_neighbor_table` restructures Find_neighbors + the 27-cell stencil
around a spatial sort: with the linear hash x + Gx*(y + Gy*z) (cpp:142) the
three x-neighbor cells at a fixed (y, z) are contiguous in cell-sorted
order, so each query's stencil is 9 contiguous runs of the sorted array,
each read through a fixed window of W = K // 9 slots masked by the run's
true length. Runs longer than W are truncated and counted in `overflow`;
the run driver then regrows K (models.monodomain.run_protocol).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from .constants import const_tensor


class NeighborTable(NamedTuple):
    """Neighbor list per query particle.

    idx:  (Nq, K) int32 — neighbor particle index, original order (0 where
          invalid);
    mask: (Nq, K) bool  — entry validity;
    overflow: () int32  — run entries cut off by the window width W = K//9
          (nonzero means the table must be rebuilt with a larger K).
    """
    idx: torch.Tensor
    mask: torch.Tensor
    overflow: torch.Tensor


def cell_coords(pos: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Integer cell coordinates, truncation toward zero (cpp:127-134). The
    division is a true fp32 division by a 0-dim tensor (a Python-scalar
    divisor would be a multiply by its reciprocal on CUDA)."""
    return (pos / const_tensor(cfg.cell_size, pos.device)).to(torch.int32)


def cell_hash(coords: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Linear hash with -1 for out-of-grid coords (cpp:136-146)."""
    gx, gy, gz = cfg.grid_size
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    inside = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    h = x + gx * (y + gy * z)
    return torch.where(inside, h, torch.full_like(h, -1))


# (dy, dz) offsets of the 9 x-contiguous stencil runs, z-major like the
# reference loop order (cpp:462-464)
_RUN_OFFSETS = tuple((dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1))


def build_neighbor_table(pos_q: torch.Tensor, pos_g: torch.Tensor,
                         active_g: torch.Tensor, cfg: SimConfig,
                         neighbor_capacity: int) -> NeighborTable:
    """Sorted-window neighbor table: for each query, the 9 x-contiguous runs
    of its 27-cell stencil in cell-sorted order, each through a window of
    W = neighbor_capacity // 9 slots. Indices are global (original order),
    so `pos_q` may be a subset of `pos_g`. A query whose own cell is out of
    the grid contributes no runs. The sorted table has no per-cell buckets,
    so the JAX package's `cell_capacity` argument has no counterpart. The
    table is geometry: no gradient flows through it."""
    w = neighbor_capacity // 9
    if w * 9 != neighbor_capacity:
        raise ValueError("neighbor_capacity must be a multiple of 9 for the "
                         "window table")
    pos_q, pos_g = pos_q.detach(), pos_g.detach()
    n_g, n_q = pos_g.shape[0], pos_q.shape[0]
    gx, gy, gz = cfg.grid_size
    dev = pos_g.device

    ids0 = cell_hash(cell_coords(pos_g, cfg), cfg)
    ids = torch.where((ids0 >= 0) & active_g, ids0,
                      torch.full_like(ids0, cfg.num_cells))
    sorted_ids, order = torch.sort(ids, stable=True)
    order = order.to(torch.int32)

    c = cell_coords(pos_q, cfg)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    off = const_tensor(_RUN_OFFSETS, dev, torch.int32)
    y = cy[:, None] + off[None, :, 0]                          # (Nq, 9)
    z = cz[:, None] + off[None, :, 1]
    q_ok = (cx >= 0) & (cx < gx) & (cy >= 0) & (cy < gy) \
        & (cz >= 0) & (cz < gz)
    run_ok = q_ok[:, None] & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    xlo = torch.clamp(cx - 1, min=0)
    xhi = torch.clamp(cx + 1, max=gx - 1)
    row = gx * (y + gy * z)
    zero = torch.zeros_like(row)
    lo_hash = torch.where(run_ok, xlo[:, None] + row, zero)
    hi_hash = torch.where(run_ok, xhi[:, None] + row + 1, zero)
    start = torch.searchsorted(sorted_ids, lo_hash.contiguous(),
                               out_int32=True)
    end = torch.searchsorted(sorted_ids, hi_hash.contiguous(),
                             out_int32=True)
    end = torch.where(run_ok, end, start)
    length = end - start

    wi = torch.arange(w, dtype=torch.int32, device=dev)
    sidx = torch.clamp(start[:, :, None] + wi, max=n_g - 1)
    mask = wi < length[:, :, None]
    idx = torch.where(mask, order[sidx.long()], torch.zeros_like(sidx))
    overflow = torch.clamp(length - w, min=0).sum().to(torch.int32)
    return NeighborTable(idx=idx.reshape(n_q, 9 * w),
                         mask=mask.reshape(n_q, 9 * w), overflow=overflow)


# --- host-side sizers, run once at scene build ---------------------------------

def _occupancy(positions: np.ndarray, cfg: SimConfig):
    """In-grid cell coords `c` and the occupancy histogram (num_cells,)."""
    gx, gy, gz = cfg.grid_size
    coords = (np.asarray(positions) / cfg.cell_size).astype(np.int64)
    inside = ((coords >= 0).all(1)
              & (coords[:, 0] < gx) & (coords[:, 1] < gy) & (coords[:, 2] < gz))
    c = coords[inside]
    occ = np.bincount(c[:, 0] + gx * (c[:, 1] + gy * c[:, 2]),
                      minlength=cfg.num_cells)
    return c, occ


def auto_cell_capacity(positions: np.ndarray, cfg: SimConfig,
                       headroom: float = 2.0, minimum: int = 8) -> int:
    """Max initial cell occupancy times `headroom`, rounded up to 4."""
    _, occ = _occupancy(positions, cfg)
    cap = int(np.ceil(occ.max() * headroom)) if occ.size else minimum
    cap = max(cap, minimum)
    return ((cap + 3) // 4) * 4


def auto_neighbor_capacity(positions: np.ndarray, cfg: SimConfig,
                           headroom: float = 1.5, minimum: int = 32) -> int:
    """Upper bound of the per-particle neighbor count from the initial
    cloud: the summed occupancy of each particle's 27-cell stencil, times
    `headroom`, rounded up to 8."""
    gx, gy, gz = cfg.grid_size
    c, occ = _occupancy(positions, cfg)
    occ = occ.reshape(gz, gy, gx)
    padded = np.zeros((gz + 2, gy + 2, gx + 2), np.int64)
    padded[1:-1, 1:-1, 1:-1] = occ
    stencil = sum(padded[1 + dz:gz + 1 + dz, 1 + dy:gy + 1 + dy,
                         1 + dx:gx + 1 + dx]
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    per_particle = stencil[c[:, 2], c[:, 1], c[:, 0]]
    cap = int(np.ceil(per_particle.max() * headroom)) if per_particle.size \
        else minimum
    cap = max(cap, minimum)
    return ((cap + 7) // 8) * 8


def auto_window_capacity(positions: np.ndarray, cfg: SimConfig,
                         headroom: float = 1.8, minimum: int = 16) -> int:
    """Sorted-window table width K = 9 * W, with W = headroom * the max
    occupancy of any 3 consecutive x-cells at init, rounded up to 8."""
    gx, gy, gz = cfg.grid_size
    _, occ = _occupancy(positions, cfg)
    occ = occ.reshape(gz, gy, gx)
    padded = np.zeros((gz, gy, gx + 2), np.int64)
    padded[:, :, 1:-1] = occ
    run3 = padded[:, :, :-2] + padded[:, :, 1:-1] + padded[:, :, 2:]
    w = int(np.ceil(run3.max() * headroom)) if run3.size else minimum
    w = max(w, minimum)
    w = ((w + 7) // 8) * 8
    return 9 * w
