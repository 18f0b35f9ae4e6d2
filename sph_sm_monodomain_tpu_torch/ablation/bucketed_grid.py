"""Bucket + scatter-compaction neighbor table, the ablation record (mirror
of `sph_sm_monodomain_tpu.ablation.bucketed_grid`).

The 27 x C gather design (build_buckets -> gather_candidates ->
compact_candidates): kept because its candidates come in the reference's
insertion order (a cell's particles in index order, the stencil's cells
z-major), so its masked sums reassociate as the serial loops do. The
production table is ops/grid.build_neighbor_table's sorted windows.
Plain PyTorch; nothing in the package imports this module.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops.constants import const_tensor
from ..ops.grid import NeighborTable, cell_coords, cell_hash

# 27-cell stencil in the reference's loop order: k (z) outer, j (y), i (x)
# inner, offset = (i, j, k) (cpp:462-466)
_OFFSETS = tuple((i, j, k) for k in (-1, 0, 1) for j in (-1, 0, 1)
                 for i in (-1, 0, 1))


def build_buckets(cell_ids: torch.Tensor, active: torch.Tensor,
                  cfg: SimConfig, capacity: int):
    """Particle indices binned into a (num_cells, capacity) int32 table
    (Find_neighbors, cpp:199-213), empty slots holding N. The sort is
    stable, so a bucket lists its particles in index order, the
    reference's insertion order. Returns (buckets, overflow): particles
    past a bucket's capacity are dropped and counted."""
    n = cell_ids.shape[0]
    num_cells = cfg.num_cells
    ids = torch.where((cell_ids >= 0) & active, cell_ids,
                      torch.full_like(cell_ids, num_cells))
    sorted_ids, order = torch.sort(ids, stable=True)
    order = order.to(torch.int32)
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left",
                               out_int32=True)
    rank = torch.arange(n, dtype=torch.int32, device=ids.device) - first
    live = sorted_ids < num_cells
    keep = live & (rank < capacity)
    # one trash slot at the end absorbs the dropped and inactive writes
    slot = torch.where(keep, sorted_ids * capacity + rank,
                       torch.full_like(rank, num_cells * capacity))
    flat = torch.full((num_cells * capacity + 1,), n, dtype=torch.int32,
                      device=ids.device)
    flat[slot.long()] = order
    buckets = flat[:num_cells * capacity].reshape(num_cells, capacity)
    overflow = (live & (rank >= capacity)).sum(dtype=torch.int32)
    return buckets, overflow


def gather_candidates(pos_q: torch.Tensor, buckets: torch.Tensor,
                      sentinel: int, cfg: SimConfig):
    """Raw candidate indices over the 27-cell stencil (cpp:462-481): (idx
    (Nq, 27*C) int32, mask (Nq, 27*C) bool), in the reference's iteration
    order. Bucket entries are global indices, `sentinel` (the global
    particle count) marking empty slots; `pos_q` may be a subset."""
    n = pos_q.shape[0]
    coords = cell_coords(pos_q, cfg)                         # (Nq, 3)
    off = const_tensor(_OFFSETS, pos_q.device, torch.int32)
    nhash = cell_hash(coords[:, None, :] + off[None, :, :], cfg)  # (Nq, 27)
    valid_cell = nhash >= 0
    cand = buckets[torch.where(valid_cell, nhash,
                               torch.zeros_like(nhash)).long()]  # (Nq,27,C)
    mask = valid_cell[:, :, None] & (cand < sentinel)
    idx = torch.where(mask, cand, torch.zeros_like(cand))
    k = cand.shape[1] * cand.shape[2]
    return idx.reshape(n, k), mask.reshape(n, k)


def compact_candidates(pos_q: torch.Tensor, pos_g: torch.Tensor,
                       idx: torch.Tensor, mask: torch.Tensor,
                       cfg: SimConfig, k_max: int):
    """Keep the candidates within 2h (the widest kernel support, cpp:166-
    197: farther ones add exactly 0 to every phase) and left-compact them
    to (Nq, k_max). Returns (idx, mask, overflow), the candidates past
    k_max dropped and counted."""
    n = pos_q.shape[0]
    g = pos_g[idx.long()]                                    # (Nq, 27C, 3)
    dx = pos_q[:, None, 0] - g[..., 0]
    dy = pos_q[:, None, 1] - g[..., 1]
    dz = pos_q[:, None, 2] - g[..., 2]
    r2 = dx * dx + dy * dy + dz * dz
    support = (2.0 * cfg.kernel_h) ** 2
    keep = mask & (r2 <= support)                            # self kept
    count = keep.sum(dim=1, dtype=torch.int32)
    pos_in_row = torch.cumsum(keep.to(torch.int32), dim=1,
                              dtype=torch.int32) - 1
    dest = torch.where(keep & (pos_in_row < k_max), pos_in_row,
                       torch.full_like(pos_in_row, k_max))
    rows = torch.arange(n, device=idx.device)[:, None].expand_as(dest)
    out = torch.zeros((n, k_max + 1), dtype=torch.int32, device=idx.device)
    out[rows, dest.long()] = idx
    out = out[:, :k_max]
    cols = torch.arange(k_max, dtype=torch.int32, device=idx.device)
    out_mask = cols[None, :] < torch.clamp(count, max=k_max)[:, None]
    overflow = torch.clamp(count - k_max, min=0).sum(dtype=torch.int32)
    return out, out_mask, overflow


def build_neighbor_table_bucketed(pos_q: torch.Tensor, pos_g: torch.Tensor,
                                  active_g: torch.Tensor, cfg: SimConfig,
                                  cell_capacity: int,
                                  neighbor_capacity: int) -> NeighborTable:
    """Bucket + scatter-compaction neighbor table in the reference's
    candidate order (see the module docstring)."""
    ids = cell_hash(cell_coords(pos_g, cfg), cfg)
    buckets, overflow = build_buckets(ids, active_g, cfg, cell_capacity)
    raw_idx, raw_mask = gather_candidates(pos_q, buckets, pos_g.shape[0],
                                          cfg)
    idx, mask, dropped = compact_candidates(pos_q, pos_g, raw_idx, raw_mask,
                                            cfg, neighbor_capacity)
    return NeighborTable(idx=idx, mask=mask, overflow=overflow + dropped)
