"""Host-side grid sizers used at scene build (mirror of the numpy helpers of
`sph_sm_monodomain_tpu.ops.grid`, `:132-200`).

Only what `build_scene` calls is here, so that `Scene` carries the same
capacities as the JAX package's; the neighbor table itself belongs to the
unfused path, which the port does not have yet.
"""

from __future__ import annotations

import numpy as np

from ..config import SimConfig


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
