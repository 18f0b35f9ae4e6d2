"""Point-cloud loading and scene construction (mirror of
`sph_sm_monodomain_tpu.utils.io`, `:27-240`; reference main.cpp:145-179,
464-496). The data assets are the repo's `assets/` point clouds.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..config import SimConfig
from ..state import ParticleState, init_fluid
from ..ops.grid import auto_cell_capacity, auto_window_capacity
from ..ops.sweeps import auto_sweep4_params
from ..ops import electrophysiology as ep

_REPO_ROOT = Path(__file__).resolve().parents[2]
ASSETS_DIR = Path(os.environ.get("SPH_SM_ASSETS", _REPO_ROOT / "assets"))


def read_cloud_csv(path, subsample_freq: int = 0,
                   subsample_after: int = 3000) -> np.ndarray:
    """Read an x,y,z CSV cloud (readCloudFromFile, main.cpp:145-179).

    With `subsample_freq` > 0 the reference's muscle-data rule applies: keep
    the first `subsample_after` rows, then every `subsample_freq`-th row by
    row counter (main.cpp:165-176). Unparseable rows are skipped but still
    counted."""
    pts = []
    counter = 0
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 3:
                counter += 1
                continue
            try:
                xyz = (float(parts[0]), float(parts[1]), float(parts[2]))
            except ValueError:
                counter += 1
                continue
            if subsample_freq <= 0 or counter < subsample_after \
                    or counter % subsample_freq == 0:
                pts.append(xyz)
            counter += 1
    return np.asarray(pts, dtype=np.float32).reshape(-1, 3)


def cube_positions(cfg: SimConfig) -> np.ndarray:
    """Procedural cube seeding (init_cube, main.cpp:464-477): grid with
    spacing 0.9*h over [0.3W, 0.7W) x [0, 0.4W) x [0.3W, 0.7W), float32
    accumulation like the C++ loop."""
    w = np.float32(cfg.world_size[0])
    step = np.float32(cfg.kernel_h) * np.float32(0.9)
    pts = []
    k = w * np.float32(0.3)
    while k < w * np.float32(0.7):
        j = w * np.float32(0.0)
        while j < w * np.float32(0.4):
            i = w * np.float32(0.3)
            while i < w * np.float32(0.7):
                pts.append((i, j, k))
                i += step
            j += step
        k += step
    return np.asarray(pts, dtype=np.float32)


def rescale_into_world(points: np.ndarray, cfg: SimConfig,
                       margin: float = 0.15) -> np.ndarray:
    """Fit an out-of-bounds cloud into the world box (susane.csv and
    RectusFemoris ship out of bounds)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    world = np.asarray(cfg.world_size, dtype=np.float32)
    usable = world * (1.0 - 2.0 * margin)
    scale = float((usable / span).min())
    return ((points - lo) * scale + world * margin).astype(np.float32)


class Scene(NamedTuple):
    state: ParticleState
    cfg: SimConfig
    cell_capacity: int       # hash-grid bucket width
    neighbor_capacity: int   # window neighbor-table width K = 9*W
    num_particles: int
    name: str
    q_block: int = 128       # fused-sweep query block (TPU tiling; kept for parity)
    block_window: int = 128  # fused-sweep candidate chunk (TPU tiling; kept for parity)
    sub_block: int = 128     # window-bound granularity = sweep thread-block rows
    fused_impl: str = "v4"   # fused-step kernel generation
    pack_cap: int = 0        # v5 packed-slab capacity (not ported)


_SCENE_FILES = {
    "biceps_18475": ("biceps_simple_out_18475.csv", 7),
    "biceps_full": ("biceps_simple_out_18475.csv", 0),
    "biceps_4944": ("biceps_simple_out_4944.csv", 0),
    "biceps_1": ("biceps_simple_out_1.csv", 0),
    "biceps_2": ("biceps_simple_out_2.csv", 0),
    "biceps": ("biceps_simple_out.csv", 0),
    "biceps_scaled_1": ("biceps_simple_out_scaled_1.csv", 0),
    "susane": ("susane.csv", 0),
    "rectus_femoris": ("RectusFemoris/rectusFemorisVertices.csv", 0),
}


def scene_positions(name: str, cfg: SimConfig) -> np.ndarray:
    """Raw (pre-state) positions for a named scene."""
    if name == "cube":
        return cube_positions(cfg)
    if name not in _SCENE_FILES:
        raise ValueError(f"unknown scene {name!r}; have "
                         f"{sorted(_SCENE_FILES) + ['cube']}")
    fname, freq = _SCENE_FILES[name]
    pts = read_cloud_csv(ASSETS_DIR / fname, subsample_freq=freq)
    if name in ("susane", "rectus_femoris"):
        pts = rescale_into_world(pts, cfg)
    return pts


def build_scene(name: str, cfg: SimConfig | None = None, replicate: int = 1,
                stim: bool = True, pad_to: int | None = None,
                fused_impl: str | None = None, device="cpu") -> Scene:
    """Load + seed + stimulate a scene the way the reference app does
    (init / init_mesh / init_cube, main.cpp:464-496), with the state on
    `device`. Multi-muscle replication (`replicate` > 1) and fused kernel
    generations other than v4 are not ported yet."""
    if replicate != 1:
        raise NotImplementedError("replicate > 1 (multi-muscle clusters) is "
                                  "not ported yet")
    impl = fused_impl or "v4"
    if impl != "v4":
        raise NotImplementedError(f"fused_impl={impl!r}: the port has the "
                                  "v4 sweeps only")
    cfg = cfg or SimConfig()
    pts = scene_positions(name, cfg)
    if pts.shape[0] > cfg.max_particles:
        cfg = cfg.replace(max_particles=int(pts.shape[0]))
    state = init_fluid(pts, cfg, pad_to=pad_to, device=device)
    if stim:
        if name == "cube":
            state = ep.turn_on_stim_cube(state, pts, cfg)   # main.cpp:476
        else:
            state = ep.turn_on_stim_mesh(state, pts, cfg)   # main.cpp:487
    cap = cfg.cell_capacity or auto_cell_capacity(pts, cfg)
    k_nbr = auto_window_capacity(pts, cfg)
    sub_q, w_chunk = auto_sweep4_params(pts, cfg, sub_q=128)
    return Scene(state=state, cfg=cfg, cell_capacity=cap,
                 neighbor_capacity=k_nbr, num_particles=int(pts.shape[0]),
                 name=name, q_block=max(128, sub_q), block_window=w_chunk,
                 sub_block=sub_q, fused_impl=impl, pack_cap=0)
