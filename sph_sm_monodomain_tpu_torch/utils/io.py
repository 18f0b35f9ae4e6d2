"""Point-cloud loading and scene construction (mirror of
`sph_sm_monodomain_tpu.utils.io`, `:27-265`; reference main.cpp:145-179,
464-496). The data assets are the repo's `assets/` point clouds.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..config import SimConfig
from ..state import ParticleState, init_fluid, resolve_device
from ..ops.grid import auto_cell_capacity, auto_window_capacity
from ..ops.sweeps import auto_sweep4_params, auto_sweep5_params
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
    pack_cap: int = 0        # v5 packed-slab capacity kb


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


def scene_positions(name: str, cfg: SimConfig,
                    replicate: int = 1) -> np.ndarray:
    """Raw (pre-state) positions for a named scene. `replicate` > 1 tiles
    the cloud side by side along x at its original density; `cfg` then
    arrives with the world's x extent already expanded by that factor (as
    build_scene does), and procedural or rescaled clouds are built against
    one tile's world."""
    tile_cfg = cfg if replicate == 1 else cfg.replace(
        world_size=(cfg.world_size[0] / replicate,
                    cfg.world_size[1], cfg.world_size[2]))
    if name == "cube":
        pts = cube_positions(tile_cfg)
    elif name in _SCENE_FILES:
        fname, freq = _SCENE_FILES[name]
        pts = read_cloud_csv(ASSETS_DIR / fname, subsample_freq=freq)
        if name in ("susane", "rectus_femoris"):
            pts = rescale_into_world(pts, tile_cfg)
    else:
        raise ValueError(f"unknown scene {name!r}; have "
                         f"{sorted(_SCENE_FILES) + ['cube']}")
    if replicate > 1:
        tile_w = np.float32(cfg.world_size[0] / replicate)
        tiles = []
        for r in range(replicate):
            t = pts.copy()
            t[:, 0] = t[:, 0] + tile_w * r
            tiles.append(t)
        pts = np.concatenate(tiles, axis=0)
    return pts


def build_scene(name: str, cfg: SimConfig | None = None, replicate: int = 1,
                stim: bool = True, pad_to: int | None = None,
                fused_impl: str | None = None, device="cuda") -> Scene:
    """Load + seed + stimulate a scene the way the reference app does
    (init / init_mesh / init_cube, main.cpp:464-496), with the state on
    `device` (the card unless the caller asks for "cpu").

    `replicate` > 1 is the multi-muscle scale-up: tiles of the cloud along
    x at the original density in a world expanded along x, each tile its
    own shape-matching cluster (`sm_clusters`, `sm_tile_rows`) and its own
    tendon anchors.

    `fused_impl`: the fused step's generation, "v4" (default), "v3", "v5",
    "v5s", or the ablation baselines "v1" / "v2". v1-v4 take 128-row
    sub-blocks (auto_sweep4_params), as in the JAX package; v5 takes its
    sub-block size and slab capacity `pack_cap` from auto_sweep5_params
    over the initial cloud."""
    device = resolve_device(device)
    impl = fused_impl or "v4"
    if impl not in ("v1", "v2", "v3", "v4", "v5", "v5s"):
        raise ValueError(f"unknown fused_impl {impl!r}")
    cfg = cfg or SimConfig()
    tile_w = cfg.world_size[0]
    if replicate > 1:
        cfg = cfg.replace(world_size=(cfg.world_size[0] * replicate,
                                      cfg.world_size[1], cfg.world_size[2]),
                          sm_clusters=replicate)
    pts = scene_positions(name, cfg, replicate)
    if replicate > 1:
        # tile k owns rows [k*R, (k+1)*R)
        cfg = cfg.replace(sm_tile_rows=pts.shape[0] // replicate)
    if pts.shape[0] > cfg.max_particles:
        cfg = cfg.replace(max_particles=int(pts.shape[0]))
    state = init_fluid(pts, cfg, pad_to=pad_to, device=device)
    if stim:
        tw = tile_w if replicate > 1 else None
        if name == "cube":
            state = ep.turn_on_stim_cube(state, pts, cfg,   # main.cpp:476
                                         tile_width=tw)
        else:
            state = ep.turn_on_stim_mesh(state, pts, cfg,   # main.cpp:487
                                         tile_width=tw)
    cap = cfg.cell_capacity or auto_cell_capacity(pts, cfg)
    k_nbr = auto_window_capacity(pts, cfg)
    if impl in ("v5", "v5s"):
        sub_q, pack_cap, w_chunk = auto_sweep5_params(pts, cfg)
    else:
        sub_q, w_chunk = auto_sweep4_params(pts, cfg, sub_q=128)
        pack_cap = 0
    return Scene(state=state, cfg=cfg, cell_capacity=cap,
                 neighbor_capacity=k_nbr, num_particles=int(pts.shape[0]),
                 name=name, q_block=max(128, sub_q), block_window=w_chunk,
                 sub_block=sub_q, fused_impl=impl, pack_cap=pack_cap)


def load_surface_mesh(which: str = "biceps"):
    """Load the triangle surface mesh shipped with the reference (the D1
    assets, which init_mesh loads at main.cpp:483-485 for the commented-out
    triangle renderer, main.cpp:232-266).

    Returns (faces (F,3) int32 0-based particle indices, normals (M,3),
    normal_idx (F,3) int32 0-based). Faces index the FIRST `max_index`
    particles of the matching cloud (the reference indexes Particles[]
    directly with the 1-based face indices)."""
    if which == "biceps":
        faces = read_cloud_csv(ASSETS_DIR / "faces.csv")
        normals = read_cloud_csv(ASSETS_DIR / "normals.txt")
        nidx = read_cloud_csv(ASSETS_DIR / "normals_index.csv")
    elif which == "rectus_femoris":
        base = ASSETS_DIR / "RectusFemoris"
        faces = read_cloud_csv(base / "rectusFemorisFaces.csv")
        normals = read_cloud_csv(base / "rectusFemorisNormals.csv")
        nidx = read_cloud_csv(base / "rectusFemorisNormalIndex.csv")
    else:
        raise ValueError(f"no surface mesh for {which!r}")
    return (faces.astype(np.int32) - 1, normals.astype(np.float32),
            nidx.astype(np.int32) - 1)
