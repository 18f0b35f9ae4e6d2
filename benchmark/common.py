"""What every driver of the benchmark shares: the manifest and the files a
cell names, the cloud and the seeded inputs, state copies, and the device's
clock. Nothing here imports the package under test at import time."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# top-level modules that may not be loaded by a run (compared whole: the
# package under test's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "sph_sm_monodomain_tpu")
# the seeded vm field of the live rows: normal(seed) x VM_SCALE, as
# tools/trajectory_parity.py seeds its second start
VM_SCALE = 5.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(manifest: dict, workload: str, root: Path = ROOT):
    """(cell, configuration, traffic, checks) of a workload: the
    configuration's file, the traffic mix's, and the cell's check settings
    and limits (benchmark/checks/<cell>.json), each found by its name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    confs = {c["name"]: c for c in manifest["configs"]}
    conf = load_json(root / confs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    checks = load_json(BENCH / "checks" / f"{workload}.json")
    return cell, conf, traffic, checks


def read_cloud(path: Path) -> np.ndarray:
    """The x,y,z rows of a cloud file as float32 (every parsable row)."""
    pts = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            try:
                pts.append(tuple(float(p) for p in parts[:3]))
            except ValueError:
                continue
    return np.asarray([p for p in pts if len(p) == 3],
                      dtype=np.float32).reshape(-1, 3)


def cloud(conf: dict, root: Path = ROOT) -> np.ndarray:
    """The configuration's live positions: the cloud tiled `replicate`
    times along x at world_size[0] / replicate, as the run's world holds
    them (float32 adds, as the scene builds them)."""
    pts = read_cloud(root / conf["cloud"])
    k = conf["replicate"]
    if k == 1:
        return pts
    tile_w = np.float32(conf["physics"]["world_size"][0] / k)
    tiles = []
    for r in range(k):
        t = pts.copy()
        t[:, 0] = t[:, 0] + tile_w * r
        tiles.append(t)
    return np.concatenate(tiles)


def vm_field(n: int, seed: int, device) -> torch.Tensor:
    """The seeded vm of n live rows, drawn on `device` in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return torch.randn(n, generator=g, device=device,
                       dtype=torch.float32) * VM_SCALE


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
