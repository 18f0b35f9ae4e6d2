"""The port's bucketed neighbor table (ablation/bucketed_grid.py) against
the JAX package's, exactly: every output is integers (indices, masks,
overflow counts), so the two must agree bit for bit on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_sm_monodomain_tpu.ablation import bucketed_grid as JB
from sph_sm_monodomain_tpu.config import SimConfig as JConfig
from sph_sm_monodomain_tpu.ops.grid import cell_coords as j_coords
from sph_sm_monodomain_tpu.ops.grid import cell_hash as j_hash

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ablation import bucketed_grid as TB
from sph_sm_monodomain_tpu_torch.ops.grid import cell_coords, cell_hash

JCFG = JConfig()
TCFG = T.config_from_dict(dataclasses.asdict(JCFG))


def _cloud(kind, rng):
    """(positions (N, 3) f32, active (N,) bool) of one test cloud."""
    if kind == "uniform":                # tests/test_grid.py's cloud
        pos = (rng.random((300, 3)) * 0.5 + 0.2).astype(np.float32)
        return pos, np.ones(300, bool)
    if kind == "blob":                   # dense: buckets overflow
        pos = np.clip(rng.normal(size=(400, 3)) * 0.04 + 0.6, 0.05, 1.4)
        act = rng.random(400) > 0.1
        return pos.astype(np.float32), act
    if kind == "stacked":                # tests/test_grid.py: 20 in a cell
        return np.full((20, 3), 0.5, np.float32), np.ones(20, bool)
    if kind == "outside":                # rows off the grid
        pos = (rng.random((200, 3)) * 1.8 - 0.15).astype(np.float32)
        return pos, np.ones(200, bool)
    raise ValueError(kind)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


@pytest.mark.parametrize("kind", ("uniform", "blob", "stacked", "outside"))
@pytest.mark.parametrize("caps", ((8, 64), (4, 16)), ids=("c8k64", "c4k16"))
def test_bucketed_table_matches_jax(kind, caps):
    pos, act = _cloud(kind, np.random.default_rng(0))
    cell_cap, k = caps
    q = pos[: len(pos) // 2]             # a subset of the rows as queries
    want = jax.jit(JB.build_neighbor_table_bucketed,
                   static_argnums=(3, 4, 5))(
        jnp.asarray(q), jnp.asarray(pos), jnp.asarray(act), JCFG, cell_cap,
        k)
    got = TB.build_neighbor_table_bucketed(
        torch.from_numpy(q), torch.from_numpy(pos), torch.from_numpy(act),
        TCFG, cell_cap, k)
    for name in ("idx", "mask", "overflow"):
        _eq(getattr(want, name), getattr(got, name), name)


@pytest.mark.parametrize("kind", ("blob", "stacked", "outside"))
def test_bucketed_stages_match_jax(kind):
    """Each stage on its own: the buckets and their overflow, the raw
    27-cell candidates, and the distance-filtered compaction."""
    pos, act = _cloud(kind, np.random.default_rng(1))
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    ids_j = j_hash(j_coords(jp, JCFG), JCFG)
    ids_t = cell_hash(cell_coords(tp, TCFG), TCFG)
    _eq(ids_j, ids_t, "cell ids")
    jb, jo = JB.build_buckets(ids_j, jnp.asarray(act), JCFG, 8)
    tb, to = TB.build_buckets(ids_t, torch.from_numpy(act), TCFG, 8)
    _eq(jb, tb, "buckets")
    _eq(jo, to, "bucket overflow")
    ji, jm = JB.gather_candidates(jp, jb, pos.shape[0], JCFG)
    ti, tm = TB.gather_candidates(tp, tb, pos.shape[0], TCFG)
    _eq(ji, ti, "raw idx")
    _eq(jm, tm, "raw mask")
    for k_max in (8, 48):
        want = JB.compact_candidates(jp, jp, ji, jm, JCFG, k_max)
        got = TB.compact_candidates(tp, tp, ti, tm, TCFG, k_max)
        for name, a, b in zip(("idx", "mask", "overflow"), want, got):
            _eq(a, b, f"compact {name} (k_max {k_max})")


def test_stacked_cell_drops_past_capacity():
    """tests/test_grid.py's overflow case: 20 particles in one cell,
    capacity 8 -> 12 dropped, the first 8 kept in index order."""
    pos, act = _cloud("stacked", None)
    nbr = TB.build_neighbor_table_bucketed(
        torch.from_numpy(pos), torch.from_numpy(pos), torch.from_numpy(act),
        TCFG, cell_capacity=8, neighbor_capacity=64)
    assert int(nbr.overflow) == 12
    assert set(nbr.idx[0][nbr.mask[0]].tolist()) == set(range(8))
