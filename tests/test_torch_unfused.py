"""PyTorch port vs the JAX package: the unfused reference path (the FHN ODE,
integration, the smoothing kernels, the neighbor table, the three SPH
phases, the unfused coupled step and its run loop with the overflow
regrow) and multi-muscle scene replication. Inputs are made with numpy
from a seed and handed to both packages; both run on the CPU.

Tolerances, each with its reason:
  - elementwise functions (kernels, FHN, integration): the same fp32
    operations in the same order, so 1e-6 relative (a last-bit difference
    of a library's pow or division stays far inside it);
  - the neighbor table, its overflow and the replicated scene: integer or
    copied data, so exactly equal;
  - the SPH phases: the same pair math summed over the same K table slots,
    on inputs of unit-to-thousands magnitude: 1e-5 of max(1, max|column|);
  - the coupled step: the JAX suite's fused-vs-unfused step tolerances
    (tests/test_pallas_sweeps.py): pos 5e-5, vel 5e-3, vm 5e-3, iion 1e-5,
    w 1e-6 absolute, dens 1e-5 relative; over several steps each at the
    larger of that and twice JAX's own spread when the input positions
    move by one ulp (tests/torch_parity.py).
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu.models import monodomain as jmono
from sph_sm_monodomain_tpu.ops import electrophysiology as jep
from sph_sm_monodomain_tpu.ops import grid as jgrid
from sph_sm_monodomain_tpu.ops import integrate as jint
from sph_sm_monodomain_tpu.ops import kernels as jker
from sph_sm_monodomain_tpu.ops import sph as jsph
from sph_sm_monodomain_tpu_torch.models import monodomain as tmono
from sph_sm_monodomain_tpu_torch.ops import electrophysiology as tep
from sph_sm_monodomain_tpu_torch.ops import grid as tgrid
from sph_sm_monodomain_tpu_torch.ops import integrate as tint
from sph_sm_monodomain_tpu_torch.ops import kernels as tker
from sph_sm_monodomain_tpu_torch.ops import sph as tsph

from torch_parity import (assert_bit_equal, assert_states_close,
                          biceps_slice_points, jax_state_arrays,
                          random_state, to_torch_state, torch_cfg)
from torch_parity import ulp_spreads  # noqa: F401 (a fixture)

ELEM_RTOL = 1e-6
PHASE_TOL = 1e-5
# CELL_CAP: the JAX table's per-cell bucket width (the port's sorted table
# has no buckets, so only the JAX side takes it)
CELL_CAP, NBR_CAP = 32, 9 * 64


def _close(got, want, rtol=ELEM_RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol * 1e-3, err_msg=what)


def _close_cols(got, want, what=""):
    """|got - want| <= PHASE_TOL * max(1, max|want|) per column."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    bound = PHASE_TOL * np.maximum(1.0, np.abs(want).max(axis=0))
    err = np.abs(got - want).max(axis=0)
    assert np.all(err <= bound), (what, err, bound)


def _states(seed=0, n=200, **fields):
    jcfg = J.SimConfig()
    js = random_state(jcfg, n=n, seed=seed)
    if fields:
        js = js.replace(**{k: np.asarray(v, np.float32)
                           for k, v in fields.items()})
    return jcfg, js, torch_cfg(jcfg), to_torch_state(js)


@pytest.mark.parametrize("name", ["poly6", "spiky", "visco", "b_spline",
                                  "b_spline_1", "b_spline_2"])
def test_smoothing_kernels_match_jax(name):
    cfg = J.SimConfig()
    # distances across every piece of the supports, and past them
    r = np.linspace(-0.01, 2.5 * cfg.kernel_h, 977).astype(np.float32)
    if name == "poly6":
        r = r * r * np.sign(r)          # Poly6 takes the squared distance
    want = getattr(jker, name)(jnp.asarray(r), cfg)
    got = getattr(tker, name)(torch.from_numpy(r), torch_cfg(cfg))
    _close(got.numpy(), want, what=name)


@pytest.mark.parametrize("accumulate", [True, False])
def test_fhn_cell_model_matches_jax(accumulate):
    jcfg, js, tcfg, ts = _states()
    jcfg = jcfg.replace(quirk_iion_accumulate=accumulate)
    tcfg = torch_cfg(jcfg)
    jout = jep.fhn_cell_model(js, jcfg)
    tout = tep.fhn_cell_model(ts, tcfg)
    for f in ("iion", "w"):
        _close(getattr(tout, f).numpy(), getattr(jout, f), what=f)
    if not accumulate:
        # assigned, not accumulated: the old Iion is gone
        _close(tout.iion.numpy(),
               tep.fhn_cell_model(ts.replace(iion=ts.iion * 0.0),
                                  tcfg).iion.numpy())


def test_update_properties_matches_jax():
    rng = np.random.default_rng(5)
    js0 = random_state(J.SimConfig(), seed=5)
    cap = js0.capacity
    pos = np.asarray(js0.pos).copy()
    # a few particles pushed through the walls, a few others fixed
    pos[:4, 0] = [-0.01, 1.6, 1.5, -0.2]
    fixed = np.zeros(cap, bool)
    fixed[6:12] = True
    jcfg, js, tcfg, ts = _states(
        seed=5, pos=pos, inter_vel=rng.normal(size=(cap, 3)) * 0.5,
        acc=rng.normal(size=(cap, 3)) * 3.0,
        inter_vm=rng.normal(size=cap) * 3e4)
    js = js.replace(fixed=jnp.asarray(fixed))
    ts = ts.replace(fixed=torch.from_numpy(fixed))
    jout = jint.update_properties(js, jcfg)
    tout = tint.update_properties(ts, tcfg)
    for f in ("pos", "vel", "vm"):
        _close(getattr(tout, f).numpy(), getattr(jout, f), what=f)
    act = np.asarray(js.active)
    assert np.all(np.abs(tout.vm.numpy()[act]) <= tcfg.max_voltage)
    np.testing.assert_array_equal(tout.pos.numpy()[fixed], pos[fixed])


@pytest.mark.parametrize("case", ["fits", "overflows"])
def test_build_neighbor_table_matches_jax(case):
    jcfg, js, tcfg, ts = _states(seed=1)
    k = NBR_CAP if case == "fits" else 9 * 2
    jn = jgrid.build_neighbor_table(js.pos, js.pos, js.active, jcfg,
                                    CELL_CAP, k)
    tn = tgrid.build_neighbor_table(ts.pos, ts.pos, ts.active, tcfg, k)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(tn.mask.numpy(), np.asarray(jn.mask))
    assert int(tn.overflow) == int(jn.overflow)
    assert (int(tn.overflow) > 0) == (case == "overflows")
    # padded rows (outside the grid) have no runs
    assert not tn.mask.numpy()[~np.asarray(js.active)].any()


@pytest.mark.parametrize("phase", ["xsph", "density", "force"])
def test_sph_phases_match_jax(phase):
    rng = np.random.default_rng(2)
    cap = 256                           # 200 particles padded to 128s
    jcfg, js, tcfg, ts = _states(
        seed=2, inter_vel=rng.normal(size=(cap, 3)) * 0.1,
        pres=rng.normal(size=cap) * 100.0)
    jn = jgrid.build_neighbor_table(js.pos, js.pos, js.active, jcfg,
                                    CELL_CAP, NBR_CAP)
    tn = tgrid.build_neighbor_table(ts.pos, ts.pos, ts.active, tcfg,
                                    NBR_CAP)
    act = np.asarray(js.active)
    if phase == "xsph":
        pairs = [(tsph.xsph_intermediate_velocity(ts, tn, tcfg).inter_vel,
                  jsph.xsph_intermediate_velocity(js, jn, jcfg).inter_vel)]
    elif phase == "density":
        t, j = (tsph.density_pressure(ts, tn, tcfg),
                jsph.density_pressure(js, jn, jcfg))
        pairs = [(t.dens, j.dens), (t.pres, j.pres)]
        # the stim gate writes -0.0 on unstimulated rows
        assert_bit_equal(t.pres.numpy()[act & (np.asarray(js.stim) <= 0)],
                         np.asarray(j.pres)[act & (np.asarray(js.stim) <= 0)])
    else:
        t, j = (tsph.force_and_diffusion(ts, tn, tcfg),
                jsph.force_and_diffusion(js, jn, jcfg))
        pairs = [(t.acc, j.acc), (t.inter_vm, j.inter_vm)]
    for got, want in pairs:
        _close_cols(got.numpy()[act], np.asarray(want)[act], phase)


def test_unfused_step_matches_jax(ulp_spreads):
    """Two unfused coupled steps (table, SM, XSPH, density, FHN, forces,
    integration) with a per-call parameter override."""
    jcfg, js0, tcfg, ts = _states(seed=3)
    params = {"k_stiffness": 0.8, "fh_c3": 0.02}

    def run(js):
        for _ in range(2):
            js = J.step(js, jcfg, CELL_CAP, NBR_CAP, params=params)[0]
        return js
    js = js0
    for _ in range(2):
        js, jaux = J.step(js, jcfg, CELL_CAP, NBR_CAP, params=params)
        ts, taux = T.step(ts, tcfg, NBR_CAP, params=params)
        assert int(taux.overflow) == int(jaux.overflow) == 0
    spread = ulp_spreads("seed3/unfused", run, js0, ref=js)
    assert_states_close(ts, js, np.asarray(js.active), spread=spread)


def _slice_scenes(neighbor_capacity):
    pts = biceps_slice_points(every=40)
    jcfg = J.SimConfig()
    js = J.stim.turn_on_stim_mesh(J.init_fluid(pts, jcfg), pts, jcfg)
    common = dict(cell_capacity=jgrid.auto_cell_capacity(pts, jcfg),
                  neighbor_capacity=neighbor_capacity,
                  num_particles=pts.shape[0], name="biceps_every40")
    tcfg = torch_cfg(jcfg)
    ts = T.stim.turn_on_stim_mesh(T.init_fluid(pts, tcfg, device="cpu"), pts,
                                  tcfg)
    return J.Scene(state=js, cfg=jcfg, **common), \
        T.Scene(state=ts, cfg=tcfg, **common)


def test_run_protocol_unfused_regrows_like_jax(ulp_spreads):
    """run_protocol(fused=False) with a neighbor table too narrow for the
    cloud: each overflowing chunk is redone with K grown 1.5x (rounded up
    to a multiple of 9), as in the JAX package, and the run ends with the
    same capacity, overflow 0 and the same state."""
    jsc, tsc = _slice_scenes(neighbor_capacity=9 * 3)
    seen = {"jax": [], "torch": []}

    def spy(mod, key):
        orig = mod.simulate

        def wrapped(*a, **kw):
            seen[key].append(kw.get("neighbor_capacity", a[3] if len(a) > 3
                                    else None))
            return orig(*a, **kw)
        return mock.patch.object(mod, "simulate", wrapped)

    with spy(jmono, "jax"):
        jst, jaux, _ = J.run_protocol(jsc, num_steps=4, chunk=2,
                                      stim_off_step=3, fused=False)
    with spy(tmono, "torch"):
        tst, taux, _ = T.run_protocol(tsc, num_steps=4, chunk=2,
                                      stim_off_step=3, fused=False)
    assert seen["torch"] == seen["jax"]
    assert len(set(seen["torch"])) > 1, "the table never regrew"
    assert seen["torch"][-1] % 9 == 0
    assert int(taux.overflow) == int(jaux.overflow) == 0
    spread = ulp_spreads(
        "slice/unfused", lambda s: J.run_protocol(
            jsc._replace(state=s), num_steps=4, chunk=2, stim_off_step=3,
            fused=False)[0], jsc.state, ref=jst)
    assert_states_close(tst, jst, np.asarray(jst.active), spread=spread)


def test_build_scene_replicate_matches_jax():
    """Two tiles of susane along x: the same positions, stim, fixed
    anchors, config (world, clusters, tile rows) and capacities."""
    jsc = J.build_scene("susane", replicate=2)
    tsc = T.build_scene("susane", replicate=2, device="cpu")
    assert dataclasses.asdict(tsc.cfg) == dataclasses.asdict(jsc.cfg)
    assert tsc.cfg.sm_clusters == 2 and tsc.cfg.world_size[0] == 3.0
    for f in ("cell_capacity", "neighbor_capacity", "num_particles",
              "sub_block", "block_window"):
        assert getattr(tsc, f) == getattr(jsc, f), f
    jarr, tarr = jax_state_arrays(jsc.state), T.state_to_numpy(tsc.state)
    for f in ("pos", "orig_pos", "stim", "fixed", "active"):
        assert_bit_equal(tarr[f], jarr[f], f)
    n = tsc.num_particles // 2
    # each tile has its own tendon anchors
    assert tarr["fixed"][:n].sum() == tarr["fixed"][n:2 * n].sum() > 0
