"""PyTorch port vs the JAX package: config, state, checkpoints, scenes and
stimulus control, and the port's import hygiene."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops import electrophysiology as tep

from torch_parity import (assert_bit_equal, jax_state_arrays, random_state,
                          to_torch_state, torch_cfg)

REPO = Path(__file__).resolve().parents[1]
_PROPS = ("sigma", "time_delta", "grid_size", "num_cells", "poly6_constant",
          "spiky_constant", "b_spline_constant")


@pytest.mark.parametrize("overrides", [
    {},
    {"kernel_h": 0.05, "cell_size": 0.03, "world_size": (2.0, 1.5, 1.0),
     "max_vel": (1.0, 2.0, 3.0), "sigma_i": 1.3, "quadratic_match": True},
], ids=["default", "custom"])
def test_config_mirrors_jax(overrides):
    jcfg = J.SimConfig(**overrides)
    tcfg = T.SimConfig(**overrides)
    jf = [(f.name, f.default) for f in dataclasses.fields(J.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(T.SimConfig)]
    assert tf == jf
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for p in _PROPS:
        assert getattr(tcfg, p) == getattr(jcfg, p), p
    assert T.PARAM_FIELDS == J.PARAM_FIELDS
    assert torch_cfg(jcfg) == tcfg
    assert tcfg.add_viscosity(-150.0) == T.config_from_dict(
        dataclasses.asdict(jcfg.add_viscosity(-150.0)))
    assert T.resolve_params(tcfg, {"k_stiffness": 0.7}).k_stiffness == 0.7
    with pytest.raises(ValueError):
        T.resolve_params(tcfg, {"kernel_h": 0.1})


def test_state_carry_over_roundtrip():
    js = random_state(J.SimConfig(), n=150)
    arrays = jax_state_arrays(js)
    ts = T.state_from_numpy(arrays)
    assert ts.capacity == js.capacity
    back = T.state_to_numpy(ts)
    assert set(back) == set(arrays)
    for k in arrays:
        assert_bit_equal(back[k], arrays[k], k)
    np.testing.assert_array_equal(ts.displacement().numpy(),
                                  np.asarray(js.displacement()))
    with pytest.raises(ValueError):
        T.state_from_numpy({k: v for k, v in arrays.items() if k != "w"})


def test_checkpoints_cross_load(tmp_path):
    jcfg = J.SimConfig(k_stiffness=0.8)
    js = random_state(jcfg, n=130)
    p = str(tmp_path / "jax_ckpt")
    J.save_checkpoint(p, js, step=17, cfg=jcfg)
    ts, step, tcfg = T.load_checkpoint(p, with_config=True)
    assert step == 17 and tcfg == torch_cfg(jcfg)
    for k, v in jax_state_arrays(js).items():
        assert_bit_equal(T.state_to_numpy(ts)[k], v, k)
    # and the other way: a port checkpoint loads in the JAX package
    q = str(tmp_path / "torch_ckpt")
    T.save_checkpoint(q, ts, step=5, cfg=tcfg)
    js2, step2, jcfg2 = J.load_checkpoint(q, with_config=True)
    assert step2 == 5 and jcfg2 == jcfg
    for k, v in jax_state_arrays(js2).items():
        assert_bit_equal(v, T.state_to_numpy(ts)[k], k)


@pytest.mark.parametrize("name", ["biceps_full", "cube"])
def test_build_scene_bit_identical(name):
    js = J.build_scene(name)
    ts = T.build_scene(name)
    for f in ("cell_capacity", "neighbor_capacity", "num_particles", "name",
              "q_block", "block_window", "sub_block", "fused_impl",
              "pack_cap"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.cfg == torch_cfg(js.cfg)
    for k, v in jax_state_arrays(js.state).items():
        assert_bit_equal(T.state_to_numpy(ts.state)[k], v, k)
    if name == "biceps_full":
        assert (ts.num_particles, ts.state.capacity, ts.cell_capacity,
                ts.neighbor_capacity, ts.q_block, ts.block_window,
                ts.sub_block) == (18475, 18560, 196, 4464, 128, 128, 128)
    # the stimulus switch-off matches too
    joff = J.stim.turn_off_stim(js.state, js.cfg)
    toff = tep.turn_off_stim(ts.state, ts.cfg)
    for k, v in jax_state_arrays(joff).items():
        assert_bit_equal(T.state_to_numpy(toff)[k], v, k)


def test_set_stim_and_hits_match():
    jcfg = J.SimConfig()
    js = random_state(jcfg, n=180, seed=3)
    ts = to_torch_state(js)
    for radius, quirk in ((0.01, True), (0.1, False)):
        cfg_j = jcfg.replace(quirk_stim_radius_squared=quirk)
        cfg_t = torch_cfg(cfg_j)
        a = J.stim.set_stim(js, (0.62, 0.58, 0.6), radius, 250.0, cfg_j)
        b = tep.set_stim(ts, (0.62, 0.58, 0.6), radius, 250.0, cfg_t)
        assert_bit_equal(b.stim.numpy(), np.asarray(a.stim))
        centers = np.asarray(js.pos)[:40:3] + 0.01
        ha = J.stim.stim_hits_from_centers(js.pos, js.active, centers,
                                           radius, cfg_j, chunk=8)
        hb = tep.stim_hits_from_centers(ts.pos, ts.active, centers, radius,
                                        cfg_t, chunk=8)
        np.testing.assert_array_equal(hb.numpy(), np.asarray(ha))


def test_port_imports_no_jax():
    code = ("import sys; before = set(sys.modules); "
            "import sph_sm_monodomain_tpu_torch; "
            "new = {m.split('.')[0] for m in set(sys.modules) - before}; "
            "bad = new & {'jax', 'jaxlib', 'sph_sm_monodomain_tpu'}; "
            "assert not bad, bad; assert 'jax' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cpu_wrappers_never_need_the_card():
    """On CPU tensors the sweep wrappers take the plain versions, build no
    kernel and count no launch."""
    from sph_sm_monodomain_tpu_torch.ops import fused_step as tfs
    from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3
    ts = to_torch_state(random_state(J.SimConfig(), n=100))
    cfg = T.SimConfig()
    order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(ts.pos, ts.active, cfg,
                                                     128)
    fs, fa = tfs.build_qm_feats(ts, cx, cyz, order)
    before = (tfs.sweep_a3.launches, tfs.sweep_b3.launches)
    out_a = tfs.sweep_a3(fs, fa, lo, hi, cfg)
    assert out_a.shape == (128, 16) and torch.isfinite(out_a).all()
    assert (tfs.sweep_a3.launches, tfs.sweep_b3.launches) == before
    with pytest.raises(ValueError):
        tfs.sweep_a3(fs[:100], fa, lo, hi, cfg)
