"""PyTorch port vs the JAX package, end to end: the production v4 fused
`run_protocol` on a 462-particle biceps cloud (every 40th row of the
18,475-particle biceps_full cloud, tendon anchors fixed), 6 steps in
chunks of 4 with the stim switched off at step 3, across the chunk
boundary. The JAX side runs its Pallas sweeps in interpret mode; the port
runs its plain sweep versions on the CPU.

Tolerances are those of the JAX suite's own fused-vs-unfused step check
(tests/test_pallas_sweeps.py): pos 5e-5, vel 5e-3, vm 5e-3, iion 1e-5,
w 1e-6 absolute, dens 1e-5 relative.
"""

import numpy as np
import pytest

import sph_sm_monodomain_tpu as J
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu.ops import grid as jgrid

from torch_parity import (assert_bit_equal, biceps_slice_points,
                          jax_state_arrays, torch_cfg)

TOLS = {"pos": 5e-5, "vel": 5e-3, "vm": 5e-3, "iion": 1e-5, "w": 1e-6}


def _scenes():
    pts = biceps_slice_points(every=40)
    assert pts.shape == (462, 3)
    jcfg = J.SimConfig()
    js = J.init_fluid(pts, jcfg)
    js = J.stim.turn_on_stim_mesh(js, pts, jcfg)
    common = dict(cell_capacity=jgrid.auto_cell_capacity(pts, jcfg),
                  neighbor_capacity=jgrid.auto_window_capacity(pts, jcfg),
                  num_particles=pts.shape[0], name="biceps_every40",
                  q_block=128, block_window=128, sub_block=128,
                  fused_impl="v4")
    jsc = J.Scene(state=js, cfg=jcfg, **common)
    tcfg = torch_cfg(jcfg)
    ts = T.stim.turn_on_stim_mesh(T.init_fluid(pts, tcfg), pts, tcfg)
    tsc = T.Scene(state=ts, cfg=tcfg, **common)
    for k, v in jax_state_arrays(js).items():
        assert_bit_equal(T.state_to_numpy(ts)[k], v, k)
    assert int(np.asarray(js.fixed).sum()) > 0
    return jsc, tsc


def _assert_states_close(ts, js, act):
    got = T.state_to_numpy(ts)
    for name, atol in TOLS.items():
        np.testing.assert_allclose(got[name][act],
                                   np.asarray(getattr(js, name))[act],
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got["dens"][act], np.asarray(js.dens)[act],
                               rtol=1e-5, err_msg="dens")


def test_run_protocol_matches_jax():
    jsc, tsc = _scenes()
    calls = []

    def cb(step, state):
        calls.append(step)

    jst, jaux, jtraj = J.run_protocol(jsc, num_steps=6, chunk=4,
                                      stim_off_step=3, record_every=2,
                                      fused=True, impl="v4")
    tst, taux, ttraj = T.run_protocol(tsc, num_steps=6, chunk=4,
                                      stim_off_step=3, record_every=2,
                                      callback=cb)
    assert calls == [4, 6]
    assert int(jaux.overflow) == int(taux.overflow) == 0
    act = np.asarray(jst.active)
    _assert_states_close(tst, jst, act)
    # stim-off fired once, inside the first chunk
    np.testing.assert_array_equal(tst.stim.numpy(), np.asarray(jst.stim))
    assert np.all(tst.stim.numpy()[act] == -10000.0)
    assert not bool(tst.is_stim_on) and not bool(jst.is_stim_on)
    # recorded frames after steps 2, 4, 6
    assert ttraj["pos"].shape == tuple(np.asarray(jtraj["pos"]).shape) \
        == (3, tsc.state.capacity, 3)
    np.testing.assert_allclose(ttraj["pos"].numpy()[:, act],
                               np.asarray(jtraj["pos"])[:, act],
                               atol=TOLS["pos"])
    np.testing.assert_allclose(ttraj["vm"].numpy()[:, act],
                               np.asarray(jtraj["vm"])[:, act],
                               atol=TOLS["vm"])
    # the fixed tendon anchors did not move; the muscle did
    fixed = np.asarray(jst.fixed)
    np.testing.assert_array_equal(tst.pos.numpy()[fixed],
                                  tsc.state.pos.numpy()[fixed])
    assert float(tst.displacement().numpy()[act].max()) > 0.0


def test_step_fused_params_match_jax():
    """Per-call physics overrides through the constant vector, one step."""
    jsc, tsc = _scenes()
    params = {"k_stiffness": 0.8, "mu_viscosity": 50.0, "sm_alpha": 0.2,
              "fh_c3": 0.02}
    jst, _ = J.step_fused(jsc.state, jsc.cfg, 128, 128, 128, impl="v4",
                          params=params)
    tst, aux = T.step_fused(tsc.state, tsc.cfg, 128, impl="v4",
                            params=params)
    assert int(aux.overflow) == 0
    _assert_states_close(tst, jst, np.asarray(jst.active))


@pytest.mark.parametrize("cmd", ["stim_off", "stop"])
def test_run_protocol_callback_commands(cmd):
    """Between chunks, {"stim_off": True} switches the stim off at once and
    never again; {"stop": True} ends the run."""
    _, tsc = _scenes()
    seen = []

    def cb(step, state):
        seen.append((step, float(state.stim[0])))
        return {cmd: True} if step == 2 else None

    st, _, _ = T.run_protocol(tsc, num_steps=4, chunk=2, stim_off_step=10,
                              callback=cb)
    if cmd == "stop":
        assert seen == [(2, 300.0)]
        assert float(st.stim[0]) == 300.0
    else:
        assert seen == [(2, 300.0), (4, -10000.0)]
        assert not bool(st.is_stim_on)


def test_unported_paths_raise():
    _, tsc = _scenes()
    with pytest.raises(NotImplementedError):
        T.step_fused(tsc.state, tsc.cfg, impl="v5")
    with pytest.raises(NotImplementedError):
        T.run_protocol(tsc, num_steps=1, fused=False)
    with pytest.raises(NotImplementedError):
        T.build_scene("cube", replicate=2)
