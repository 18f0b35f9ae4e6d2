"""PyTorch port vs the JAX package: the v3 (hash9 run windows) and v5
(packed-slab) fused steps, on the CPU. The JAX side runs its Pallas sweeps
in interpret mode; the port runs the plain versions of its kernels.

- Bookkeeping (sweep_bookkeeping2 / 5, auto_sweep5_params) and slab
  packing: exactly equal.
- Sweeps: per output column, rtol 1e-5 and atol 1e-6 * max(1, max |JAX
  column|) (the sweep tolerance of tests/test_torch_sweeps.py: the same
  pairs summed in fp32 in another order).
- Steps and run_protocol: the JAX suite's fused-step tolerances, pos 5e-5,
  vel 5e-3, vm 5e-3, iion 1e-5, w 1e-6 absolute, dens 1e-5 relative
  (tests/test_pallas_sweeps.py); over several steps each field at the
  larger of that and twice JAX's own spread when the input positions move
  by one ulp (tests/torch_parity.py).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.models import monodomain as jmono
from sph_sm_monodomain_tpu.ops import fused_step as jfs
from sph_sm_monodomain_tpu.ops import pallas_sweeps as jps
from sph_sm_monodomain_tpu.ops import shape_matching as jsm
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.models import monodomain as tmono
from sph_sm_monodomain_tpu_torch.ops import fused_step as tfs
from sph_sm_monodomain_tpu_torch.ops import shape_matching as tsm
from sph_sm_monodomain_tpu_torch.ops import sweeps as tsw

from torch_parity import (assert_bit_equal, assert_states_close,
                          jax_steps, named_state as _state, slice_scenes,
                          to_torch_state, torch_cfg)
from torch_parity import ulp_spreads  # noqa: F401 (a fixture)

def _pack_cap(js, cfg, sub_q):
    """The tuner's slab capacity for this cloud at `sub_q`."""
    pts = np.asarray(js.pos)[np.asarray(js.active)]
    return jps.auto_sweep5_params(pts, cfg, sub_qs=(sub_q,))[1]


def _assert_equal(t_out, j_out, names):
    for name, t, j in zip(names, t_out, j_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("case", ["padded", "slice", "wide_world",
                                  "sparse_blocks"])
def test_bookkeeping_exact(case):
    jcfg, js = _state(case)
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    if case == "wide_world":
        assert tsw.hash_axis_perm(tcfg)[0] != 0
    for sub_q in (32, 64):
        _assert_equal(tsw.sweep_bookkeeping2(ts.pos, ts.active, tcfg, sub_q),
                      jps.sweep_bookkeeping2(js.pos, js.active, jcfg, sub_q),
                      ("order", "inv", "blk_lo", "blk_hi", "chash"))
    names = ("order", "inv", "src", "trips", "overflow", "cf", "cm", "cs")
    for sub_q, kb, w_chunk in ((16, 256, 128), (32, 512, 512),
                               (32, 128, 128)):
        tb = tsw.sweep_bookkeeping5(ts.pos, ts.active, tcfg, sub_q, kb,
                                    w_chunk)
        _assert_equal(tb, jps.sweep_bookkeeping5(js.pos, js.active, jcfg,
                                                 sub_q, kb, w_chunk), names)
        assert tb[3].dtype == torch.int32 and tb[4].dtype == torch.int32
    pts = np.asarray(js.pos)[np.asarray(js.active)]
    assert tsw.auto_sweep5_params(pts, tcfg) == \
        jps.auto_sweep5_params(pts, jcfg)


def _assert_columns_close(t, j, what):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape
    for c in range(j.shape[1]):
        atol = 1e-6 * max(1.0, float(np.abs(j[:, c]).max()))
        np.testing.assert_allclose(t[:, c], j[:, c], rtol=1e-5, atol=atol,
                                   err_msg=f"{what} column {c}")


def _vol(out_a):
    dens = out_a[:, 8]
    return np.where(dens > 0.0, out_a[:, 10] / np.where(dens > 0.0, dens,
                                                        1.0),
                    0.0).astype(np.float32)


_PARAMS = {"k_stiffness": 0.7, "mu_viscosity": 60.0, "velocity_mixing": 0.5,
           "fh_c1": 0.2, "voltage_constant": 2.0}


@pytest.mark.parametrize("case", ["default", "dynp", "no_ep"])
def test_hash9_sweeps_match_jax(case):
    """sweep_a3 / sweep_b3 with stencil="hash9" on a state with padding
    rows; sweep B on the same OUT_A for both. The dynp operand works under
    hash9, as in the JAX sweeps."""
    jcfg, js = _state("padded")
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    with_ep, sub_q = case != "no_ep", 64
    jdynp = tdynp = None
    if case == "dynp":
        jdynp = jfs.build_dynp(J.resolve_params(jcfg, _PARAMS))
        tdynp = tfs.build_dynp(T.resolve_params(tcfg, _PARAMS))
    jb = jps.sweep_bookkeeping2(js.pos, js.active, jcfg, sub_q)
    tb = tsw.sweep_bookkeeping2(ts.pos, ts.active, tcfg, sub_q)
    jq, jfa = jfs.build_qm_feats(js, jb[4], np.zeros_like(jb[4]), jb[0])
    tq, tfa = tfs.build_qm_feats(ts, tb[4], torch.zeros_like(tb[4]), tb[0])
    assert_bit_equal(tq.numpy(), np.asarray(jq), "QM_A")
    assert_bit_equal(tfa.numpy(), np.asarray(jfa), "sweep-A features")
    kw = dict(with_ep=with_ep, sub_q=sub_q, stencil="hash9")
    ja = np.asarray(jfs.sweep_a3(jq, jfa, jb[2], jb[3], sub_q, 128, jcfg,
                                 dynp=jdynp, **kw))
    n_a = tfs.sweep_a3_hash9.launches
    _assert_columns_close(tfs.sweep_a3(tq, tfa, tb[2], tb[3], tcfg,
                                       dynp=tdynp, **kw), ja, "OUT_A")
    jfb = jfs.feats_from_out_a(ja, _vol(ja))
    out_a = torch.from_numpy(ja.copy())
    tfb = tfs.feats_b(out_a)
    assert_bit_equal(tfb.numpy(), np.asarray(jfb), "sweep-B features")
    jout = jfs.sweep_b3(ja, jfb, jb[2], jb[3], sub_q, 128, jcfg, dynp=jdynp,
                        **kw)
    _assert_columns_close(tfs.sweep_b3(out_a, tfb, tb[2], tb[3], tcfg,
                                       dynp=tdynp, **kw), jout, "OUT_B")
    # the CPU path runs the plain versions: no kernel launch is counted
    assert tfs.sweep_a3_hash9.launches == n_a


@pytest.mark.parametrize("case", ["sub_q16", "sub_q32_static", "no_ep"])
def test_v5_sweeps_match_jax(case):
    """sweep_a5 / sweep_b5 (static_trips: v5s) on a state with padding
    rows; the packed slabs and the v5 QM_A bit-equal to JAX."""
    jcfg, js = _state("padded")
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    sub_q = 32 if case == "sub_q32_static" else 16
    kb, with_ep = _pack_cap(js, jcfg, sub_q), case != "no_ep"
    static = case == "sub_q32_static"
    jb = jps.sweep_bookkeeping5(js.pos, js.active, jcfg, sub_q, kb)
    tb = tsw.sweep_bookkeeping5(ts.pos, ts.active, tcfg, sub_q, kb)
    assert int(tb[4]) == 0
    jq = jfs.build_qm_feats5(js, jb[5], jb[6], jb[7], jb[0])
    tq = tfs.build_qm_feats5(ts, tb[5], tb[6], tb[7], tb[0])
    assert_bit_equal(tq.numpy(), np.asarray(jq), "QM_A")
    jpa, tpa = jfs.pack_feats_a5(jq, jb[2], kb), tfs.pack_feats_a5(tq, tb[2],
                                                                   kb)
    assert_bit_equal(tpa.numpy(), np.asarray(jpa), "sweep-A slabs")
    assert tpa.is_contiguous() and tpa.shape == (256 // sub_q, 16, kb)
    ja = np.asarray(jfs.sweep_a5(jq, jpa, jb[3], sub_q, 128, jcfg, with_ep,
                                 sub_q=sub_q, static_trips=static))
    kw = dict(with_ep=with_ep, sub_q=sub_q, static_trips=static)
    _assert_columns_close(tfs.sweep_a5(tq, tpa, tb[3], tcfg, **kw), ja,
                          "OUT_A")
    out_a = torch.from_numpy(ja.copy())
    jpb = jfs.pack_feats_b5(ja, _vol(ja), jb[2], kb)
    tpb = tfs.pack_feats_b5(out_a, tfs.vol_now(out_a), tb[2], kb)
    assert_bit_equal(tpb.numpy(), np.asarray(jpb), "sweep-B slabs")
    jout = jfs.sweep_b5(ja, jpb, jb[3], sub_q, 128, jcfg, with_ep,
                        sub_q=sub_q, static_trips=static)
    _assert_columns_close(tfs.sweep_b5(out_a, tpb, tb[3], tcfg, **kw), jout,
                          "OUT_B")


def _run_steps(js, jcfg, impl, steps, sub_q, pack_cap=0, w_chunk=128):
    """`steps` fused steps in both packages; returns (port, JAX) states
    and the port's largest overflow."""
    ts, tcfg = to_torch_state(js), torch_cfg(jcfg)
    over = 0
    for _ in range(steps):
        js, jaux = J.step_fused(js, jcfg, sub_q, w_chunk, sub_q, impl=impl,
                                pack_cap=pack_cap)
        ts, taux = T.step_fused(ts, tcfg, sub_q, impl=impl,
                                pack_cap=pack_cap, w_chunk=w_chunk)
        assert int(taux.overflow) == int(jaux.overflow)
        over = max(over, int(taux.overflow))
    return ts, js, over


@pytest.mark.parametrize("case", ["v3_padded", "v5_sub_q16",
                                  "v5_sub_q32", "v5s", "v5_wide_world",
                                  "v5_sparse_blocks"])
def test_step_matches_jax(case, ulp_spreads):
    """3 fused steps (2 on the wide world and the sparse blocks, as the JAX
    suite's own v5 tests) against JAX step_fused(impl=...)."""
    impl, _, rest = case.partition("_")
    state = {"padded": "padded", "wide_world": "wide_world",
             "sparse_blocks": "sparse"}.get(rest, "padded")
    jcfg, js = _state(state)
    if state == "sparse":
        # shape matching on this cloud is fp32 noise in both packages
        # (test_sparse_shape_matching_is_fp32_noise); sm_alpha = 0 takes
        # it out, so the step compares the sweeps
        jcfg = jcfg.replace(sm_alpha=0.0)
    if impl == "v3":
        args = (3, 64)
    else:
        sub_q = 16 if rest == "sub_q16" else 32
        steps = 2 if state in ("wide_world", "sparse") else 3
        args = (steps, sub_q, _pack_cap(js, jcfg, sub_q))
    ts, jst, over = _run_steps(js, jcfg, impl, *args)
    assert over == 0
    spread = ulp_spreads(case, jax_steps(jcfg, impl, *args), js, ref=jst)
    assert_states_close(ts, jst, np.asarray(jst.active), spread=spread)


@pytest.mark.parametrize("case", ["sparse", "padded"])
def test_sparse_shape_matching_is_fp32_noise(case):
    """At sm_alpha's default, the sparse-block state's corrected velocity
    differs between the packages far beyond the step tolerance (vel 5e-3):
    its two clusters lie along one diagonal, so the rest-shape moment Aqq
    has condition ~2.6e3 and A^T A's small eigen-directions, which the polar
    decomposition inverts, are fp32 noise. A float64 evaluation of the same
    steps is the witness: both fp32 packages lie about as far from it as
    from each other, so neither is right and the port is no worse than the
    reference. On a well-conditioned cloud all three agree."""
    err_j, err_t, err_jt = _corrected_vel_errors(case)
    assert err_t <= 2.0 * err_j
    if case == "sparse":
        assert err_jt > 5e-3 and err_j > 5e-3
    else:
        assert err_jt < 1e-4 and err_j < 1e-4


def _corrected_vel_errors(case):
    """Max |JAX - float64|, |port - float64| and |JAX - port| of the
    corrected velocity at step 0 of a named test state; the float64
    evaluation runs the port's shape matching on float64 tensors."""
    jcfg, js = _state(case)
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    act = np.asarray(js.active)
    ts64 = ts.replace(**{f.name: getattr(ts, f.name).double()
                         for f in dataclasses.fields(ts)
                         if getattr(ts, f.name).is_floating_point()})
    j = np.asarray(jsm.corrected_velocity(js, jcfg).corrected_vel)[act]
    t = tsm.corrected_velocity(ts, tcfg).corrected_vel.numpy()[act]
    w = tsm.corrected_velocity(ts64, tcfg).corrected_vel.numpy()[act]
    return (float(np.abs(j - w).max()), float(np.abs(t - w).max()),
            float(np.abs(j - t).max()))


def test_v5_wide_chunks_match():
    """Trip counts in w_chunk = 512 units walk the same slots as in 128
    units (JAX once multi-counted through them,
    tests/test_pallas_sweeps.py:452-465): the port at 512 against the port
    at 128 and against JAX at 512."""
    jcfg, js = _state("padded")
    ts512, js512, over = _run_steps(js, jcfg, "v5", 1, 16, 1024, 512)
    ts128 = T.step_fused(to_torch_state(js), torch_cfg(jcfg), 16, impl="v5",
                         pack_cap=1024)[0]
    assert over == 0
    act = np.asarray(js.active)
    assert_states_close(ts512, js512, act)
    np.testing.assert_allclose(ts512.dens.numpy()[act],
                               ts128.dens.numpy()[act], rtol=1e-6)
    np.testing.assert_allclose(ts512.pos.numpy()[act],
                               ts128.pos.numpy()[act], atol=1e-7)


def test_v5_overflow_reported():
    """An undersized pack_cap reports overflow (the regrow signal), as a
    device int32 tensor equal to the bookkeeping's count."""
    jcfg, js = _state("padded")
    ts, tcfg = to_torch_state(js), torch_cfg(jcfg)
    _, aux = T.step_fused(ts, tcfg, 16, impl="v5", pack_cap=128)
    assert aux.overflow.dtype == torch.int32 and int(aux.overflow) > 0
    jover = jps.sweep_bookkeeping5(js.pos, js.active, jcfg, 16, 128)[4]
    assert int(aux.overflow) == int(jover)


@pytest.mark.parametrize("impl", ["v3", "v5", "v5s"])
def test_params_and_capacity_checks(impl):
    """`params` off v4 raises ValueError, as in the JAX package; v5 needs
    pack_cap > 0."""
    jcfg, js = _state("padded")
    ts, tcfg = to_torch_state(js), torch_cfg(jcfg)
    with pytest.raises(ValueError):
        T.step_fused(ts, tcfg, impl=impl, pack_cap=512,
                     params={"k_stiffness": 0.8})
    with pytest.raises(ValueError):
        jmono.step_fused(js, jcfg, 128, 128, impl=impl, pack_cap=512,
                         params={"k_stiffness": 0.8})
    if impl != "v3":
        with pytest.raises(ValueError):
            T.step_fused(ts, tcfg, impl=impl, pack_cap=0)


def _v5_fields(js, jcfg):
    pts = np.asarray(js.pos)[np.asarray(js.active)]
    sub_q, kb, w_chunk = jps.auto_sweep5_params(pts, jcfg)
    return dict(fused_impl="v5", sub_block=sub_q, q_block=sub_q,
                pack_cap=kb, block_window=w_chunk)


def _pack_caps(module):
    """Patch `module.simulate` to record the pack_cap of every call."""
    seen, real = [], module.simulate

    def rec(*args, **kw):
        seen.append(kw.get("pack_cap"))
        return real(*args, **kw)
    return seen, mock.patch.object(module, "simulate", rec)


@pytest.mark.parametrize("impl", ["v3", "v5", "v5_regrow"])
def test_run_protocol_matches_jax(impl, ulp_spreads):
    """run_protocol on the biceps slice, 6 steps in chunks of 4, stim off
    at 3, against JAX run_protocol(fused=True). v5_regrow starts from
    32-row sub-blocks and pack_cap 128: both packages regrow to the same
    pack_cap (1.5x, rounded up to 128, chunk redone) and agree. The JAX
    scenes take q_block = sub_block, one sub-block per interpreted grid
    step, which compiles in half the time; the port has no q_block."""
    jsc, tsc = slice_scenes(fused_impl="v3", sub_block=64, q_block=64)
    if impl != "v3":
        fields = _v5_fields(jsc.state, jsc.cfg)
        if impl == "v5_regrow":
            fields.update(sub_block=32, q_block=32, pack_cap=128)
        jsc, tsc = jsc._replace(**fields), tsc._replace(**fields)
    jseen, jpatch = _pack_caps(jmono)
    tseen, tpatch = _pack_caps(tmono)
    with jpatch, tpatch:
        jst, jaux, _ = J.run_protocol(jsc, num_steps=6, chunk=4,
                                      stim_off_step=3, fused=True)
        tst, taux, _ = T.run_protocol(tsc, num_steps=6, chunk=4,
                                      stim_off_step=3)
    assert tseen == jseen
    if impl == "v5_regrow":
        assert tseen[0] == 128 and tseen[-1] > 128 and len(tseen) > 2
    assert int(jaux.overflow) == int(taux.overflow) == 0
    spread = ulp_spreads(
        f"slice/{impl}", lambda s: J.run_protocol(
            jsc._replace(state=s), num_steps=6, chunk=4, stim_off_step=3,
            fused=True)[0], jsc.state, ref=jst)
    act = np.asarray(jst.active)
    assert_states_close(tst, jst, act, spread=spread)
    assert np.all(tst.stim.numpy()[act] == -10000.0)


def test_run_protocol_defaults_to_v3():
    """A scene object without `fused_impl` runs v3, as in the JAX
    package."""
    _, tsc = slice_scenes()
    bare = tsc._asdict()
    bare.pop("fused_impl")
    bare_scene = type("BareScene", (), bare)
    with mock.patch.object(tmono, "step_fused",
                           wraps=tmono.step_fused) as spy:
        T.run_protocol(bare_scene, num_steps=1, chunk=1)
    assert spy.call_args.kwargs["impl"] == "v3"


@pytest.mark.parametrize("impl", ["v3", "v5", "v5s"])
def test_build_scene_matches_jax(impl):
    """build_scene(fused_impl=...) tunes like the JAX package: v3 takes
    v4's 128-row sub-blocks, v5 / v5s auto_sweep5_params' sub-block and
    pack_cap."""
    js = J.build_scene("susane", stim=False, fused_impl=impl)
    ts = T.build_scene("susane", stim=False, fused_impl=impl, device="cpu")
    for f in ("sub_block", "pack_cap", "block_window", "q_block",
              "fused_impl", "num_particles"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.state.capacity == js.state.capacity


if __name__ == "__main__":
    # The float64 witness of the sparse-block state's shape matching, on
    # the CPU:  PYTHONPATH=.:tests python tests/test_torch_v3_v5.py
    import jax
    jax.config.update("jax_platforms", "cpu")
    for name in ("sparse", "padded"):
        e_j, e_t, e_jt = _corrected_vel_errors(name)
        print(f"{name}: corrected velocity at step 0, max |JAX - float64| "
              f"{e_j:.6g}, |port - float64| {e_t:.6g}, |JAX - port| "
              f"{e_jt:.6g}", flush=True)
