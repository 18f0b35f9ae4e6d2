"""PyTorch port vs the JAX package: the AABB (ops/bounds.py), the state
health and determinism checks (utils/debug.py) and the chained timer
(utils/profiling.py), on the cases of tests/test_aux.py:15-92, 387-400.
Each port function gets the inputs the JAX function gets; booleans and
problem lists must be equal, float results equal to fp32 rounding
(rtol 1e-6)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.ops.bounds import Bounds as JBounds
from sph_sm_monodomain_tpu.utils import debug as jdebug
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops.bounds import Bounds as TBounds
from sph_sm_monodomain_tpu_torch.utils import debug as tdebug
from sph_sm_monodomain_tpu_torch.utils import profiling as tprof

JCFG, TCFG = J.SimConfig(), T.SimConfig()


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def _both(lo, hi):
    return TBounds.of(lo, hi, device="cpu"), JBounds.of(lo, hi)


def test_bounds_clamp_combine_intersect_include():
    tb, jb = _both((0, 0, 0), (1.5, 1.5, 1.5))
    pos = np.asarray([[-1.0, 0.5, 2.0], [0.1, 0.2, 0.3]], np.float32)
    _close(tb.clamp(torch.from_numpy(pos)), jb.clamp(jnp.asarray(pos)))
    to, jo = _both((-1, 0, 0), (1, 1, 1))
    for t, j in ((tb.combine(to), jb.combine(jo)),
                 (tb.intersect(to), jb.intersect(jo)),
                 (tb.include([[2.0, -3.0, 0.5]]),
                  jb.include([[2.0, -3.0, 0.5]]))):
        _close(t.min, j.min)
        _close(t.max, j.max)
    _close(tb.center(), jb.center())
    te, je = TBounds.empty(), JBounds.empty()
    assert bool(te.is_empty()) == bool(je.is_empty()) is True
    # an empty box passes positions through unchanged
    _close(te.clamp(torch.from_numpy(pos)), je.clamp(jnp.asarray(pos)))


@pytest.mark.parametrize("strict", [True, False])
def test_bounds_contain_2d_quirk(strict):
    """m3Bounds.h:70-74: strict `contain` only tests x and y."""
    tb, jb = _both((0, 0, 0), (1, 1, 1))
    pts = np.asarray([[0.5, 0.5, 99.0], [0.5, 2.0, 0.5], [0.2, 0.3, 0.4]],
                     np.float32)
    t = tb.contain(torch.from_numpy(pts), strict=strict).numpy()
    j = np.asarray(jb.contain(jnp.asarray(pts), strict=strict))
    np.testing.assert_array_equal(t, j)
    assert t[0] == strict


@pytest.mark.parametrize("strict", [True, False])
def test_bounds_clamp_offset_2d_quirk(strict):
    """m3Bounds.h:90-96: the strict inset clamp leaves z alone."""
    tb, jb = _both((0, 0, 0), (1, 1, 1))
    p = np.asarray([[2.0, 2.0, 2.0], [-1.0, 0.5, -1.0]], np.float32)
    t = tb.clamp_offset(torch.from_numpy(p), 0.1, strict=strict)
    _close(t, jb.clamp_offset(jnp.asarray(p), 0.1, strict=strict))


def _states(pts):
    return T.init_fluid(pts, TCFG, device="cpu"), J.init_fluid(pts, JCFG)


def test_validate_state_detects_nan(rng):
    pts = np.clip(rng.random((32, 3)).astype(np.float32), 0.1, 1.4)
    ts, js = _states(pts)
    assert tdebug.validate_state(ts, TCFG) == \
        jdebug.validate_state(js, JCFG) == []
    vm = ts.vm.clone()
    vm[3] = float("nan")
    got = tdebug.validate_state(ts.replace(vm=vm), TCFG)
    assert got == jdebug.validate_state(js.replace(vm=js.vm.at[3].set(
        jnp.nan)), JCFG)
    assert any("vm" in p for p in got)
    # NaN on a PADDED lane is not a problem
    vm = ts.vm.clone()
    vm[-1] = float("nan")
    assert tdebug.validate_state(ts.replace(vm=vm), TCFG) == []
    # outside the world and non-positive density, in both packages
    pos, dens = ts.pos.clone(), ts.dens.clone()
    pos[0, 0], dens[1] = -1.0, 0.0
    got = tdebug.validate_state(ts.replace(pos=pos, dens=dens), TCFG, "x: ")
    want = jdebug.validate_state(js.replace(
        pos=js.pos.at[0, 0].set(-1.0), dens=js.dens.at[1].set(0.0)),
        JCFG, "x: ")
    assert got == want and len(got) == 2


def test_assert_state_healthy_raises(rng):
    pts = np.clip(rng.random((16, 3)).astype(np.float32), 0.1, 1.4)
    ts, js = _states(pts)
    tdebug.assert_state_healthy(ts, TCFG)
    jdebug.assert_state_healthy(js, JCFG)
    pos = ts.pos.clone()
    pos[2, 1] = float("inf")
    with pytest.raises(AssertionError):
        tdebug.assert_state_healthy(ts.replace(pos=pos), TCFG, "unit-test")
    with pytest.raises(AssertionError):
        jdebug.assert_state_healthy(js.replace(pos=js.pos.at[2, 1].set(
            jnp.inf)), JCFG, "unit-test")


def test_step_is_deterministic(rng):
    pts = np.clip(rng.normal(size=(96, 3)).astype(np.float32) * 0.05 + 0.6,
                  0.1, 1.3)
    ts, js = _states(pts)
    assert tdebug.check_step_determinism(
        lambda s: T.step(s, TCFG, 9 * 32), ts)
    assert jdebug.check_step_determinism(
        lambda s: J.step(s, JCFG, 32, 9 * 32), js)
    # a step that differs from call to call is caught
    calls = []

    def drifting(s):
        calls.append(1)
        return s.replace(pos=s.pos + 1e-6 * len(calls))
    assert not tdebug.check_step_determinism(drifting, ts)


def test_nan_guard_raises_on_nonfinite_step(rng):
    pts = np.clip(rng.random((24, 3)).astype(np.float32), 0.1, 1.4)
    ts, _ = _states(pts)
    out, _ = tdebug.nan_guard(lambda s: T.step(s, TCFG, 9 * 32))(ts)
    assert torch.isfinite(out.pos[:24]).all()

    def poisoned(row):
        def fn(s):
            s2, aux = T.step(s, TCFG, 9 * 32)
            pos = s2.pos.clone()
            pos[row, 0] = float("nan")
            return s2.replace(pos=pos), aux
        return fn

    with pytest.raises(FloatingPointError):
        tdebug.nan_guard(poisoned(0))(ts)
    # non-finite values on INACTIVE lanes are not an error
    tdebug.nan_guard(poisoned(-1))(ts)


def test_time_chained_measures_dependent_calls(rng):
    pts = np.clip(rng.random((24, 3)).astype(np.float32), 0.1, 1.4)
    ts, _ = _states(pts)
    per_step, final = tprof.time_chained(lambda s: T.step(s, TCFG, 9 * 32),
                                         ts, steps=3)
    assert per_step > 0.0
    # the returned state is 3 steps downstream of the input (the warm-up
    # call's output is not fed on), as in the JAX package
    ref = ts
    for _ in range(3):
        ref, _ = T.step(ref, TCFG, 9 * 32)
    assert torch.equal(final.pos, ref.pos)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert d == str(tmp_path / "tr")
