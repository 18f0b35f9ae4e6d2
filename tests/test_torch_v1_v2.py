"""PyTorch port vs the JAX package: the v1 (per-query runs) and v2 (hash
run windows, PyTorch glue) ablation steps, on the CPU. The JAX side runs
its Pallas sweeps in interpret mode; the port runs the plain versions of
its kernels (ablation/legacy_sweeps.py).

- Bookkeeping (v1 sweep_bookkeeping) and auto_sweep2_params: exactly equal.
- Sweeps, on the live rows: the JAX suite's own v1 sweep tolerances
  (tests/test_pallas_sweeps.py:58-95): xsph 2e-5, acc (acc_raw over the
  density) 5e-4, lap 5e-3 absolute, dens 1e-5 relative. They are looser
  than the v3 / v5 sweep tolerance, 1e-6 * max(1, max |column|), because
  the Pallas kernels sum in the MXU's form x_i * sum f - sum f * x_j,
  which loses about |x| / |dx| of relative precision, where the port sums
  each pair as f * (x_j - x_i). A float64 evaluation of the port's plain
  sums is the witness: the port lies within 1e-6 * max(1, max |column|)
  of it. Measured worst, over the five cases below: port vs JAX, xsph
  7.2e-7, acc 3.54e-4 (0.71 of its tolerance), lap 5.7e-6, dens 2.2e-7
  relative; JAX vs float64, acc 3.53e-4; port vs float64, 2.1e-7 *
  max(1, max |column|) (acc 1.2e-5 absolute). So the acc gap is JAX's.
- Dead (padding) rows: the port's sums are exactly 0. JAX's v1 sums are 0
  there too; JAX's v2 sums are not: its 128-aligned chunks read past the
  window ends into the padding rows, which all sit at one far point and
  pass the hash test against each other (r = 0). Only padding rows see
  those pairs.
- Steps and run_protocol, on the active rows: the JAX suite's fused-step
  tolerances, pos 5e-5, vel 5e-3, vm 5e-3, iion 1e-5, w 1e-6 absolute,
  dens 1e-5 relative (tests/test_pallas_sweeps.py), each at the larger of
  that and twice JAX's own spread when the input positions move by one
  ulp (tests/torch_parity.py).
"""

import jax
import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.ablation import legacy_sweeps as jls
from sph_sm_monodomain_tpu.ops import fused_step as jfs
from sph_sm_monodomain_tpu.ops import pallas_sweeps as jps
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ablation import legacy_sweeps as tls
from sph_sm_monodomain_tpu_torch.ops import sweeps as tsw

from torch_parity import (assert_states_close, jax_steps, named_state,
                          slice_scenes, to_torch_state, torch_cfg)
from torch_parity import ulp_spreads  # noqa: F401 (a fixture)

# the JAX suite's v1 sweep tolerances (absolute; acc after / dens)
SUITE_ATOL = {"xsph": 2e-5, "acc": 5e-4, "lap": 5e-3}
DENS_RTOL = 1e-5
# the port against a float64 evaluation of its own plain sums
F64_TOL = 1e-6
# the JAX bookkeeping, compiled once per (config, sub_q) (eagerly, each
# new grid takes seconds)
_jax_bookkeeping = jax.jit(jls.sweep_bookkeeping, static_argnums=(2, 3))
_jax_bookkeeping2 = jax.jit(jps.sweep_bookkeeping2, static_argnums=(2, 3))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["padded", "slice", "wide_world",
                                  "sparse"])
def test_bookkeeping_exact(case):
    """order, inv, the per-query runs and the 128-aligned block windows
    equal JAX's at 32- and 128-row blocks."""
    jcfg, js = named_state(case)
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    names = ("order", "inv", "qstart", "qend", "blk_start", "blk_len")
    for sub_q in (32, 128):
        tb = tls.sweep_bookkeeping(ts.pos, ts.active, tcfg, sub_q)
        jb = _jax_bookkeeping(js.pos, js.active, jcfg, sub_q)
        for name, t, j in zip(names, tb, jb):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{name}, sub_q {sub_q}")
        assert tb[2].dtype == torch.int32 and tb[2].shape == (ts.capacity, 16)


def _check_sweep(name, t, j, w, live, dens):
    """One sweep output (port t, JAX j, port in float64 w) on the live
    rows; the port's dead rows 0. Returns (max |port - JAX| over the
    tolerance, max |port - float64| / max(1, max |column|))."""
    rows = len(live)
    t, j, w = (np.asarray(a, np.float64).reshape(rows, -1) for a in (t, j, w))
    assert np.all(t[~live] == 0.0), name
    t, j, w = t[live], j[live], w[live]
    if name == "acc":
        t, j, w = (a / dens[live, None] for a in (t, j, w))
    if name == "dens":
        np.testing.assert_allclose(t, j, rtol=DENS_RTOL, err_msg=name)
        vs_jax = float((np.abs(t - j) / np.abs(j)).max()) / DENS_RTOL
    else:
        np.testing.assert_allclose(t, j, atol=SUITE_ATOL[name], err_msg=name)
        vs_jax = float(np.abs(t - j).max()) / SUITE_ATOL[name]
    scale = np.maximum(1.0, np.abs(w).max(axis=0))
    vs_f64 = float((np.abs(t - w).max(axis=0) / scale).max())
    assert vs_f64 <= F64_TOL, (name, vs_f64)
    return vs_jax, vs_f64


def _sorted_fields(js, order):
    """The step's sorted inputs of a JAX state (numpy): pos, cvel,
    previous-step volume, mass (sweep A's order), vm, stim, iion, w."""
    g = lambda a: np.asarray(a)[order]  # noqa: E731
    mass, dens = g(js.mass), g(js.dens)
    vol = np.where(dens > 0.0, mass / np.where(dens > 0.0, dens, 1.0),
                   0.0).astype(np.float32)
    return (g(js.pos), g(js.corrected_vel), vol, mass, g(js.vm), g(js.stim),
            g(js.iion), g(js.w))


def _sweep_b_inputs(jcfg, fields, dens, xsph):
    """Sweep B's inputs from sweep A's sums, by the JAX step's own glue:
    (ivel, vol_now, pres, the density guard)."""
    pos, cvel, _, mass, vm, stim, iion, w = fields
    ivel = cvel + np.asarray(xsph) * jcfg.velocity_mixing
    dens2, pres, _, _, _ = jfs._a_epilogue(jcfg, True, mass, vm, stim, iion,
                                           w, dens)
    dens2 = np.asarray(dens2)
    guard = np.where(dens2 > 0.0, dens2, 1.0).astype(np.float32)
    return (np.asarray(ivel, np.float32), mass / guard, np.asarray(pres),
            guard)


@pytest.mark.parametrize("case", ["v1_padded", "v1_slice", "v2_padded",
                                  "v2_slice", "v2_sub_q32"])
def test_sweeps_match_jax(case):
    """sweep_a / sweep_b (v1) and sweep_a2 / sweep_b2 (v2) on a state's
    step-0 inputs (128-row sub-blocks; v2_sub_q32: the padded state at
    v2's default 32), with a float64 evaluation of the port's plain sums
    as the witness; sweep B on the inputs the JAX step derives from JAX's
    sweep A, for both."""
    impl, _, state = case.partition("_")
    sub_q = 32 if state == "sub_q32" else 128
    jcfg, js = named_state("padded" if state == "sub_q32" else state)
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    if impl == "v1":
        jb = _jax_bookkeeping(js.pos, js.active, jcfg, sub_q)
        tb = tls.sweep_bookkeeping(ts.pos, ts.active, tcfg, sub_q)
        extra_j, extra_t = (), ()
        bounds_j, bounds_t = jb[2:], tb[2:]
        run_a = (jls.sweep_a, tls.sweep_a)
        run_b = (jls.sweep_b, tls.sweep_b)
    else:
        jb = _jax_bookkeeping2(js.pos, js.active, jcfg, sub_q)
        tb = tsw.sweep_bookkeeping2(ts.pos, ts.active, tcfg, sub_q)
        hash_s = np.asarray(jb[4])[np.asarray(jb[0])]
        extra_j, extra_t = (hash_s,), (_t(hash_s),)
        bounds_j, bounds_t = jb[2:4], tb[2:4]
        run_a = (jls.sweep_a2, tls.sweep_a2)
        run_b = (jls.sweep_b2, tls.sweep_b2)
    order = np.asarray(jb[0])
    live = np.asarray(js.active)[order]
    fields = _sorted_fields(js, order)
    jkw = dict(interpret=True, sub_q=sub_q)

    def port(fn, arrays, f64=False):
        ts_ = [_t(a).double() if f64 else _t(a) for a in arrays]
        ex = [e.double() for e in extra_t] if f64 else extra_t
        return fn(*ts_, *ex, *bounds_t, tcfg, sub_q)

    in_a = fields[:4]
    ja = run_a[0](*in_a, *extra_j, *bounds_j, sub_q, 128, jcfg, **jkw)
    ta, wa = port(run_a[1], in_a), port(run_a[1], in_a, True)
    ivel, vol_now, pres, guard = _sweep_b_inputs(jcfg, fields, *ja)
    in_b = (fields[0], ivel, vol_now, pres, fields[4])
    jo = run_b[0](*in_b, *extra_j, *bounds_j, sub_q, 128, jcfg, **jkw)
    to, wo = port(run_b[1], in_b), port(run_b[1], in_b, True)
    names = ("dens", "xsph", "acc", "lap")
    worst = [_check_sweep(name, *outs, live, guard)
             for name, *outs in zip(names, ta + to, ja + jo, wa + wo)]
    print(f"{case}: vs JAX (of the tolerance), vs float64: "
          + ", ".join(f"{n} {a:.3g} {b:.3g}" for n, (a, b) in zip(names,
                                                                  worst)))


def _run_steps(js, jcfg, impl, steps, sub_q):
    """`steps` fused steps in both packages; returns (port, JAX) states."""
    ts, tcfg = to_torch_state(js), torch_cfg(jcfg)
    for _ in range(steps):
        js, jaux = J.step_fused(js, jcfg, sub_q, 128, sub_q, impl=impl)
        ts, taux = T.step_fused(ts, tcfg, sub_q, impl=impl)
        assert int(taux.overflow) == int(jaux.overflow) == 0
    return ts, js


@pytest.mark.parametrize("case", ["v1_padded", "v2_padded", "v1_sparse",
                                  "v2_sparse", "v1_wide_world"])
def test_step_matches_jax(case, ulp_spreads):
    """3 fused steps against JAX step_fused(impl=...), at 128-row
    sub-blocks.
    The sparse state takes sm_alpha = 0: its shape matching is fp32 noise
    in both packages (test_torch_v3_v5.py)."""
    impl, _, state = case.partition("_")
    jcfg, js = named_state(state)
    if state == "sparse":
        jcfg = jcfg.replace(sm_alpha=0.0)
    ts, jst = _run_steps(js, jcfg, impl, 3, 128)
    spread = ulp_spreads(case, jax_steps(jcfg, impl, 3, 128), js, ref=jst)
    assert_states_close(ts, jst, np.asarray(jst.active), spread=spread)


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_build_scene_matches_jax(impl):
    """build_scene(fused_impl="v1" | "v2") tunes as JAX does: v4's
    auto_sweep4_params at 128-row sub-blocks."""
    js = J.build_scene("susane", stim=False, fused_impl=impl)
    ts = T.build_scene("susane", stim=False, fused_impl=impl, device="cpu")
    for f in ("sub_block", "pack_cap", "block_window", "q_block",
              "fused_impl", "num_particles", "cell_capacity",
              "neighbor_capacity"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.state.capacity == js.state.capacity


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_run_protocol_matches_jax(impl, ulp_spreads):
    """run_protocol on the biceps slice, 4 steps in chunks of 2, stim off
    at 2, against JAX run_protocol(fused=True); neither can overflow, so
    each chunk runs once."""
    jsc, tsc = slice_scenes(fused_impl=impl)
    jst, jaux, _ = J.run_protocol(jsc, num_steps=4, chunk=2, stim_off_step=2,
                                  fused=True)
    tst, taux, _ = T.run_protocol(tsc, num_steps=4, chunk=2,
                                  stim_off_step=2)
    assert int(jaux.overflow) == int(taux.overflow) == 0
    spread = ulp_spreads(
        f"slice/{impl}", lambda s: J.run_protocol(
            jsc._replace(state=s), num_steps=4, chunk=2, stim_off_step=2,
            fused=True)[0], jsc.state, ref=jst)
    act = np.asarray(jst.active)
    assert_states_close(tst, jst, act, spread=spread)
    assert np.all(tst.stim.numpy()[act] == -10000.0)


def test_auto_sweep2_params_matches_jax(monkeypatch):
    """The port's tuner equals JAX's once numpy is injected into the JAX
    module (which calls `np` without importing it); unpatched, the JAX
    function raises NameError."""
    jcfg, js = named_state("slice")
    pts = np.asarray(js.pos)[np.asarray(js.active)]
    with pytest.raises(NameError):
        jls.auto_sweep2_params(pts, jcfg)
    monkeypatch.setattr(jls, "np", np, raising=False)
    tcfg = torch_cfg(jcfg)
    for sub_q in (32, 64, 128):
        assert tls.auto_sweep2_params(pts, tcfg, sub_q) \
            == jls.auto_sweep2_params(pts, jcfg, sub_q)
    wide_cfg, wide = named_state("wide_world")
    wpts = np.asarray(wide.pos)[np.asarray(wide.active)]
    assert tls.auto_sweep2_params(wpts, torch_cfg(wide_cfg)) \
        == jls.auto_sweep2_params(wpts, wide_cfg)


def test_wrappers_check_shapes():
    """The sweeps reject bounds of the wrong shape on the CPU too, and the
    CPU path launches nothing."""
    jcfg, js = named_state("padded")
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    order, _, qs, qe, bs, bl = tls.sweep_bookkeeping(ts.pos, ts.active, tcfg,
                                                     128)
    n = ts.capacity
    args = (ts.pos[order], ts.corrected_vel[order], ts.mass[order],
            ts.mass[order])
    before = tls.sweep_a.launches
    dens, xsph = tls.sweep_a(*args, qs, qe, bs, bl, tcfg)
    assert dens.shape == (n,) and xsph.shape == (n, 3)
    assert tls.sweep_a.launches == before
    with pytest.raises(ValueError):
        tls.sweep_a(*args, qs[:, :9], qe, bs, bl, tcfg)
    with pytest.raises(ValueError):
        tls.sweep_a(*args, qs, qe, bs[:, :9], bl, tcfg)
    _, _, lo, hi, chash = tsw.sweep_bookkeeping2(ts.pos, ts.active, tcfg, 64)
    with pytest.raises(ValueError):
        tls.sweep_a2(*args, chash[order], lo, hi, tcfg, sub_q=128)


def test_v2_equals_v4_on_cpu():
    """On CPU tensors v2's raw sums and PyTorch glue run the same float
    operations as v4's plain sweeps and epilogues (the hash9 and v4 masks
    pass the same pairs within the kernels' support, and both sum densely
    over every candidate), so 3 slice steps agree bit for bit. On the card
    they part: v4's epilogue runs inside the kernel, whose multiply-adds
    nvcc fuses."""
    _, tsc = slice_scenes()
    st = {impl: tsc.state for impl in ("v2", "v4")}
    for _ in range(3):
        for impl in st:
            st[impl], _ = T.step_fused(st[impl], tsc.cfg, 128, impl=impl)
    got, want = T.state_to_numpy(st["v2"]), T.state_to_numpy(st["v4"])
    for name in ("pos", "vel", "vm", "dens", "pres", "iion", "w"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("case", ["slice", "sparse"])
def test_plain_on_run_rows_matches_the_plain_sums(case):
    """legacy_sweeps.plain_on_run_rows, which the card checks use where the
    dense plain sums over every row would take minutes, gives the plain v1
    sums (_plain_a1 / _plain_b1 over all rows) of the rows it is given, in
    groups of 32 with dead and padding rows among them, up to the order of
    summation: within F64_TOL * max(1, max |column|)."""
    jcfg, js = named_state(case)
    cfg, st = torch_cfg(jcfg), to_torch_state(js)
    order, _, qs, qe, _, _ = tls.sweep_bookkeeping(st.pos, st.active, cfg,
                                                   128)
    pos, cvel, mass, dens, vm = (t[order] for t in (
        st.pos, st.corrected_vel, st.mass, st.dens, st.vm))
    ok = dens > 0.0
    vol = torch.where(ok, mass / torch.where(ok, dens, 1.0), 0.0)
    qa, fa = tls._inputs_a(pos, cvel, vol, mass)
    sums_a = tls._plain_a1(qa, fa, qs, qe, cfg)
    qb, fb = tls._inputs_b(pos, cvel, vol, cfg.k_stiffness
                           * (sums_a[:, 0] - cfg.stand_density), vm)
    n = qa.shape[0]
    rows = torch.cat([torch.arange(32), torch.arange(n - 64, n)])
    assert not bool(st.active[order][rows].all())
    for plain, qm, feats in ((tls._plain_a1, qa, fa),
                             (tls._plain_b1, qb, fb)):
        want = plain(qm, feats, qs, qe, cfg)[rows]
        got = torch.cat([tls.plain_on_run_rows(
            lambda *a, p=plain: p(*a, cfg), qm, feats, qs, qe, r)
            for r in rows.split(32)])
        scale = torch.clamp(want.abs().amax(dim=0), min=1.0)
        assert bool(((got - want).abs().amax(dim=0)
                     <= F64_TOL * scale).all()), plain.__name__
