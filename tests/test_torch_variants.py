"""PyTorch port vs the JAX package: the variant modes of models/variants.py
(frozen-cloud monodomain on the Laplacian sweep K3, with its gradient;
SPH-only, fused and unfused; SM-only; the unfused monodomain mode) and the
ported fit_fhn_fused_demo. Inputs are made with numpy from a seed and
handed to both packages; the JAX package runs its Pallas kernels in
interpret mode on the CPU, the port its plain sweep versions.

Tolerances, each with its reason:
  - the Laplacian sweep: the same pair math in fp32, summed in another
    order: 1e-5 of max(1, max|column|), the port's kernel-vs-plain bound;
  - monodomain_prepare_fused: the sort, windows and cell features are
    integer bookkeeping, so exactly equal; volumes, row sums and densities
    are fp32 sums, rtol 1e-5;
  - monodomain runs: the JAX suite's bounds, vm atol 1e-4 after 5 fused
    steps (tests/test_variants.py:197), 1e-5 for the unfused loop (:153);
  - gradients through K3: the JAX suite's fused-vs-XLA bound, value rtol
    1e-5 and gradient atol 1e-4 * max(1, max|g|)
    (tests/test_differentiable.py:91-96);
  - SPH-only: pos atol 2e-5, dens rtol 1e-4 (tests/test_variants.py:48-51);
  - SM-only: pos atol 5e-5, the JAX suite's fused-step position bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import sph_sm_monodomain_tpu as J
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu.models import variants as jv
from sph_sm_monodomain_tpu.ops import fused_step as jfst
from sph_sm_monodomain_tpu_torch.examples import fhn_wave_demo
from sph_sm_monodomain_tpu_torch.examples import fit_fhn_fused_demo
from sph_sm_monodomain_tpu_torch.models import variants as tv
from sph_sm_monodomain_tpu_torch.ops import fused_step as tfst

from torch_parity import (SPREAD_FACTOR, bump_pos, to_torch_state,
                          torch_cfg)

# CELL_CAP: the JAX table's per-cell bucket width (the port's sorted table
# has no buckets, so only the JAX side takes it)
CELL_CAP, NBR_CAP = 32, 9 * 64
SUB_Q = 64
KERNEL_TOL = 1e-5


def _blob_states(n=200, seed=0, stim="local", cfg=None):
    """(jcfg, JAX state, port cfg, port state): a Gaussian blob (padding
    rows above n), stimulated around its first particle or everywhere."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(size=(n, 3)).astype(np.float32) * 0.05 + 0.6,
                  0.05, 1.2)
    jcfg = cfg or J.SimConfig()
    js = J.init_fluid(pts, jcfg)
    tcfg = torch_cfg(jcfg)
    ts = T.init_fluid(pts, tcfg, device="cpu")
    if stim == "local":
        js = J.stim.set_stim(js, tuple(pts[0]), 0.001, jcfg.stim_strength,
                             jcfg)
        ts = T.stim.set_stim(ts, tuple(pts[0]), 0.001, tcfg.stim_strength,
                             tcfg)
    return jcfg, js, tcfg, ts


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_cols(got, want, what=""):
    got = _np(got).astype(np.float64).reshape(len(got), -1)
    want = _np(want).astype(np.float64).reshape(len(want), -1)
    bound = KERNEL_TOL * np.maximum(1.0, np.abs(want).max(axis=0))
    err = np.abs(got - want).max(axis=0)
    assert np.all(err <= bound), (what, err, bound)


def _prepare_both(seed=0, n=200):
    jcfg, js, tcfg, ts = _blob_states(n=n, seed=seed)
    jtab = jv.monodomain_prepare_fused(js, jcfg, q_block=SUB_Q, w_chunk=128,
                                       sub_q=SUB_Q)
    ttab = tv.monodomain_prepare_fused(ts, tcfg, sub_q=SUB_Q)
    return jcfg, js, jtab, tcfg, ts, ttab


@pytest.mark.parametrize("form", ["forward", "backward"])
def test_sweep_lap3_plain_matches_jax(form):
    """K3's plain version against the JAX Pallas kernel on the same inputs,
    on a state with 56 padding rows: the forward form (random vm, the
    tables' volumes) and the backward form (zero query vm, unit candidate
    volumes, a random cotangent as candidate vm), where padding rows are
    excluded by the cell mask alone."""
    jcfg, js, jtab, tcfg, ts, ttab = _prepare_both()
    n = ts.capacity
    assert n - int(ts.active.sum()) == 56
    rng = np.random.default_rng(1)
    g = rng.normal(size=n).astype(np.float32) * 10.0
    vol = np.asarray(jtab.vol_s)
    if form == "forward":
        vm_q, vol_row, vm_row = g, vol, g
    else:
        vm_q, vol_row, vm_row = np.zeros(n, np.float32), np.ones(
            n, np.float32), g
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    qm, feats = tv._lap_inputs(t(vm_q), t(vol_row), t(vm_row), ttab.pos_s,
                               ttab.cx_s, ttab.cyz_s)
    want = jfst.sweep_lap3(jnp.asarray(qm.numpy()),
                           jnp.asarray(feats.numpy()), jtab.blk_lo,
                           jtab.blk_hi, SUB_Q, 128, jcfg, sub_q=SUB_Q)
    got = tfst.sweep_lap3_plain(qm, feats, tcfg)
    _close_cols(got, want, form)
    assert not got[:, 1:].any()
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(
        tfst.sweep_lap3(qm, feats, ttab.blk_lo, ttab.blk_hi, tcfg, SUB_Q),
        got, rtol=0, atol=0)
    # padding rows (sorted last) get exactly 0
    assert not got[int(ts.active.sum()):, 0].any()


def test_monodomain_prepare_fused_matches_jax():
    jcfg, js, jtab, tcfg, ts, ttab = _prepare_both(seed=3)
    for f in ("order", "inv", "blk_lo", "blk_hi", "cx_s", "cyz_s", "pos_s",
              "mass"):
        np.testing.assert_array_equal(_np(getattr(ttab, f)),
                                      np.asarray(getattr(jtab, f)), f)
    for f in ("vol_s", "rowsum_s", "dens"):
        np.testing.assert_allclose(_np(getattr(ttab, f)),
                                   np.asarray(getattr(jtab, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)


def test_simulate_monodomain_only_fused_matches_jax():
    jcfg, js, jtab, tcfg, ts, ttab = _prepare_both(seed=4)
    jout, jvm = jv.simulate_monodomain_only_fused(
        js, jtab, jcfg, num_steps=5, q_block=SUB_Q, w_chunk=128,
        record_every=2, sub_q=SUB_Q)
    n = tfst.sweep_lap3.launches
    tout, tvm = tv.simulate_monodomain_only_fused(
        ts, ttab, tcfg, num_steps=5, record_every=2, sub_q=SUB_Q)
    assert tfst.sweep_lap3.launches == n      # CPU tensors: no kernel
    act = np.asarray(js.active)
    np.testing.assert_allclose(_np(tout.vm)[act], np.asarray(jout.vm)[act],
                               atol=1e-4)
    # one frame after each full block of 2 steps; the 5th step unrecorded
    assert tuple(tvm.shape) == tuple(np.asarray(jvm).shape) == (2, ts.capacity)
    np.testing.assert_allclose(_np(tvm)[:, act], np.asarray(jvm)[:, act],
                               atol=1e-4)
    for f in ("iion", "w", "inter_vm"):
        np.testing.assert_allclose(_np(getattr(tout, f))[act],
                                   np.asarray(getattr(jout, f))[act],
                                   atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(_np(tout.pos), np.asarray(js.pos))
    assert float(np.abs(_np(tout.vm)[act]).max()) > 0.0


def test_lap_vm_fn_gradients_match_jax():
    """d loss / d (vm0, sigma_i) of a 3-step fused monodomain rollout:
    the port's LapVmFn (K3's plain version backward) against jax.grad
    through the JAX package's custom VJP (Pallas in interpret mode)."""
    jcfg, js, jtab, tcfg, ts, ttab = _prepare_both(seed=5, n=96)
    rng = np.random.default_rng(6)
    n = ts.capacity
    wgt = rng.normal(size=n).astype(np.float32)
    vm0 = rng.normal(size=n).astype(np.float32) * 5.0

    def jloss(vm, sig):
        out = jv.simulate_monodomain_only_fused(
            js.replace(vm=vm), jtab, jcfg, num_steps=3, q_block=SUB_Q,
            w_chunk=128, sub_q=SUB_Q, params={"sigma_i": sig})
        return jnp.sum(jnp.where(out.active, out.vm * wgt, 0.0))

    jval, (jg_vm, jg_sig) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(vm0), jnp.float32(jcfg.sigma_i))

    vm_t = torch.from_numpy(vm0).requires_grad_()
    sig_t = torch.tensor(tcfg.sigma_i, requires_grad=True)
    out = tv.simulate_monodomain_only_fused(
        ts.replace(vm=vm_t), ttab, tcfg, num_steps=3, sub_q=SUB_Q,
        params={"sigma_i": sig_t})
    val = torch.where(out.active, out.vm * torch.from_numpy(wgt),
                      torch.zeros_like(out.vm)).sum()
    g_vm, g_sig = torch.autograd.grad(val, (vm_t, sig_t))

    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    jg = np.asarray(jg_vm)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(g_vm.numpy(), jg,
                               atol=1e-4 * max(1.0, np.abs(jg).max()))
    np.testing.assert_allclose(float(g_sig), float(jg_sig),
                               atol=1e-4 * max(1.0, abs(float(jg_sig))))


@pytest.fixture(scope="module")
def ep_constant_grads():
    """d loss / d (fh_c1, sigma_i) of the JAX suite's 3-step monodomain
    rollout (tests/test_params.py:140-179: 96 particles, vm ~ N(0, 5^2), a
    weighted vm sum), as (value, gradient) of JAX's unfused and fused paths
    and of the port's unfused and fused paths; and ("spread", fused): JAX's
    own relative change of (value, gradient) when every live row's pos
    moves one float32 ulp (tests/torch_parity.bump_pos)."""
    rng = np.random.default_rng(0)
    pts = np.clip(rng.normal(size=(96, 3)).astype(np.float32) * 0.05 + 0.6,
                  0.1, 1.3)
    jcfg = J.SimConfig()
    js = J.stim.set_stim(J.init_fluid(pts, jcfg), (0.6, 0.6, 0.6), 0.5,
                         jcfg.stim_strength, jcfg)
    vm = rng.normal(size=js.vm.shape).astype(np.float32) * 5.0
    wgt = np.random.default_rng(7).normal(size=js.vm.shape).astype(
        np.float32)
    js = js.replace(vm=jnp.asarray(vm))
    tcfg = torch_cfg(jcfg)
    ts = to_torch_state(js)
    ttab = tv.monodomain_prepare(ts, tcfg, 9 * 32)
    tftab = tv.monodomain_prepare_fused(ts, tcfg, sub_q=64)

    def jloss(js, fused):
        jtab = jv.monodomain_prepare(js, jcfg, 32, 9 * 32)
        jftab = jv.monodomain_prepare_fused(js, jcfg, q_block=64,
                                            w_chunk=128, sub_q=64)

        def f(theta):
            p = {"fh_c1": theta[0], "sigma_i": theta[1]}
            if fused:
                out = jv.simulate_monodomain_only_fused(
                    js, jftab, jcfg, num_steps=3, q_block=64, w_chunk=128,
                    sub_q=64, params=p)
            else:
                out = jv.simulate_monodomain_only(js, jtab, jcfg,
                                                  num_steps=3, params=p)
            return jnp.sum(jnp.where(out.active, out.vm * wgt, 0.0))
        return f

    def tgrad(fused):
        theta = torch.tensor([tcfg.fh_c1, tcfg.sigma_i], requires_grad=True)
        p = {"fh_c1": theta[0], "sigma_i": theta[1]}
        if fused:
            out = tv.simulate_monodomain_only_fused(ts, tftab, tcfg, 3,
                                                    sub_q=64, params=p)
        else:
            out = tv.simulate_monodomain_only(ts, ttab, tcfg, 3, params=p)
        val = torch.where(out.active, out.vm * torch.from_numpy(wgt),
                          torch.zeros_like(out.vm)).sum()
        (g,) = torch.autograd.grad(val, theta)
        return float(val.detach()), g.numpy()

    theta = jnp.asarray([jcfg.fh_c1, jcfg.sigma_i], jnp.float32)
    out = {}
    for fused in (False, True):
        v, g = jax.value_and_grad(jloss(js, fused))(theta)
        vb, gb = jax.value_and_grad(jloss(bump_pos(js), fused))(theta)
        g, gb = np.asarray(g), np.asarray(gb)
        out[("jax", fused)] = (float(v), g)
        out[("spread", fused)] = (abs(float(vb) - float(v)) / abs(float(v)),
                                  float((np.abs(gb - g) / np.abs(g)).max()))
        out[("port", fused)] = tgrad(fused)
    return out


@pytest.mark.parametrize("pair", [
    ("port fused", "port unfused"), ("port fused", "jax unfused"),
    ("port unfused", "jax unfused"), ("port fused", "jax fused")])
def test_ep_constant_grad_matches(ep_constant_grads, pair):
    """d loss / d (fh_c1, sigma_i) through the port's fused monodomain
    path (K3's plain version forward and backward, here on the CPU)
    against its unfused path, both against JAX's unfused autodiff, and
    the fused against JAX's fused gradient: the JAX suite's value rtol
    1e-5 and gradient rtol 2e-4 (tests/test_params.py:176-179), each the
    larger of that and SPREAD_FACTOR x JAX's own 1-ulp spread of the two
    forms compared (tests/torch_parity.py). d/d sigma_i is ~4e-6 of a
    loss of ~26: one ulp of the input positions moves JAX's unfused value
    of it by 1.2e-4 (relative) on an AVX2 host."""
    def get(name):
        pkg, form = name.split()
        return ep_constant_grads[(pkg, form == "fused")]

    spreads = [ep_constant_grads[("spread", name.endswith(" fused"))]
               for name in pair]
    v_rtol = max(1e-5, SPREAD_FACTOR * max(sp[0] for sp in spreads))
    g_rtol = max(2e-4, SPREAD_FACTOR * max(sp[1] for sp in spreads))
    (va, ga), (vb, gb) = get(pair[0]), get(pair[1])
    assert np.abs(gb).min() > 0, f"a gradient vanished: {gb}"
    np.testing.assert_allclose(va, vb, rtol=v_rtol)
    np.testing.assert_allclose(ga, gb, rtol=g_rtol)


def test_lap_vm_fn_composes_with_checkpoint():
    """The same 4-step gradient w.r.t. vm0 with every step under
    torch.utils.checkpoint: equal to the plain one (CPU arithmetic is
    deterministic, so bit for bit)."""
    jcfg, js, jtab, tcfg, ts, ttab = _prepare_both(seed=7, n=96)
    vm0 = torch.from_numpy(np.random.default_rng(8).normal(
        size=ts.capacity).astype(np.float32) * 5.0)

    def step(s):
        return tv.simulate_monodomain_only_fused(s, ttab, tcfg, 1,
                                                 sub_q=SUB_Q)

    grads = []
    for remat in (False, True):
        v = vm0.clone().requires_grad_()
        s = ts.replace(vm=v)
        for _ in range(4):
            s = checkpoint(step, s, use_reentrant=False) if remat \
                else step(s)
        loss = (torch.where(s.active, s.vm, torch.zeros_like(s.vm))
                ** 2).sum()
        grads.append(torch.autograd.grad(loss, v)[0])
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_simulate_sph_only_matches_jax(fused):
    """5 pure-SPH steps of the port (unfused table, or the sweep kernels'
    plain versions with with_ep=False) against the JAX package's unfused
    SPH-only run, at the JAX suite's fused-vs-unfused bounds; frames every
    2 steps."""
    cfg = jv.sph_only_config(J.SimConfig())
    jcfg, js, tcfg, ts = _blob_states(n=300, seed=9, stim=None, cfg=cfg)
    jout, jaux, (jpos,) = jv.simulate_sph_only(js, jcfg, CELL_CAP, NBR_CAP,
                                               num_steps=5, record_every=2)
    tout, taux, (tpos,) = tv.simulate_sph_only(
        ts, tcfg, NBR_CAP, num_steps=5, record_every=2,
        fused=fused, sub_q=SUB_Q)
    assert int(taux.overflow) == int(jaux.overflow) == 0
    act = np.asarray(js.active)
    np.testing.assert_allclose(_np(tout.pos)[act], np.asarray(jout.pos)[act],
                               atol=2e-5)
    np.testing.assert_allclose(_np(tout.dens)[act],
                               np.asarray(jout.dens)[act], rtol=1e-4)
    assert tuple(tpos.shape) == tuple(np.asarray(jpos).shape)
    np.testing.assert_allclose(_np(tpos)[:, act], np.asarray(jpos)[:, act],
                               atol=2e-5)
    # EP state untouched, pressure live without a stimulus
    assert not tout.vm.any() and not tout.iion.any()
    assert float(np.abs(_np(tout.pres)[act]).max()) > 0


def test_simulate_sm_only_matches_jax():
    jcfg, js, tcfg, ts = _blob_states(n=150, seed=10, stim=None)
    jout, _, (jpos,) = jv.simulate_sm_only(js, jcfg, num_steps=10,
                                           record_every=4)
    tout, taux, (tpos,) = tv.simulate_sm_only(ts, tcfg, num_steps=10,
                                              record_every=4)
    assert int(taux.overflow) == 0
    act = np.asarray(js.active)
    np.testing.assert_allclose(_np(tout.pos)[act], np.asarray(jout.pos)[act],
                               atol=5e-5)
    assert tpos.shape[0] == np.asarray(jpos).shape[0] == 2
    np.testing.assert_allclose(_np(tpos)[:, act], np.asarray(jpos)[:, act],
                               atol=5e-5)
    assert not tout.acc.any()


def test_monodomain_unfused_matches_jax():
    """monodomain_prepare (table exact, densities rtol 1e-5), five
    step_monodomain_only steps, and simulate_monodomain_only's frames."""
    jcfg, js, tcfg, ts = _blob_states(n=150, seed=11)
    jtab = jv.monodomain_prepare(js, jcfg, CELL_CAP, NBR_CAP)
    ttab = tv.monodomain_prepare(ts, tcfg, NBR_CAP)
    np.testing.assert_array_equal(ttab.nbr.idx.numpy(),
                                  np.asarray(jtab.nbr.idx))
    np.testing.assert_allclose(ttab.dens.numpy(), np.asarray(jtab.dens),
                               rtol=1e-5)
    jst, tst = js, ts
    for _ in range(5):
        jst = jv.step_monodomain_only(jst, jtab, jcfg)
        tst = tv.step_monodomain_only(tst, ttab, tcfg)
    act = np.asarray(js.active)
    np.testing.assert_allclose(tst.vm.numpy()[act], np.asarray(jst.vm)[act],
                               atol=1e-5)
    tout, tvm = tv.simulate_monodomain_only(ts, ttab, tcfg, num_steps=5,
                                            record_every=5)
    assert tuple(tvm.shape) == (1, ts.capacity)
    np.testing.assert_allclose(tvm[0].numpy()[act], np.asarray(jst.vm)[act],
                               atol=1e-5)
    np.testing.assert_array_equal(tout.vm.numpy(), tvm[0].numpy())


def test_fit_fhn_fused_demo_cpu_smoke(capsys):
    """The ported Newton fit of the hidden stimulus amplitude through K3's
    backward (plain version here): susane, 4 steps, 2 iterations; the demo
    exits with an error unless the amplitude comes back within 1%."""
    out = fit_fhn_fused_demo.main(["susane", "4", "2", "--device", "cpu"])
    assert out["err"] <= 0.01
    assert "recovered amplitude" in capsys.readouterr().out


def test_fhn_wave_demo_cpu_smoke():
    """The ported wave demo (unfused monodomain path) on susane, 4 steps:
    a stimulated apex, a voltage that rises and stays finite."""
    vm = fhn_wave_demo.main(["4", "--scene", "susane", "--device", "cpu"])
    assert np.isfinite(vm).all() and vm.max() > 0.0
