"""The port's compiled gradient paths on the CPU: the checkpointed adjoint
scan of models/scan.py (`run_steps` under autograd) against plain autograd
through the same steps (`scan.run_steps_eager`), and the port's
value-and-grad rollouts against `jax.value_and_grad` of the JAX package's.

On the CPU the adjoint's forward and backward steps run eagerly, so these
tests hold its bookkeeping (carries, the reverse walk, the frames'
cotangents, the stim-off's, the operand accumulators and their reuse
across calls); the captured graphs are held to the eager adjoint on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 32).

Tolerances:
- adjoint against plain autograd: the loss and every gradient within 1e-5
  relative (the same per-step arithmetic; only the order in which the
  steps' cotangents are added differs);
- the port against JAX: the JAX suite's value rtol 1e-5 and gradient rtol
  1e-4 (tests/test_fused_adjoint.py, tests/test_params.py), each the
  larger of that and SPREAD_FACTOR x JAX's own relative change when every
  live row's position moves one float32 ulp (tests/torch_parity.py). The
  flagship losses of both packages are taken against one target (the
  port's displacement snapshots at the hidden material), so each JAX
  program compiles once.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.models import variants as jv
from sph_sm_monodomain_tpu.models.monodomain import step as jstep
from sph_sm_monodomain_tpu.ops import fused_adjoint as JFA
from sph_sm_monodomain_tpu.ops import shape_matching as jsm
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.examples import fit_fhn_fused_demo as fhn
from sph_sm_monodomain_tpu_torch.examples import fit_material_flagship as fit
from sph_sm_monodomain_tpu_torch.examples import fit_stimulus_demo as stim_demo
from sph_sm_monodomain_tpu_torch.models import monodomain as tmono
from sph_sm_monodomain_tpu_torch.models import scan
from sph_sm_monodomain_tpu_torch.models import variants as tv
from sph_sm_monodomain_tpu_torch.ops import shape_matching as tsm

from torch_parity import SPREAD_FACTOR, bump_pos, to_torch_state, torch_cfg

ADJ_RTOL = 1e-5
VALUE_RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops beside the suite's other parallel workers: torch's
    intra-op thread pool would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_autograd():
    """simulate's, the mode functions' and the flagship's steps through
    scan.run_steps_eager: plain autograd over the eager loop, the
    reference the adjoint is held to."""
    eager = scan.run_steps_eager
    return (mock.patch.object(tmono, "run_steps", eager),
            mock.patch.object(tv, "run_steps", eager),
            mock.patch.object(fit, "run_steps", eager))


def _susane():
    sc = T.build_scene("susane", device="cpu")
    return sc, tsm.sm_invariants(sc.state, sc.cfg)


def _vm_weights(n, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=n)
                            .astype(np.float32))


def _case_fused_v4():
    """The flagship loss, fused v4 step (step_fused_diff), 4 steps in 2
    displacement frames, w.r.t. log(K, mu)."""
    sc, inv = _susane()
    with torch.no_grad():
        target = fit.rollout_disp(sc, inv, fit.theta_of(0.9, 40.0, "cpu"),
                                  4, 2)
    loss = fit.make_loss(sc, inv, target, 4, 2)
    lt = fit.theta_of(0.5, 100.0, "cpu").requires_grad_()
    return loss(lt), (lt,)


def _unfused(steps, stim_off_step=-1, record_every=0, unroll=1):
    """The unfused coupled step through simulate: a loss of the final
    state (and of the frames, if any) w.r.t. (K, mu) and the stimulated
    particles' amplitude in the initial state."""
    sc, _ = _susane()
    st0, cfg = sc.state, sc.cfg
    amp = torch.tensor(300.0, requires_grad=True)
    theta = torch.tensor([0.6, 80.0], requires_grad=True)
    s = st0.replace(stim=torch.where(st0.stim > 0.0, amp, st0.stim))
    out = tmono.simulate(s, cfg, steps, stim_off_step=stim_off_step,
                         record_every=record_every, unroll=unroll,
                         params={"k_stiffness": theta[0],
                                 "mu_viscosity": theta[1]},
                         fused=False, neighbor_capacity=sc.neighbor_capacity)
    fin, w = out[0], _vm_weights(st0.capacity)
    val = (torch.where(fin.active, fin.vm * w, 0.0).sum()
           + (fit.displacement(fin) ** 2).sum() * 1e6)
    if record_every:
        val = val + (out[2]["vm"] * w).sum() * 0.5 \
            + ((out[2]["pos"] - st0.orig_pos) ** 2).sum() * 1e5
    return val, (theta, amp)


def _case_monodomain_fused():
    """The fused monodomain mode (K3's plain version through LapVmFn), 5
    steps, w.r.t. the initial vm and fh_c1."""
    sc, _ = _susane()
    st0, cfg = sc.state, sc.cfg
    tab = tv.monodomain_prepare_fused(st0, cfg, sub_q=sc.sub_block)
    rng = np.random.default_rng(3)
    vm0 = torch.from_numpy(rng.normal(size=st0.capacity).astype(np.float32)
                           * 5.0).requires_grad_()
    c1 = torch.tensor(cfg.fh_c1, requires_grad=True)
    out = tv.simulate_monodomain_only_fused(
        st0.replace(vm=vm0), tab, cfg, 5, sub_q=sc.sub_block,
        params={"fh_c1": c1})
    val = torch.where(out.active, out.vm * _vm_weights(st0.capacity),
                      0.0).sum()
    return val, (vm0, c1)


ADJOINT_CASES = {
    "fused_v4": _case_fused_v4,
    "unfused": lambda: _unfused(3),
    "monodomain_fused": _case_monodomain_fused,
    "stim_off": lambda: _unfused(3, stim_off_step=2),
    # frames after steps 2 and 4, step 5 a leftover past the last one
    "leftover": lambda: _unfused(5, record_every=2, unroll=3),
}


def _value_and_grads(case):
    val, wrt = ADJOINT_CASES[case]()
    grads = torch.autograd.grad(val, wrt)
    return [val.detach()] + [g.detach() for g in grads]


@pytest.mark.parametrize("case", sorted(ADJOINT_CASES))
def test_adjoint_scan_matches_plain_autograd(case):
    """Loss and gradients of the adjoint scan against plain autograd
    through the eager steps; twice, so that the second call runs on the
    cached backward step (its accumulators zeroed, its operands
    reloaded)."""
    scan.clear_cache()
    got = [_value_and_grads(case) for _ in range(2)]
    p1, p2, p3 = _plain_autograd()
    with p1, p2, p3:
        want = _value_and_grads(case)
    for g in got:
        for a, b in zip(g, want):
            assert torch.isfinite(b).all() and b.abs().max() > 0
            torch.testing.assert_close(a, b, rtol=ADJ_RTOL, atol=0)


def test_adjoint_scan_under_no_grad_and_without_grad_inputs():
    """Grad mode off, or no input requiring grad: the plain eager loop,
    whose result carries no autograd history."""
    sc, _ = _susane()
    theta = torch.tensor([0.6, 80.0], requires_grad=True)
    kw = dict(fused=False, neighbor_capacity=sc.neighbor_capacity)
    p = {"k_stiffness": theta[0], "mu_viscosity": theta[1]}
    with torch.no_grad():
        a = tmono.simulate(sc.state, sc.cfg, 2, params=p, **kw)[0]
    b = tmono.simulate(sc.state, sc.cfg, 2, params=p, **kw)[0]
    c = tmono.simulate(sc.state, sc.cfg, 2,
                       params={"k_stiffness": 0.6, "mu_viscosity": 80.0},
                       **kw)[0]
    assert a.pos.grad_fn is None and c.pos.grad_fn is None
    assert b.pos.grad_fn is not None
    torch.testing.assert_close(b.pos.detach(), a.pos, rtol=0, atol=0)
    torch.testing.assert_close(c.pos, a.pos, rtol=0, atol=0)


def test_adjoint_counts_one_backward_step_a_step():
    """The adjoint runs the step S times forward and 2 S times in all
    with its recompute; plain autograd S times (K1 / K2 and K3 counts on
    the card follow: chip_smoke.py phases 9, 13 and 32)."""
    calls = []
    sc, _ = _susane()

    def step(st, ops):
        calls.append(torch.is_grad_enabled())
        return tmono.step(st, sc.cfg, sc.neighbor_capacity, params=ops)

    theta = torch.tensor(0.7, requires_grad=True)
    out = scan.run_steps(step, sc.state, 3, key=("count",),
                         operands={"k_stiffness": theta})[0]
    torch.autograd.grad(out.pos.sum(), theta)
    assert calls == [False] * 3 + [True] * 3


def test_simulate_donated_under_grad_does_not_donate():
    """Under autograd simulate_donated leaves its input alone (the input
    is the adjoint's carry 0) and returns a new, differentiable state."""
    sc, _ = _susane()
    st = scan.copy_state(sc.state)
    before = st.pos.clone()
    theta = torch.tensor(0.6, requires_grad=True)
    out = tmono.simulate_donated(st, sc.cfg, 2,
                                 params={"k_stiffness": theta}, fused=False,
                                 neighbor_capacity=sc.neighbor_capacity)[0]
    assert torch.equal(st.pos, before)
    assert out.pos.data_ptr() != st.pos.data_ptr()
    (g,) = torch.autograd.grad(fit.displacement(out).pow(2).sum(), theta)
    assert torch.isfinite(g) and g != 0


def test_fit_cli_default_path_is_torch_autodiff(tmp_path):
    """Without --fused the flagship fits through the unfused step, as the
    JAX example does without it, and writes `torch-autodiff` in its row."""
    csv = tmp_path / "fit.csv"
    res = fit.main(["susane", "3", "2", "--device", "cpu", f"--csv={csv}"])
    assert res["grad_path"] == "torch-autodiff"
    assert np.all(np.isfinite(res["losses"]))
    assert csv.read_text().splitlines()[-1].split(";")[-1] \
        == "torch-autodiff"


# --- the port against the JAX package -----------------------------------

FLAGSHIP_STEPS, FLAGSHIP_SNAPS = 2, 2
STIM_STEPS, FHN_STEPS = 2, 4
THETA = (0.5, 100.0)
AMP = 250.0


def _jax_flagship(jsc, fused):
    """jit(value_and_grad) of the JAX example's flagship loss (its
    rollout: the step under jax.checkpoint, a scan of blocks, displacement
    snapshots) as a function of (log_theta, start state, target)."""
    jcfg, blk = jsc.cfg, FLAGSHIP_STEPS // FLAGSHIP_SNAPS

    def loss(log_theta, js0, target):
        params = {"k_stiffness": jnp.exp(log_theta[0]),
                  "mu_viscosity": jnp.exp(log_theta[1])}
        jinv = jsm.sm_invariants(js0, jcfg)

        @jax.checkpoint
        def body(s, _):
            if fused:
                s = JFA.step_fused_diff(s, jcfg, jsc.q_block,
                                        jsc.block_window, jsc.sub_block,
                                        sm_inv=jinv, params=params)
            else:
                s, _aux = jstep(s, jcfg, jsc.cell_capacity,
                                jsc.neighbor_capacity, sm_inv=jinv,
                                params=params)
            return s, ()

        def block(s, _):
            s, _ = jax.lax.scan(body, s, None, length=blk)
            return s, jnp.where(s.active[:, None], s.pos - s.orig_pos, 0.0)

        d = jax.lax.scan(block, js0, None, length=FLAGSHIP_SNAPS)[1] - target
        return jnp.sum(d * d) * 1e6
    return jax.jit(jax.value_and_grad(loss))


def _jax_stimulus(jsc):
    """jit(value_and_grad) of the JAX stimulus demo's rollout_vm w.r.t. the
    amplitude, as a function of (amp, start state). The rest-shape moments
    are hoisted and the step checkpointed, as the JAX package's simulate
    and flagship do: the same function, which XLA compiles in less than
    half the time of the demo's plain scan."""
    def rollout_vm(amp, js0):
        inv = jsm.sm_invariants(js0, jsc.cfg)
        s = js0.replace(stim=jnp.where(js0.stim > 0.0, amp, js0.stim))
        s, _ = jax.lax.scan(
            jax.checkpoint(lambda s, _: (jstep(
                s, jsc.cfg, jsc.cell_capacity, jsc.neighbor_capacity,
                sm_inv=inv)[0], ())),
            s, None, length=STIM_STEPS)
        return jnp.sum(jnp.where(s.active, s.vm, 0.0)) / jsc.num_particles
    return jax.jit(jax.value_and_grad(rollout_vm))


def _jax_fhn(jsc):
    """value_and_grad of the JAX fhn demo's fused rollout w.r.t. the
    amplitude, as a function of (amp, start state)."""
    sq = jsc.sub_block or 128

    def rollout_vm(amp, js0):
        ftab = jv.monodomain_prepare_fused(js0, jsc.cfg, jsc.q_block,
                                           jsc.block_window, sub_q=sq)
        s = js0.replace(stim=jnp.where(js0.stim > 0.0, amp, js0.stim))
        out = jv.simulate_monodomain_only_fused(
            s, ftab, jsc.cfg, num_steps=FHN_STEPS, q_block=jsc.q_block,
            w_chunk=jsc.block_window, sub_q=sq)
        return jnp.sum(jnp.where(out.active, out.vm, 0.0)) \
            / jsc.num_particles
    return jax.jit(jax.value_and_grad(rollout_vm))


def _port_scene(jsc, js):
    """The port's susane scene holding the JAX state `js`."""
    return T.build_scene("susane", device="cpu")._replace(
        state=to_torch_state(js))


def _port_flagship(sc, target, fused):
    inv = tsm.sm_invariants(sc.state, sc.cfg)
    loss = fit.make_loss(sc, inv, torch.from_numpy(target), FLAGSHIP_STEPS,
                         FLAGSHIP_SNAPS, fused)
    val, g = fit.value_and_grad(loss, fit.theta_of(*THETA, "cpu"))
    return float(val), g.numpy()


def _port_stimulus(sc):
    return fhn.value_and_grad(stim_demo.make_rollout(sc, STIM_STEPS),
                              torch.tensor(AMP))


def _port_fhn(sc):
    tab = tv.monodomain_prepare_fused(sc.state, sc.cfg, sub_q=sc.sub_block)
    return fhn.value_and_grad(fhn.make_rollout(sc, tab, FHN_STEPS),
                              torch.tensor(AMP))


@pytest.fixture(scope="module")
def jax_parity():
    """{case: (port (value, grad), JAX (value, grad), JAX's relative
    1-ulp spread of (value, grad))} on susane. The spread is measured for
    the flagship losses; the stimulus and fhn observables did not move
    under the bump (0.0 on the host that wrote this), so they are held at
    the base tolerances, which they meet a hundredfold."""
    jsc = J.build_scene("susane")
    js = jsc.state
    sc = _port_scene(jsc, js)
    with torch.no_grad():
        target = fit.rollout_disp(
            sc, tsm.sm_invariants(sc.state, sc.cfg),
            fit.theta_of(fit.TRUE_K, fit.TRUE_MU, "cpu"), FLAGSHIP_STEPS,
            FLAGSHIP_SNAPS).numpy()
    th = jnp.log(jnp.asarray(THETA, jnp.float32))
    amp = jnp.asarray(AMP, jnp.float32)
    runs = {
        "flagship_fused": (lambda s: _port_flagship(s, target, True),
                           _jax_flagship(jsc, True),
                           lambda f, j: f(th, j, target)),
        "flagship_unfused": (lambda s: _port_flagship(s, target, False),
                             _jax_flagship(jsc, False),
                             lambda f, j: f(th, j, target)),
        "stimulus": (_port_stimulus, _jax_stimulus(jsc),
                     lambda f, j: f(amp, j)),
        "fhn_fused": (_port_fhn, _jax_fhn(jsc), lambda f, j: f(amp, j)),
    }
    out = {}
    for case, (port, jfn, call) in runs.items():
        v, g = call(jfn, js)
        v, g = float(v), np.asarray(g)
        spread = (0.0, 0.0)
        if case.startswith("flagship"):
            vb, gb = call(jfn, bump_pos(js))
            spread = (abs(float(vb) - v) / abs(v),
                      float((np.abs(np.asarray(gb) - g) / np.abs(g)).max()))
        pv, pg = port(sc)
        out[case] = ((float(pv), np.asarray(pg)), (v, g), spread)
    return out


@pytest.mark.parametrize("case", ["flagship_fused", "flagship_unfused",
                                  "stimulus", "fhn_fused"])
def test_value_and_grad_matches_jax(jax_parity, case):
    """The port's value-and-grad (the adjoint scan) against
    jax.value_and_grad of the JAX package's rollout: the flagship loss
    with and without --fused, the stimulus demo's rollout_vm and the fhn
    demo's fused rollout."""
    (pv, pg), (jv_, jg), (sv, sg) = jax_parity[case]
    assert np.all(np.abs(jg) > 0) and np.all(np.isfinite(pg))
    np.testing.assert_allclose(pv, jv_, rtol=max(VALUE_RTOL,
                                                 SPREAD_FACTOR * sv))
    np.testing.assert_allclose(pg, jg, rtol=max(GRAD_RTOL,
                                                SPREAD_FACTOR * sg))
