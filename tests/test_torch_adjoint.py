"""The port's differentiable v4 step (ops/fused_adjoint.py) against
autograd through its own dense plain sweeps and against the JAX package's
`step_fused_diff` (Pallas in interpret mode), on the CPU.

Tolerances:
- primitive VJPs: max abs diff <= 1e-5 * max(1, max|reference|) per
  returned tensor, the JAX suite's primitive bound
  (tests/test_fused_adjoint.py);
- 1-step rollout loss against JAX: value rtol 1e-5, grad rtol 1e-4 w.r.t.
  log(K, mu), the JAX suite's own fused-vs-XLA bounds; grad w.r.t.
  log(voltage_constant, sm_alpha) rtol 1e-3 (these reach the loss only
  through Vm and the shape-matching correction, a longer fp32 chain);
- checkpointing: grads equal to 1e-6 relative;
- the fit loss along log K (`fit.loss_scan`, 7 points over a 20-step
  rollout): the port's curve within twice JAX's own 1-ulp spread, the
  largest change of JAX's curve when the start positions move by one ulp
  toward +inf or toward -inf (tests/torch_parity.py), at every point.
Run as a script, the module prints the long-rollout witness: both
packages' fit loss, gradient and central differences over many steps.
Shape matching's own gradient against JAX autodiff is in
tests/test_torch_linalg_sm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.ops import fused_adjoint as JFA
from sph_sm_monodomain_tpu.ops import shape_matching as jsm
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.examples import fit_material_flagship as fit
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as FA
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops import shape_matching as tsm
from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3

from torch_parity import (SPREAD_FACTOR, bump_pos, jax_state_arrays,
                          random_state, to_torch_state, torch_cfg)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small ops; beside the suite's other parallel
    workers, torch's intra-op thread pool oversubscribes the cores and
    slows them twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomized_susane(seed=0):
    """susane (506 particles) with a randomized EP state, velocities and
    positions, as a JAX state and the equal port state. A uniform Vm would
    make every Laplacian cotangent term vacuously 0. Positions are moved
    off the rest shape by ~0.003 (h = 0.04): at the rest shape goal - pos
    is fp32 rounding noise, so the 1-step loss's dependence on mu and
    sm_alpha (~1e-12 of its dependence on K) is that noise, which two
    implementations summing the shape-matching moments in another order
    do not share."""
    sc = J.build_scene("susane")
    js = sc.state
    n = js.capacity
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    js = js.replace(
        vm=js.vm + f32(rng.standard_normal(n) * 3.0),
        iion=f32(rng.standard_normal(n) * 0.1),
        w=f32(rng.standard_normal(n) * 0.1),
        vel=js.vel + f32(rng.standard_normal((n, 3)) * 0.05))
    js = js.replace(pos=js.pos + f32(rng.standard_normal((n, 3)) * 0.003)
                    * js.active[:, None])
    return sc, js, to_torch_state(js)


def _sweep_inputs(ts, cfg):
    order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(ts.pos, ts.active, cfg,
                                                     128)
    st = tsm.corrected_velocity(ts, cfg, sm_inv=tsm.sm_invariants(ts, cfg))
    fs, _ = fst.build_qm_feats(st, cx, cyz, order)
    return fs, lo, hi


def _vjp(fn, inputs, g):
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    return torch.autograd.grad(fn(*xs), xs, g)


@pytest.mark.parametrize("sweep", ["a", "b"])
def test_sweep_vjp_matches_dense_autograd(sweep):
    """SweepA3Fn / SweepB3Fn backward (epilogue VJP + plain backward sweep)
    against torch.autograd through the dense plain forward sweeps, with
    random output cotangents: an independent derivation of the pair-sum
    VJPs, including the masked subgradients and the out-of-support
    viscosity gate."""
    sc, _, ts = _randomized_susane()
    cfg = torch_cfg(sc.cfg)
    fs, lo, hi = _sweep_inputs(ts, cfg)
    dynp = fst.build_dynp(T.resolve_params(cfg, {"mu_viscosity": 80.0}))
    rng = np.random.default_rng(1)
    sweep_a, sweep_b = FA.make_diff_sweeps(cfg)
    if sweep == "a":
        x = fs
        hand = lambda f, d: sweep_a(f, d, lo, hi)  # noqa: E731
        dense = lambda f, d: fst.sweep_a3_plain(  # noqa: E731
            f, fst.feats_a_from_fs(f), cfg, dynp=d)
    else:
        x = fst.sweep_a3(fs, fst.feats_a_from_fs(fs), lo, hi, cfg,
                         dynp=dynp)
        hand = lambda o, d: sweep_b(o, d, lo, hi)  # noqa: E731
        dense = lambda o, d: fst.sweep_b3_plain(  # noqa: E731
            o, fst.feats_b(o), cfg, dynp=d)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    got = _vjp(hand, (x, dynp), g)
    want = _vjp(dense, (x, dynp), g)
    for name, a, b in zip(("d_input", "d_dynp"), got, want):
        assert torch.isfinite(a).all(), name
        bound = 1e-5 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= bound, name
    # the pair-side mu cotangent and the Laplacian terms are exercised
    assert float(got[1].abs().max()) > 0.0
    if sweep == "b":
        assert float(got[1][0, FA._MU].abs()) > 0.0


def _rollout_loss(step_one, st0, steps, names, xp):
    def loss(log_theta):
        params = {k: xp.exp(log_theta[i]) for i, k in enumerate(names)}
        s = st0
        for _ in range(steps):
            s = step_one(s, params)
        d = xp.where(s.active[:, None], s.pos - s.orig_pos, 0.0 * s.pos)
        return (d * d).sum() * 1e6
    return loss


def _port_value_and_grad(loss, theta):
    th = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    val = loss(th)
    (g,) = torch.autograd.grad(val, th)
    return float(val.detach()), g.numpy()


@pytest.mark.parametrize("case", [
    ("material", ("k_stiffness", "mu_viscosity"), (0.5, 100.0), 1e-4),
    ("coupling", ("voltage_constant", "sm_alpha"), (1.5, 0.25), 1e-3),
], ids=lambda c: c[0])
def test_step_fused_diff_matches_jax(case):
    """Value and grad of the 1-step rollout loss (the JAX suite's
    `_rollout_loss`), port vs JAX `step_fused_diff`, from the randomized
    state (where d/d voltage_constant is not 0)."""
    _, names, theta, grad_rtol = case
    sc, js, ts = _randomized_susane()
    jcfg, sub_q = sc.cfg, sc.sub_block
    tcfg = torch_cfg(jcfg)
    jinv = jax.jit(lambda s: jsm.sm_invariants(s, jcfg))(js)
    tinv = tsm.sm_invariants(ts, tcfg)
    jloss = _rollout_loss(
        lambda s, p: JFA.step_fused_diff(s, jcfg, sc.q_block,
                                         sc.block_window, sub_q,
                                         sm_inv=jinv, params=p),
        js, 1, names, jnp)
    tloss = _rollout_loss(
        lambda s, p: T.step_fused_diff(s, tcfg, sub_q, sm_inv=tinv,
                                       params=p), ts, 1, names, torch)
    log_theta = np.log(np.asarray(theta, np.float32))
    vj, gj = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(log_theta))
    vt, gt = _port_value_and_grad(tloss, log_theta)
    np.testing.assert_allclose(vt, float(vj), rtol=1e-5)
    assert np.all(np.abs(np.asarray(gj)) > 0.0)
    np.testing.assert_allclose(gt, np.asarray(gj), rtol=grad_rtol)


def test_checkpointed_rollout_same_grad():
    """A 2-step rollout under torch.utils.checkpoint (the fit's memory
    policy) gives the grad of the plain rollout."""
    sc = J.build_scene("susane")
    tcfg = torch_cfg(sc.cfg)
    ts = to_torch_state(sc.state)
    tinv = tsm.sm_invariants(ts, tcfg)
    names = ("k_stiffness", "mu_viscosity")

    def step(s, p):
        return T.step_fused_diff(s, tcfg, 128, sm_inv=tinv, params=p)

    def step_ckpt(s, p):
        return checkpoint(step, s, p, use_reentrant=False)

    theta = np.log(np.asarray([0.5, 100.0], np.float32))
    v0, g0 = _port_value_and_grad(
        _rollout_loss(step, ts, 2, names, torch), theta)
    v1, g1 = _port_value_and_grad(
        _rollout_loss(step_ckpt, ts, 2, names, torch), theta)
    assert np.all(np.isfinite(g0)) and np.all(g0 != 0.0)
    np.testing.assert_allclose(v1, v0, rtol=1e-6)
    np.testing.assert_allclose(g1, g0, rtol=1e-6)


def test_dynp_keeps_the_autograd_graph():
    """build_dynp / kernel_params keep the graph of 0-dim tensor params,
    derived slots (fh_denom, fh_asd, vm_scale) included."""
    cfg = T.SimConfig()
    vals = {"k_stiffness": 0.7, "fh_vt": -70.0, "fh_vp": 20.0,
            "sigma_i": 0.9, "cm_capacitance": 1.3}
    params = {k: torch.tensor(v, requires_grad=True) for k, v in vals.items()}
    prm = fst.kernel_params(cfg, fst.build_dynp(T.resolve_params(cfg,
                                                                 params)))
    slot = fst._DYN_SLOTS.index

    def grad(s, k):
        (g,) = torch.autograd.grad(prm[slot(s)], params[k], retain_graph=True,
                                   allow_unused=True)
        return 0.0 if g is None else float(g)

    vr, vt, vp = cfg.fh_vr, vals["fh_vt"], vals["fh_vp"]
    si, se, cm = vals["sigma_i"], cfg.sigma_e, vals["cm_capacitance"]
    sigma = si * se / (si + se)
    expect = [
        ("k_stiffness", "k_stiffness", 1.0),
        ("fh_denom", "fh_vp", 1.0),
        ("fh_asd", "fh_vt", 1.0 / (vp - vr)),
        ("fh_asd", "fh_vp", -(vt - vr) / (vp - vr) ** 2),
        ("vm_scale", "sigma_i", se * se / (si + se) ** 2
         / (cfg.beta_sv_ratio * cm)),
        ("vm_scale", "cm_capacitance", -sigma / (cfg.beta_sv_ratio * cm * cm)),
        ("cm_capacitance", "cm_capacitance", 1.0),
        ("mu_viscosity", "k_stiffness", 0.0),
    ]
    for s, k, want in expect:
        np.testing.assert_allclose(grad(s, k), want, rtol=1e-5, atol=1e-12,
                                   err_msg=f"d {s} / d {k}")
    # the static constants carry no graph
    assert prm.requires_grad and prm.shape == (32,)


_ENTRY_POINTS = {
    "build_scene": lambda tmp, **kw: T.build_scene("cube", **kw),
    "init_fluid": lambda tmp, **kw: T.init_fluid(
        np.full((4, 3), 0.5, np.float32), T.SimConfig(), **kw),
    "state_from_numpy": lambda tmp, **kw: T.state_from_numpy(
        jax_state_arrays(random_state(J.SimConfig(), n=20)), **kw),
    "load_checkpoint": lambda tmp, **kw: T.load_checkpoint(
        _checkpoint(tmp), **kw)[0],
}


def _checkpoint(tmp):
    path = str(tmp / "ckpt")
    J.save_checkpoint(path, random_state(J.SimConfig(), n=20), step=3)
    return path


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Without a GPU the default device raises (no quiet CPU fallback);
    device="cpu" builds on the CPU."""
    make = _ENTRY_POINTS[entry]
    if torch.cuda.is_available():
        out = make(tmp_path)
        assert (out.state if entry == "build_scene" else out) \
            .device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make(tmp_path)
    out = make(tmp_path, device="cpu")
    assert (out.state if entry == "build_scene" else out).device.type == "cpu"


def test_fit_driver_cpu_smoke(tmp_path, capsys):
    """`susane 4 3 --device cpu --fused`: finite losses and grads, the loss
    falls, and the CSV row follows the JAX example's schema."""
    csv = tmp_path / "fit.csv"
    res = fit.main(["susane", "4", "3", "--device", "cpu", "--fused",
                    f"--csv={csv}"])
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    assert all(bool(torch.isfinite(g).all()) for g in res["grads"])
    assert res["losses"][-1] < res["losses"][0]
    lines = csv.read_text().splitlines()
    assert lines[-2] == fit.FIT_ROW_HEADER
    assert lines[-1].split(";")[0] == "susane"
    assert "value_and_grad" in capsys.readouterr().out


def test_roughness_reads_noise_not_curvature(capsys):
    """fit.roughness: a quadratic in log K reads ~0 whatever its curvature,
    the same with 1e-4 relative noise reads ~1e-4; `--roughness` on a
    2-step susane rollout reports finite values at both points."""
    th = np.log(np.asarray([0.3, 150.0], np.float32))
    quad = lambda t: 5.0 + 40.0 * float(t[0] - th[0]) ** 2   # noqa: E731
    assert fit.roughness(quad, th, 0) < 1e-9
    noise = np.random.default_rng(3).normal(size=64)
    calls = iter(noise)
    noisy = lambda t: quad(t) * (1.0 + 1e-4 * next(calls))   # noqa: E731
    assert 2e-5 < fit.roughness(noisy, th, 0) < 3e-4
    out = fit.main(["susane", "2", "--device", "cpu", "--roughness"])
    assert set(out) == set(fit.ROUGHNESS_POINTS)
    for v in out.values():
        assert all(np.isfinite(x) for x in v.values()), v
    assert "roughness in log K" in capsys.readouterr().out


def _central_diff(value, theta, h):
    """(value(theta + h e_i) - value(theta - h e_i)) / 2h for each i, with
    `value` a float function of a float32 numpy theta."""
    out = []
    for i in range(theta.shape[0]):
        e = np.zeros_like(theta)
        e[i] = h
        out.append((value(theta + e) - value(theta - e)) / (2 * h))
    return np.asarray(out)


def port_fit_loss(steps, scene="susane"):
    """The flagship fit's loss (displacement snapshots against the hidden
    material (0.9, 40), stim on, one checkpoint per step) through the
    port's fit driver: (value, value_and_grad), each taking a float32
    numpy log(K, mu)."""
    snaps = max(1, min(5, steps))
    tsc = T.build_scene(scene, device="cpu")
    tinv = tsm.sm_invariants(tsc.state, tsc.cfg)
    true = fit.theta_of(fit.TRUE_K, fit.TRUE_MU, "cpu")
    with torch.no_grad():
        target = fit.rollout_disp(tsc, tinv, true, steps, snaps)
    tloss = fit.make_loss(tsc, tinv, target, steps, snaps)

    def t_value(th):
        with torch.no_grad():
            return float(tloss(torch.from_numpy(th)))

    def t_vg(th):
        val, g = fit.value_and_grad(tloss, torch.from_numpy(th))
        return float(val), g.numpy()

    return t_value, t_vg


def jax_fit_loss(steps, scene="susane", start=None):
    """port_fit_loss's counterpart in the JAX package: the rollout of its
    example's `--fused` path (step_fused_diff under jax.checkpoint), from
    the scene's state or `start(state)`, target included."""
    snaps = max(1, min(5, steps))
    jsc = J.build_scene(scene)
    jcfg, js0 = jsc.cfg, jsc.state
    if start is not None:
        js0 = start(js0)
    jinv = jax.jit(lambda s: jsm.sm_invariants(s, jcfg))(js0)

    def rollout(log_theta):
        params = {"k_stiffness": jnp.exp(log_theta[0]),
                  "mu_viscosity": jnp.exp(log_theta[1])}

        @jax.checkpoint
        def body(s, _):
            return JFA.step_fused_diff(s, jcfg, jsc.q_block, jsc.block_window,
                                       jsc.sub_block, sm_inv=jinv,
                                       params=params), ()

        def block(s, _):
            s, _ = jax.lax.scan(body, s, None, length=steps // snaps)
            return s, jnp.where(s.active[:, None], s.pos - s.orig_pos, 0.0)

        return jax.lax.scan(block, js0, None, length=snaps)[1]

    jtarget = jax.jit(rollout)(jnp.log(jnp.asarray([fit.TRUE_K,
                                                    fit.TRUE_MU])))

    def jloss(log_theta):
        d = rollout(log_theta) - jtarget
        return jnp.sum(d * d) * 1e6

    j_val, j_vg = jax.jit(jloss), jax.jit(jax.value_and_grad(jloss))

    def j_vg_np(th):
        v, g = j_vg(jnp.asarray(th))
        return float(v), np.asarray(g)

    return lambda th: float(j_val(jnp.asarray(th))), j_vg_np


def test_fit_gradient_matches_finite_differences():
    """The fit loss's autograd gradient over a 3-step susane rollout
    against central differences of its forward (h = 1e-2 in log space):
    rtol 1e-3, the curvature and fp32 error of the difference quotient."""
    t_value, t_vg = port_fit_loss(3)
    theta = np.log(np.asarray([0.5, 100.0], np.float32))
    _, g = t_vg(theta)
    np.testing.assert_allclose(g, _central_diff(t_value, theta, 1e-2),
                               rtol=1e-3)


def test_fit_loss_scan_matches_jax():
    """The fit loss along log K at the true mu (fit.loss_scan: 7 points,
    log K within +-0.5 of the truth) over a 20-step susane rollout: the
    port's curve against the JAX example's loss on the same float32
    thetas, within SPREAD_FACTOR x the largest change of JAX's curve when
    the start positions (and so the target) move by one ulp, toward +inf
    or toward -inf. Each bump is a rigid shift, which shape matching
    absorbs; the two directions round differently elsewhere, and their
    spreads differ fourfold (0.023 and 0.092 on an AVX-512 host), while
    the two packages' goals each lie ~1e-6 from float64 and part from
    step 1 on. Both curves are 0 at the truth and positive elsewhere; the
    count of particles on the pressure clamp grows with K (0 at K =
    0.546, 270 of 507 at 1.484)."""
    steps = 20
    rows = fit.loss_scan(T.build_scene("susane", device="cpu"), steps,
                         log=lambda s: None)
    ths = [r["log_theta"] for r in rows]
    t = np.asarray([r["loss"] for r in rows])
    j_value = jax_fit_loss(steps)[0]
    j = np.asarray([j_value(th) for th in ths])
    spread = 0.0
    for toward in (np.inf, -np.inf):
        jb_value = jax_fit_loss(
            steps, start=lambda js: bump_pos(js, toward))[0]
        jb = np.asarray([jb_value(th) for th in ths])
        spread = max(spread, np.abs(jb - j).max())
    assert np.all(np.isfinite(t)) and spread > 0.0
    np.testing.assert_array_less(np.abs(t - j), SPREAD_FACTOR * spread)
    assert t[3] == j[3] == 0.0 and np.all(t[[0, 1, 2, 4, 5, 6]] > 0.0)
    clamped = [r["clamped_max"] for r in rows]
    assert clamped[0] == 0 and clamped[-1] > 0
    assert clamped == sorted(clamped)


def witness(steps, points, hs=(1e-2, 1e-3), scene="susane"):
    """The fit loss's value, autograd gradient, central differences and
    roughness in log K and log mu (fit.roughness) at each (K, mu) of
    `points`, in the port and in the JAX package; then the port's
    roughness over JAX's at each point."""
    rows = []
    for name, make in (("port", port_fit_loss), ("jax", jax_fit_loss)):
        value, vg = make(steps, scene)
        for k, mu in points:
            th = np.log(np.asarray([k, mu], np.float32))
            val, g = vg(th)
            fd = {h: _central_diff(value, th, h) for h in hs}
            rough = [fit.roughness(value, th, axis) for axis in (0, 1)]
            rows.append((name, k, mu, val, g, fd, rough))
            print(f"{scene} {steps} steps, {name} at K={k:g} mu={mu:g}: "
                  f"loss {val:.7g}; autograd d/dlog(K, mu) {g.tolist()}; "
                  + "; ".join(f"FD h={h:g} {v.tolist()}"
                              for h, v in fd.items())
                  + f"; roughness in log K {rough[0]:.4g}, log mu "
                  f"{rough[1]:.4g}", flush=True)
    for (_, k, mu, *_, rp), (*_, rj) in zip(
            [r for r in rows if r[0] == "port"],
            [r for r in rows if r[0] == "jax"]):
        print(f"K={k:g} mu={mu:g}: roughness port / JAX, log K "
              f"{rp[0] / rj[0]:.4g}, log mu {rp[1] / rj[1]:.4g}", flush=True)
    return rows


if __name__ == "__main__":
    # The long-rollout witness: the port's and JAX's fit loss, gradient
    # and finite differences over `steps` steps, on the CPU:
    #   PYTHONPATH=.:tests python tests/test_torch_adjoint.py [steps] [K,mu ...]
    import sys
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    args = sys.argv[1:]
    witness(int(args[0]) if args else 100,
            [tuple(float(v) for v in a.split(",")) for a in args[1:]]
            or [(0.3, 150.0), (0.494, 40.8)])
