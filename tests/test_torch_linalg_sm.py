"""PyTorch port vs the JAX package: small dense linear algebra and shape
matching (linear and quadratic, fixed particles, the det < 0 anti-flip).

Tolerance: rtol 1e-5, atol 1e-6 on the fp32 results, for the fixed-iteration
Jacobi chains and the fp32 moment sums, which both packages run in another
summation order; the corrected velocity carries the goal error times
alpha/dt (~97), so its absolute tolerance is the goal's times that factor.
The gradient of corrected_velocity against JAX autodiff: rtol 1e-4 with an
absolute floor of 1e-5 * max|grad| (the same fixed-iteration Jacobi in
fp32, summed in another order), for one cluster and for two.

The polar factor R is held to scipy.linalg.polar in float64: the port's
error at most twice JAX's plus 1e-6, and port against JAX within the sum
of the two errors. On the "general" matrix (singular values 1.888, 0.900,
0.0755) a one-ulp difference in the fp32 A^T A moves the small eigenvalue
enough that both packages lie ~1e-5 from float64 (port 8.3e-6, JAX
1.02e-5), beyond rtol 1e-5 + atol 1e-6 between them; the well-conditioned
near-rotation and reflection cases also keep that direct tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.config import resolve_params as jresolve
from sph_sm_monodomain_tpu.ops import linalg as jla
from sph_sm_monodomain_tpu.ops import shape_matching as jsm
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops import linalg as tla
from sph_sm_monodomain_tpu_torch.ops import shape_matching as tsm

from torch_parity import random_state, to_torch_state, torch_cfg

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, atol=ATOL, what=""):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(j),
                               rtol=RTOL, atol=atol, err_msg=what)


def _mats(seed):
    rng = np.random.default_rng(seed)
    general = rng.normal(size=(3, 3)).astype(np.float32)
    near_rot = (np.eye(3) + 0.1 * rng.normal(size=(3, 3))).astype(np.float32)
    flipped = near_rot * np.array([[-1.0], [1.0], [1.0]], np.float32)
    singular = np.array([[1, 2, 3], [2, 4, 6], [0, 1, 1]], np.float32)
    return {"general": general, "near_rotation": near_rot,
            "reflection": flipped, "singular": singular}


@pytest.mark.parametrize("name", ["general", "near_rotation", "reflection",
                                  "singular"])
def test_linalg_3x3_matches(name):
    a = _mats(1)[name]
    at = torch.from_numpy(a)
    _close(tla.det3(at), jla.det3(a), what="det3")
    _close(tla.invert3(at), jla.invert3(a), what="invert3")
    if name == "singular":
        # A^T A has a zero eigenvalue: its fp32 rounding noise decides
        # between 0 and 1/sqrt(noise), so R is ill-posed there
        return
    rt, st = tla.polar_decomposition(at)
    rj, sj = jla.polar_decomposition(a)
    r64 = scipy.linalg.polar(a.astype(np.float64))[0]
    err_t = float(np.abs(rt.numpy() - r64).max())
    err_j = float(np.abs(np.asarray(rj) - r64).max())
    assert err_t <= 2.0 * err_j + 1e-6, (err_t, err_j)
    assert float(np.abs(rt.numpy() - np.asarray(rj)).max()) \
        <= err_t + err_j
    if name != "general":
        _close(rt, rj, what="polar R")
    _close(st, sj, atol=1e-5, what="polar S")


def test_pseudo_inverse_and_jacobi_match():
    rng = np.random.default_rng(2)
    b = rng.normal(size=(9, 12)).astype(np.float32) * 0.1
    spd = (b @ b.T).astype(np.float32)
    lt, rt = tla.jacobi_eigh(torch.from_numpy(spd))
    lj, rj = jla.jacobi_eigh(spd)
    _close(lt, lj, what="eigenvalues")
    _close(rt, rj, what="eigenvectors")
    pt = tla.pseudo_inverse(torch.from_numpy(spd))
    pj = jla.pseudo_inverse(spd)
    scale = float(np.abs(np.asarray(pj)).max())
    _close(pt, pj, atol=ATOL * scale, what="pseudo_inverse")


def _sm_states(flip: bool):
    """A blob with fixed particles at rest shape `orig`, deformed (and,
    with `flip`, mirrored so det(Apq) < 0)."""
    rng = np.random.default_rng(5)
    jcfg = J.SimConfig()
    n = 150
    orig = (rng.normal(size=(n, 3)) * 0.05 + 0.6).astype(np.float32)
    js = J.init_fluid(orig, jcfg)
    pos = np.asarray(js.pos).copy()
    a = np.eye(3, dtype=np.float32) + 0.05 * rng.normal(size=(3, 3))
    if flip:
        a[0] *= -1.0
    pos[:n] = ((orig - 0.6) @ a.T + 0.6 + 0.01).astype(np.float32)
    fixed = np.zeros(js.capacity, bool)
    fixed[:12] = True
    vel = (rng.normal(size=(js.capacity, 3)) * 0.1).astype(np.float32)
    js = js.replace(pos=pos, vel=vel, fixed=fixed,
                    goal_pos=np.asarray(js.pos) + 0.001)
    return jcfg, js


@pytest.mark.parametrize("quadratic", [False, True], ids=["linear",
                                                          "quadratic"])
@pytest.mark.parametrize("flip", [False, True], ids=["plain", "det_neg"])
def test_corrected_velocity_matches(quadratic, flip):
    jcfg, js = _sm_states(flip)
    jcfg = jcfg.replace(quadratic_match=quadratic)
    tcfg = torch_cfg(jcfg)
    ts = to_torch_state(js)
    jinv = jsm.sm_invariants(js, jcfg)
    tinv = tsm.sm_invariants(ts, tcfg)
    _close(tinv.ocm, jinv.ocm, what="ocm")
    jout = jsm.corrected_velocity(js, jcfg, sm_inv=jinv)
    tout = tsm.corrected_velocity(ts, tcfg, sm_inv=tinv)
    _close(tout.predicted_vel, jout.predicted_vel, what="predicted_vel")
    # live rows only: the padding sits ~5 world units from the center of
    # mass, where the (quadratic) basis magnifies fp32 noise in the
    # transform; no physics reads those rows' goals
    act = np.asarray(js.active)
    goal = np.asarray(jout.goal_pos)[act]
    _close(tout.goal_pos.numpy()[act], goal, what="goal_pos")
    cv_atol = (ATOL + RTOL * np.abs(goal).max()) * jcfg.sm_alpha \
        / jcfg.time_delta
    _close(tout.corrected_vel.numpy()[act],
           np.asarray(jout.corrected_vel)[act],
           atol=cv_atol, what="corrected_vel")
    # fixed particles keep their goal
    np.testing.assert_array_equal(tout.goal_pos[:12].numpy(),
                                  np.asarray(js.goal_pos)[:12])


def _two_cluster_states():
    """Two copies of the deformed blob, the second 1.5 along x in a (3.0,
    1.5, 1.5) world, as two shape-matching clusters (sm_clusters = 2)."""
    jcfg, js = _sm_states(False)
    n = 150
    jcfg2 = jcfg.replace(world_size=(3.0, 1.5, 1.5), sm_clusters=2)
    shift = np.array([1.5, 0.0, 0.0], np.float32)
    orig = np.asarray(js.orig_pos)[:n]
    js2 = J.init_fluid(np.concatenate([orig, orig + shift]), jcfg2)
    pos = np.asarray(js2.pos).copy()
    pos[:2 * n] = np.concatenate([np.asarray(js.pos)[:n],
                                  np.asarray(js.pos)[:n] + shift])
    fixed = np.zeros(js2.capacity, bool)
    fixed[:12] = True
    vel = (np.random.default_rng(9).normal(size=(js2.capacity, 3))
           * 0.1).astype(np.float32)
    return jcfg2, js2.replace(pos=pos, vel=vel, fixed=fixed,
                              goal_pos=np.asarray(js2.pos) + 0.001)


@pytest.mark.parametrize("quadratic", [False, True], ids=["linear",
                                                          "quadratic"])
def test_clustered_corrected_velocity_matches(quadratic):
    """corrected_velocity over two clusters (the blocked form) against the
    JAX package, at the single-cluster test's tolerances."""
    jcfg, js = _two_cluster_states()
    jcfg = jcfg.replace(quadratic_match=quadratic)
    tcfg, ts = torch_cfg(jcfg), to_torch_state(js)
    jinv = jsm.sm_invariants(js, jcfg)
    tinv = tsm.sm_invariants(ts, tcfg)
    _close(tinv.ocm, jinv.ocm, what="ocm")
    jout = jsm.corrected_velocity(js, jcfg, sm_inv=jinv)
    tout = tsm.corrected_velocity(ts, tcfg, sm_inv=tinv)
    act = np.asarray(js.active)
    goal = np.asarray(jout.goal_pos)[act]
    _close(tout.goal_pos.numpy()[act], goal, what="goal_pos")
    cv_atol = (ATOL + RTOL * np.abs(goal).max()) * jcfg.sm_alpha \
        / jcfg.time_delta
    _close(tout.corrected_vel.numpy()[act],
           np.asarray(jout.corrected_vel)[act], atol=cv_atol,
           what="corrected_vel")
    np.testing.assert_array_equal(tout.goal_pos[:12].numpy(),
                                  np.asarray(js.goal_pos)[:12])


@pytest.mark.parametrize("case", ["linear", "planar", "two_clusters"])
def test_corrected_velocity_grad_matches_jax(case):
    """Autograd through the port's shape matching (max-pivot / cyclic
    Jacobi, polar decomposition, in-place rotation updates) against JAX
    autodiff through its own, w.r.t. positions and (sm_alpha, sm_beta).
    The planar cloud gives A^T A a zero eigenvalue: the masked branches
    must keep the gradient finite (its value there is ill-posed, as
    test_linalg_3x3_matches notes for R). "two_clusters": two shape-matching
    clusters (the blocked form), so autograd runs through the batched
    polar decomposition."""
    if case == "two_clusters":
        jcfg, js = _two_cluster_states()
    else:
        jcfg = J.SimConfig()
        js = random_state(jcfg, n=150, seed=5)
    rng = np.random.default_rng(6)
    pos = np.asarray(js.pos).copy()
    if case == "planar":
        pos[:, 2] = 0.6
        js = js.replace(orig_pos=jnp.asarray(pos))
    pos = pos + rng.normal(size=pos.shape).astype(np.float32) * 0.01
    js = js.replace(pos=jnp.asarray(pos))
    ts = to_torch_state(js)
    tcfg = torch_cfg(jcfg)
    w = rng.normal(size=pos.shape).astype(np.float32)
    ab = np.asarray([0.3, 0.4], np.float32)
    tinv = tsm.sm_invariants(ts, tcfg)
    p_t = torch.from_numpy(pos).requires_grad_()
    ab_t = torch.from_numpy(ab).requires_grad_()
    cfg_t = T.resolve_params(tcfg, {"sm_alpha": ab_t[0], "sm_beta": ab_t[1]})
    st = tsm.corrected_velocity(ts.replace(pos=p_t), cfg_t, sm_inv=tinv)
    gt = torch.autograd.grad((st.corrected_vel * torch.from_numpy(w)).sum(),
                             (p_t, ab_t))
    assert all(bool(torch.isfinite(a).all()) for a in gt)
    if case == "planar":
        return
    jinv = jsm.sm_invariants(js, jcfg)

    def jloss(p, ab):
        cfg = jresolve(jcfg, {"sm_alpha": ab[0], "sm_beta": ab[1]})
        st = jsm.corrected_velocity(js.replace(pos=p), cfg, sm_inv=jinv)
        return jnp.sum(st.corrected_vel * w)

    # ~20 s: XLA compiling the unrolled Jacobi's backward
    gj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(pos),
                                                  jnp.asarray(ab))
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))
