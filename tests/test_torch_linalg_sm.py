"""PyTorch port vs the JAX package: small dense linear algebra and shape
matching (linear and quadratic, fixed particles, the det < 0 anti-flip).

Tolerance: rtol 1e-5, atol 1e-6 on the fp32 results, for the fixed-iteration
Jacobi chains and the fp32 moment sums, which both packages run in another
summation order; the corrected velocity carries the goal error times
alpha/dt (~97), so its absolute tolerance is the goal's times that factor.
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.ops import linalg as jla
from sph_sm_monodomain_tpu.ops import shape_matching as jsm
from sph_sm_monodomain_tpu_torch.ops import linalg as tla
from sph_sm_monodomain_tpu_torch.ops import shape_matching as tsm

from torch_parity import to_torch_state, torch_cfg

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


def test_sm_clusters_raise():
    jcfg, js = _sm_states(False)
    with pytest.raises(NotImplementedError):
        tsm.sm_invariants(to_torch_state(js),
                          torch_cfg(jcfg).replace(sm_clusters=2))
