"""PyTorch port vs the JAX package: shape matching over several clusters
(cfg.sm_clusters > 1, the multi-muscle scenes), on the JAX suite's two-tile
scene (tests/test_sm_clusters.py: 160 points of seed 7 in a (3.0, 1.5, 1.5)
world, the second tile at +1.5 in x).

Tolerances: the invariants, which the port sums in float64 once per run,
at rtol 1e-5 / atol 1e-6 (times the largest entry where that is above 1)
of a float64 numpy evaluation, and within that plus JAX's own distance
from it of JAX's fp32 sums (the repo's precedent: the polar factor of
tests/test_torch_linalg_sm.py is held to float64 beside JAX); the
fixed-iteration pseudo-inverse as tests/test_torch_linalg_sm.py holds the
single cluster's; each segment-reduction form's goals against JAX's same
form at the JAX suite's form-agreement bound, atol 2e-5
(tests/test_sm_clusters.py:88-104); 3 coupled v4 steps against JAX's at
the one-step fused tolerances widened by JAX's own 1-ulp spread
(tests/torch_parity.py); the independent-run oracle at the JAX suite's
2e-4 (tests/test_sm_clusters.py:66-70). The batched 3x3 polar
decomposition is held to a loop of single ones bit for bit.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.ops import linalg as jla
from sph_sm_monodomain_tpu.ops import shape_matching as jsm
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops import linalg as tla
from sph_sm_monodomain_tpu_torch.ops import shape_matching as tsm

from torch_parity import assert_states_close, to_torch_state, torch_cfg
from torch_parity import ulp_spreads  # noqa: F401 (a fixture)

N, STEPS, SHIFT = 160, 3, 1.5
RTOL, ATOL = 1e-5, 1e-6
FORM_ATOL, ORACLE_ATOL = 2e-5, 2e-4
FORMS = ("blocked", "contig", "onehot")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops: beside the suite's other parallel workers, torch's
    intra-op thread pool oversubscribes the cores (as in
    tests/test_torch_adjoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n=N, seed=7):
    rng = np.random.default_rng(seed)
    return rng.random((n, 3)).astype(np.float32) * 0.5 + 0.4


def _tiled_jax(pts, jcfg, k):
    """A JAX state of k copies of `pts` along x (+SHIFT each), every copy
    stimulated around its first point."""
    tiles = [pts + np.array([SHIFT * t, 0, 0], np.float32) for t in range(k)]
    js = J.init_fluid(np.concatenate(tiles), jcfg)
    for t in tiles:
        js = J.stim.set_stim(js, tuple(t[0]), 0.5, jcfg.stim_strength, jcfg)
    return js


def _tiled_torch(pts, tcfg, k):
    """The port's counterpart of `_tiled_jax`."""
    tiles = [pts + np.array([SHIFT * t, 0, 0], np.float32) for t in range(k)]
    ts = T.init_fluid(np.concatenate(tiles), tcfg, device="cpu")
    for t in tiles:
        ts = T.stim.set_stim(ts, tuple(t[0]), 0.5, tcfg.stim_strength, tcfg)
    return ts


def _cfg2(quadratic=False, **kw):
    return J.SimConfig(world_size=(3.0, 1.5, 1.5), sm_clusters=2,
                       quadratic_match=quadratic, **kw)


@pytest.fixture(scope="module")
def two_tile():
    """{quadratic: (jcfg, JAX state, port cfg, port state)} of the two-tile
    scene, predicted_vel = vel (the JAX form test's state)."""
    pts = _cloud()
    out = {}
    for quad in (False, True):
        jcfg = _cfg2(quad)
        js = _tiled_jax(pts, jcfg, 2)
        js = js.replace(predicted_vel=js.vel)
        out[quad] = (jcfg, js, torch_cfg(jcfg), to_torch_state(js))
    return out


def _form_cfg(jcfg, form):
    """(config, _BLOCKED_MAX_LANES) that put the two-tile scene in `form`."""
    if form == "blocked":
        return jcfg, 128
    if form == "contig":
        return jcfg.replace(sm_tile_rows=N), 0
    return jcfg, 0


def _close(t, j, atol=ATOL, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL,
                               atol=atol, err_msg=what)


def _invariants64(js, jcfg, cid):
    """The clustered rest-shape moments of a JAX state in float64 numpy:
    {field: array}, Aqq^-1 and the 9x9 moment A9qq (whose fixed-iteration
    pseudo-inverse both packages take) included."""
    act = np.asarray(js.active)
    m = np.asarray(js.mass).astype(np.float64) * act
    m_cm = m * np.where(np.asarray(js.fixed), jcfg.fixed_mass_scale, 1.0)
    orig = np.asarray(js.orig_pos).astype(np.float64)
    oh = (cid[:, None] == np.arange(jcfg.sm_clusters)[None, :]).astype(
        np.float64)
    mass_cm_sum = m_cm @ oh
    ocm = (oh.T @ (m_cm[:, None] * orig)) / mass_cm_sum[:, None]
    q = orig - ocm[cid]
    x, y, z = q.T
    q9 = np.stack([x, y, z, x * x, y * y, z * z, x * y, y * z, z * x], 1)
    return dict(
        mass_cm_sum=mass_cm_sum, ocm=ocm, q=q, mq=oh.T @ (m[:, None] * q),
        aqq_inv=np.linalg.inv(np.einsum("nk,nd,ne->kde", oh, q * m[:, None],
                                        q)),
        q9=q9, mq9=oh.T @ (m[:, None] * q9),
        a9qq=np.einsum("nk,nd,ne->kde", oh, q9 * m[:, None], q9))


@pytest.mark.parametrize("quadratic", [False, True],
                         ids=["linear", "quadratic"])
def test_clustered_invariants_match_jax(two_tile, quadratic):
    """The clustered invariants: cluster ids and the blocked hoists' masses
    as JAX's; every moment within fp32 rounding of a float64 evaluation
    (the port sums them in float64 once per run), and within JAX's own
    distance from it of JAX's fp32 sums; the fixed-iteration
    pseudo-inverse as JAX's on the same A9qq."""
    jcfg, js, tcfg, ts = two_tile[quadratic]
    jinv = jsm.sm_invariants(js, jcfg)
    tinv = tsm.sm_invariants(ts, tcfg)
    cid = tsm.cluster_ids(ts.orig_pos, tcfg).numpy()
    np.testing.assert_array_equal(cid, np.asarray(jsm.cluster_ids(
        js.orig_pos, jcfg)))
    ref = _invariants64(js, jcfg, cid)
    act = np.asarray(js.active)
    assert tuple(tinv.mass_cm_sum.shape) == (2,)
    assert tuple(tinv.ocm.shape) == (2, 3)
    assert tuple(tinv.q.shape) == tuple(ts.pos.shape)
    for name in tinv._fields:
        got, want = getattr(tinv, name), getattr(jinv, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert tuple(got.shape) == tuple(np.asarray(want).shape), name
    for name in ("mass_cm_sum", "ocm", "q", "mq", "aqq_inv", "q9", "mq9"):
        if getattr(tinv, name) is None:
            continue
        rows = act if name in ("q", "q9") else slice(None)
        got = getattr(tinv, name).numpy()[rows]
        want = np.asarray(getattr(jinv, name))[rows]
        exact = ref[name][rows]
        scale = max(1.0, float(np.abs(exact).max()))
        np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL * scale,
                                   err_msg=name)
        jax_err = float(np.abs(want - exact).max())
        assert float(np.abs(got - want).max()) <= jax_err + ATOL * scale, \
            (name, jax_err)
    if quadratic:
        for k in range(2):
            want = np.asarray(jla.pseudo_inverse(
                ref["a9qq"][k].astype(np.float32)))
            _close(tinv.a9qq_pinv[k], want,
                   atol=ATOL * float(np.abs(want).max()), what="a9qq_pinv")
    # the blocked hoists (f*K = 6 or 18 <= 128)
    np.testing.assert_array_equal(tinv.cid.numpy(), np.asarray(jinv.cid))
    np.testing.assert_array_equal(tinv.w_cm.numpy(), np.asarray(jinv.w_cm))
    qf = ref["q9"] if quadratic else ref["q"]
    qb = (np.eye(2)[cid][:, :, None] * qf[:, None, :]).reshape(len(cid), -1)
    np.testing.assert_allclose(tinv.qb.numpy()[act], qb[act], rtol=RTOL,
                               atol=ATOL)
    # the two identical rest shapes have the same moments, 1.5 apart in x
    _close(tinv.mass_cm_sum[1], ref["mass_cm_sum"][0], what="mass_cm_sum")
    np.testing.assert_allclose((tinv.ocm[1] - tinv.ocm[0]).numpy(),
                               [SHIFT, 0, 0], atol=1e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("quadratic", [False, True],
                         ids=["linear", "quadratic"])
def test_project_positions_forms_match_jax(two_tile, form, quadratic):
    """Each clustered form against JAX's same form (forced as the JAX
    suite forces it), and against the port's blocked form."""
    jcfg, js, _, ts = two_tile[quadratic]
    fcfg, lanes = _form_cfg(jcfg, form)
    tcfg = torch_cfg(fcfg)
    with mock.patch.object(jsm, "_BLOCKED_MAX_LANES", lanes), \
            mock.patch.object(tsm, "_BLOCKED_MAX_LANES", lanes):
        want = np.asarray(jsm.project_positions(js, fcfg))
        tinv = tsm.sm_invariants(ts, tcfg)
        assert tsm._segment_form(tinv, tcfg, ts.capacity) == form
        got = tsm.project_positions(ts, tcfg, sm_inv=tinv).numpy()
    blocked = tsm.project_positions(ts, torch_cfg(jcfg)).numpy()
    rows = slice(0, 2 * N)
    np.testing.assert_allclose(got[rows], want[rows], atol=FORM_ATOL)
    np.testing.assert_allclose(got[rows], blocked[rows], atol=FORM_ATOL)
    if form == "contig":
        # rows past the K tiles keep their goal
        np.testing.assert_array_equal(got[2 * N:], ts.goal_pos[2 * N:])


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "onehot"])
@pytest.mark.parametrize("quadratic", [False, True],
                         ids=["linear", "quadratic"])
def test_sm_rebind_rows_after_permutation(two_tile, blocked, quadratic):
    """Rebinding hoisted invariants to permuted rows: the per-row fields
    follow the rows (equal to the permuted originals, and to JAX's
    sm_rebind_rows), and the goals of the permuted state are the permuted
    goals."""
    jcfg, js, tcfg, ts = two_tile[quadratic]
    lanes = 128 if blocked else 0
    perm = np.random.default_rng(3).permutation(ts.capacity)
    jp = js.replace(**{f: np.asarray(getattr(js, f))[perm]
                       for f in ("pos", "vel", "predicted_vel", "orig_pos",
                                 "goal_pos", "mass", "fixed", "active")})
    tp = to_torch_state(jp)
    with mock.patch.object(jsm, "_BLOCKED_MAX_LANES", lanes), \
            mock.patch.object(tsm, "_BLOCKED_MAX_LANES", lanes):
        tinv = tsm.sm_invariants(ts, tcfg)
        jinv = jsm.sm_invariants(js, jcfg)
        trb = tsm.sm_rebind_rows(tinv, tp, tcfg)
        jrb = jsm.sm_rebind_rows(jinv, jp, jcfg)
        goal = tsm.project_positions(ts, tcfg, sm_inv=tinv).numpy()
        goal_p = tsm.project_positions(tp, tcfg, sm_inv=trb).numpy()
    assert (trb.qb is not None) == blocked
    for name in ("q", "q9", "cid", "w_cm", "qb"):
        got = getattr(trb, name)
        if got is None:
            assert getattr(tinv, name) is None and getattr(jrb, name) is None
            continue
        # the rebound rows are q = orig_pos - ocm in fp32, the hoisted ones
        # the float64 difference rounded once
        moved = getattr(tinv, name).numpy()[perm]
        np.testing.assert_allclose(got.numpy(), moved, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(moved).max()))
        _close(got, getattr(jrb, name),
               atol=ATOL + float(np.abs(getattr(jinv, name)
                                        - getattr(tinv, name).numpy()).max()),
               what=name)
    act = np.asarray(jp.active)
    np.testing.assert_allclose(goal_p[act], goal[perm][act], atol=FORM_ATOL)


def test_batched_polar_decomposition_is_bit_equal_to_single_ones():
    """det3, invert3 and polar_decomposition on a (K, 3, 3) batch give the
    bits of K single calls: the same op sequence per matrix."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(56, 3, 3)).astype(np.float32)
    a[1] = np.eye(3, dtype=np.float32)
    a[2, 0] *= -1.0
    a[3] = [[1, 2, 3], [2, 4, 6], [0, 1, 1]]
    at = torch.from_numpy(a)
    r, s = tla.polar_decomposition(at)
    singles = [tla.polar_decomposition(m) for m in at]
    assert torch.equal(r, torch.stack([x[0] for x in singles]))
    assert torch.equal(s, torch.stack([x[1] for x in singles]))
    assert torch.equal(tla.det3(at), torch.stack([tla.det3(m) for m in at]))
    assert torch.equal(tla.invert3(at),
                       torch.stack([tla.invert3(m) for m in at]))
    lam, u = tla.jacobi_eigh3_cyclic(at.transpose(-1, -2) @ at)
    assert tuple(lam.shape) == (56, 3) and tuple(u.shape) == (56, 3, 3)


def test_clustered_fused_step_matches_jax(ulp_spreads):
    """3 coupled v4 steps of the two-tile scene (blocked form), the port's
    step_fused against the JAX package's (Pallas in interpret mode)."""
    jcfg = _cfg2()
    js0 = _tiled_jax(_cloud(), jcfg, 2)

    def jrun(js):
        for _ in range(STEPS):
            js = J.step_fused(js, jcfg, 64, 128, 64, impl="v4")[0]
        return js

    jst = jrun(js0)
    spread = ulp_spreads("two_tile/v4", jrun, js0, ref=jst)
    ts, tcfg = to_torch_state(js0), torch_cfg(jcfg)
    sm_inv = tsm.sm_invariants(ts, tcfg)
    for _ in range(STEPS):
        ts, aux = T.step_fused(ts, tcfg, 64, impl="v4", sm_inv=sm_inv)
    assert int(aux.overflow) == 0
    assert_states_close(ts, jst, np.asarray(jst.active), spread=spread)


# each tile's start deformation (about its own center) in the oracle test:
# a stretch, and a turn about z
_STRETCH = np.diag([1.03, 0.97, 1.0]).astype(np.float32)
_TURN = np.array([[np.cos(0.08), -np.sin(0.08), 0.0],
                  [np.sin(0.08), np.cos(0.08), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("quadratic", [False, True],
                         ids=["linear", "quadratic"])
def test_clustered_matches_independent_runs(fused, quadratic):
    """The independent-run oracle on the port alone: two different clouds,
    each started off its rest shape by its own deformation, lie farther
    apart than the kernel support, so with one cluster a tile each evolves
    as a one-tile run of itself would. A single global cluster fits one
    transform to both tiles and fails this."""
    clouds = ((_cloud(), _STRETCH), (_cloud(seed=8), _TURN))
    cfg1 = T.SimConfig(quadratic_match=quadratic)
    cfg2 = torch_cfg(_cfg2(quadratic))

    def run(tiles, cfg):
        shift = [np.array([SHIFT * t, 0, 0], np.float32)
                 for t in range(len(tiles))]
        rest = np.concatenate([p + d for (p, _), d in zip(tiles, shift)])
        bent = np.concatenate([(p - 0.65) @ a.T + 0.65 + d
                               for (p, a), d in zip(tiles, shift)])
        st = T.init_fluid(rest, cfg, device="cpu")
        for (p, _), d in zip(tiles, shift):
            st = T.stim.set_stim(st, tuple(p[0] + d), 0.5, cfg.stim_strength,
                                 cfg)
        pos = st.pos.clone()
        pos[:len(bent)] = torch.from_numpy(bent.astype(np.float32))
        st = st.replace(pos=pos)
        for _ in range(STEPS):
            st = (T.step_fused(st, cfg, 64)[0] if fused
                  else T.step(st, cfg, 9 * 64)[0])
        out = st.pos.numpy()[:len(bent)].reshape(len(tiles), N, 3)
        return out - np.stack(shift)[:, None, :]

    ref = np.concatenate([run([c], cfg1) for c in clouds])
    np.testing.assert_allclose(run(clouds, cfg2), ref, atol=ORACLE_ATOL)
    one = run(clouds, cfg2.replace(sm_clusters=1))
    assert np.abs(one - ref).max() > 10 * ORACLE_ATOL


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("quadratic", [False, True],
                         ids=["linear", "quadratic"])
def test_op_count_does_not_grow_with_clusters(form, quadratic):
    """One clustered project_positions dispatches the same aten ops, in the
    same order, at K = 2 and K = 5 tiles in the same form."""
    seqs = []
    for k in (2, 5):
        cfg = T.SimConfig(world_size=(SHIFT * k, 1.5, 1.5), sm_clusters=k,
                          quadratic_match=quadratic,
                          sm_tile_rows=40 if form == "contig" else 0)
        st = _tiled_torch(_cloud(40, seed=k), cfg, k)
        st = st.replace(predicted_vel=st.vel)
        lanes = 128 if form == "blocked" else 0
        with mock.patch.object(tsm, "_BLOCKED_MAX_LANES", lanes):
            inv = tsm.sm_invariants(st, cfg)
            assert tsm._segment_form(inv, cfg, st.capacity) == form
            # builds the form's constants (ops/constants.const_tensor, a
            # process-wide cache), so that the counted call finds them
            # built whichever test of the process ran first
            tsm.project_positions(st, cfg, sm_inv=inv)
            with _OpCounter() as count:
                tsm.project_positions(st, cfg, sm_inv=inv)
        seqs.append(count.ops)
    assert len(seqs[0]) > 100
    assert seqs[0] == seqs[1]


def test_replicated_scene_runs_the_coupled_and_sm_only_modes():
    """On build_scene("susane", replicate=2) (two clusters; the scene
    itself is held to JAX's by tests/test_torch_unfused.py) the SM-only
    run matches the JAX package's, and the coupled run_protocol runs with
    finite fields."""
    from sph_sm_monodomain_tpu.models import variants as jv
    jsc = J.build_scene("susane", replicate=2)
    tsc = T.build_scene("susane", replicate=2, device="cpu")
    jout = jv.simulate_sm_only(jsc.state, jsc.cfg, num_steps=4)[0]
    tout = T.variants.simulate_sm_only(tsc.state, tsc.cfg, num_steps=4)[0]
    act = np.asarray(jsc.state.active)
    np.testing.assert_allclose(tout.pos.numpy()[act],
                               np.asarray(jout.pos)[act], atol=5e-5)
    np.testing.assert_allclose(tout.vel.numpy()[act],
                               np.asarray(jout.vel)[act], atol=5e-3)
    st, aux, _ = T.run_protocol(tsc, num_steps=2, chunk=2)
    assert int(aux.overflow) == 0
    assert bool(torch.isfinite(st.pos[st.active]).all())


@pytest.fixture
def tf32_on():
    """TF32 switched on before the test (as a caller might), the process's
    own flags restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])


_ENTRY_POINTS = {
    "step": lambda st, cfg, inv: T.step(st, cfg, 9 * 64, sm_inv=inv),
    "step_fused": lambda st, cfg, inv: T.step_fused(st, cfg, 64, sm_inv=inv),
    "step_fused_diff": lambda st, cfg, inv: T.step_fused_diff(st, cfg, 64,
                                                              sm_inv=inv),
    "simulate": lambda st, cfg, inv: T.simulate(st, cfg, 1, sub_q=64),
    "step_sm_only": lambda st, cfg, inv: T.variants.step_sm_only(st, cfg,
                                                                 inv),
    "simulate_sm_only": lambda st, cfg, inv: T.variants.simulate_sm_only(
        st, cfg, 1),
    "sm_invariants": lambda st, cfg, inv: tsm.sm_invariants(st, cfg),
    "project_positions": lambda st, cfg, inv: tsm.project_positions(
        st, cfg, sm_inv=inv),
    "sm_rebind_rows": lambda st, cfg, inv: tsm.sm_rebind_rows(inv, st, cfg),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_turn_tf32_off(two_tile, tf32_on, entry):
    """Every entry point that runs shape matching's matrix products (on
    the two-cluster scene) leaves the matmul flags at full fp32, whatever
    the caller set."""
    _, _, tcfg, ts = two_tile[False]
    inv = tsm.sm_invariants(ts, tcfg)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    _ENTRY_POINTS[entry](ts, tcfg, inv)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_far_tiles_keep_float64_goals():
    """Every tile deformed alike: the port's clustered goals lie within
    1e-5 of float64 on every tile of biceps_full x7, and on a biceps_full
    tile at x56's last tile position (x = 82.5, by build_scene's own
    layout: two tiles 82.5 apart). There fp32 sums about the world origin
    (the JAX package's formula, summed in row order: tools/sm_precision.py)
    lose more than 20x the port's error."""
    from sph_sm_monodomain_tpu_torch.tools import sm_precision
    sc = T.build_scene("biceps_full", replicate=7, device="cpu")
    assert max(sm_precision.goal_errors(sc)["port"]) <= 1e-5
    far = T.build_scene("biceps_full", T.SimConfig(world_size=(82.5, 1.5,
                                                               1.5)),
                        replicate=2, stim=False, device="cpu")
    err = sm_precision.goal_errors(far)
    assert max(err["port"]) <= 1e-5
    assert err["origin"][1] > 20 * max(err["port"])
