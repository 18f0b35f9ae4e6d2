"""The port's multi-device runs (sph_sm_monodomain_tpu_torch.parallel) on
gloo over CPU tensors, against the JAX package and the port's own
single-device step.

The ranks are spawned once per world size (2 and 4) for this module; they
run every case of tests/torch_parallel_ranks.py (which imports torch and
the port only) and rank 0 writes the gathered results. The tests below
compare them:
  - the collectives (comm): tiled all_gather, all_sum, the one-slab shift
    with zeros at the edge ranks, an int32 column carried by bitcast;
  - the unfused all-gather step against JAX's make_sharded_step on the
    8-device CPU mesh and against the port's single-device step, at
    tests/test_sharded.py's tolerances;
  - the fused slab step against the port's single-device v4 step and JAX's
    single-device step_fused (interpret mode), at
    tests/test_sharded_fused.py's tolerances;
  - the halo step (uniform cloud, empty ranks, a stretched world, two
    muscles, a world whose window ids pass 2^24, migration, dynamic
    params) against the single-device v4 step, particles matched by
    orig_pos (tests/test_halo.py:27-33), at tests/test_halo.py's
    tolerances, every particle conserved and overflow 0.
  - the run loop: each simulate through models/scan.run_steps against the
    step loop it replaced, bit for bit (stim-off inside the run, physics
    overrides, the overflow, a run in two chunks); the capture keys of
    the three paths and of the ranks distinct;
  - the all-gather path's value-and-grad (the checkpointed adjoint scan
    over the differentiable collectives) against jax.value_and_grad
    through the JAX package's make_sharded_simulate(...,
    dynamic_params=True) and against the port's one-device adjoint; the
    step under eager autograd; each collective's VJP against its formula
    in float64; the fused slab and halo paths refusing autograd.
Cheap parity with the JAX functions needs no ranks: slab_bounds, the halo
layout and its capacities, _window_bounds3, the unshard round trip, and
sweep_a3 / sweep_b3 on a slab of query rows in interpret mode. No JAX
interpret-mode mesh run of the fused or halo steps runs here (JAX marks
those slow).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.models.monodomain import step_fused as j_fused
from sph_sm_monodomain_tpu.ops import fused_step as jfs
from sph_sm_monodomain_tpu.parallel import halo_step as JH
from sph_sm_monodomain_tpu.parallel import sharded_step as JS

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.models import scan
from sph_sm_monodomain_tpu_torch.ops import fused_step as tfs
from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3
from sph_sm_monodomain_tpu_torch.parallel import comm as C
from sph_sm_monodomain_tpu_torch.parallel import halo_step as H
from sph_sm_monodomain_tpu_torch.parallel import sharded_step as S

import torch_parallel_ranks as R
from torch_parity import SPREAD_FACTOR, bump_pos

WORLDS = (2, 4)
RANK_TIMEOUT_S = 600
# tests/test_sharded.py: shape-matching sums in rank order, amplified by
# alpha/dt in corrected_vel; (atol, rtol)
GATHER_TOLS = {"pos": (5e-5, 0), "vel": (5e-4, 0), "vm": (1e-3, 0),
               "dens": (0, 1e-5), "pres": (0.5, 1e-4), "iion": (1e-5, 0),
               "w": (1e-6, 0), "goal_pos": (5e-5, 0)}
# tests/test_sharded_fused.py
FUSED_TOLS = {"pos": (5e-5, 0), "vel": (5e-4, 0), "vm": (1e-3, 0),
              "dens": (0, 1e-5), "inter_vm": (5e-3, 0)}
# tests/test_halo.py (absolute)
HALO_TOLS = {"pos": 2e-5, "vel": 5e-3, "vm": 1e-3, "dens": 1.0,
             "iion": 1e-6, "w": 1e-7}
HALO_CASES = ("uniform", "empty", "stretched", "clustered", "big_world")


def _jax_state(ts):
    """The JAX package's state with the port state's fields."""
    return J.ParticleState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                              for f in dataclasses.fields(ts)})


def _jcfg(tcfg):
    return J.SimConfig(**dataclasses.asdict(tcfg))


def _assert_close(got, want, tols, what, n=None):
    for name, (atol, rtol) in tols.items():
        a = np.asarray(want[name])[:n]
        b = np.asarray(got[name])[:n]
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {name}")


def _by_identity(fields):
    """The active rows of a state's fields, ordered by orig_pos."""
    act = np.asarray(fields["active"]).astype(bool)
    op = np.asarray(fields["orig_pos"])[act]
    key = np.lexsort((op[:, 2], op[:, 1], op[:, 0]))
    return {k: np.asarray(v)[act][key] for k, v in fields.items()
            if np.ndim(v) and np.shape(v)[0] == act.shape[0]}, int(act.sum())


def _res(res, prefix):
    p = prefix + "/"
    return {k[len(p):]: v for k, v in res.items() if k.startswith(p)}


def _state_fields(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "is_stim_on"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The references computed here run beside the spawned ranks and the
    suite's other workers (as in tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def rank_runs(tmp_path_factory):
    """One background spawn of D ranks a world size, started when the
    module starts, so the ranks run while the references are computed:
    {D: (process, out_dir)}."""
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests.parent), str(tests), os.environ.get("PYTHONPATH", "")]))
    runs = {}
    for d in WORLDS:
        out = tmp_path_factory.mktemp(f"ranks{d}")
        runs[d] = (subprocess.Popen(
            [sys.executable, str(tests / "torch_parallel_ranks.py"), str(d),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda d: f"D{d}")
def world(request, rank_runs):
    """(D, results, out_dir) of the spawn of D ranks running every case."""
    d = request.param
    proc, out = rank_runs[d]
    log = proc.communicate(timeout=RANK_TIMEOUT_S)[0]
    assert proc.returncode == 0, f"the {d} ranks failed:\n{log[-4000:]}"
    return d, dict(np.load(out / f"world{d}.npz")), out


@pytest.fixture(scope="module")
def single():
    """The port's single-device results of the rank cases."""
    out = {}
    st = R.blob_state()
    for _ in range(R.GATHER_STEPS):
        st, _ = T.step(st, R.CFG, R.NBR)
    out["gather"] = _state_fields(st)
    cfg, st = R.clustered_gather_state()
    for _ in range(R.GATHER_STEPS):
        st, _ = T.step(st, cfg, R.NBR)
    out["gather_clustered"] = _state_fields(st)
    st, _ = T.simulate(R.blob_state(200, seed=9), R.CFG, num_steps=4,
                       stim_off_step=2, fused=False,
                       neighbor_capacity=R.NBR, params=R.OVERRIDES)
    out["gather_sim"] = _state_fields(st)
    st = R.blob_state(400, 5, pad_to=512, seed=1)
    for _ in range(R.FUSED_STEPS):
        st, _ = T.step_fused(st, R.CFG, R.FUSED_SUB_Q)
    out["fused"] = _state_fields(st)
    st, _ = T.simulate(R.blob_state(300, 0, pad_to=512, seed=10), R.CFG,
                       num_steps=3, stim_off_step=1, sub_q=R.FUSED_SUB_Q,
                       params=R.OVERRIDES)
    out["fused_sim"] = _state_fields(st)
    for name, (cfg, st, steps) in R.halo_cases().items():
        for _ in range(steps):
            st, _ = T.step_fused(st, cfg, R.HALO_SUB_Q)
        out[f"halo_{name}"] = _state_fields(st)
    return out


@pytest.fixture(scope="module")
def jax_gather():
    """JAX's make_sharded_step on the 8-device CPU mesh, the same input."""
    mesh = JS.make_mesh(jax.devices()[:8])
    js = JS.shard_state(_jax_state(R.blob_state()), mesh)
    step = JS.make_sharded_step(mesh, J.SimConfig(), 32, R.NBR)
    for _ in range(R.GATHER_STEPS):
        js, ovf = step(js)
        assert int(ovf) == 0
    return _state_fields(js)


@pytest.fixture(scope="module")
def jax_fused():
    """JAX's single-device step_fused (interpret mode), the same input."""
    js = _jax_state(R.blob_state(400, 5, pad_to=512, seed=1))
    for _ in range(R.FUSED_STEPS):
        js, _ = j_fused(js, J.SimConfig(), R.FUSED_SUB_Q, 256, R.FUSED_SUB_Q)
    return _state_fields(js)


@pytest.fixture(scope="module")
def jax_halo_uniform():
    """JAX's single-device v4 step_fused (interpret) on the uniform cloud."""
    cfg, st, steps = R.halo_cases()["uniform"]
    js = _jax_state(st)
    for _ in range(steps):
        js, _ = j_fused(js, _jcfg(cfg), 128, 128, R.HALO_SUB_Q, impl="v4")
    return _state_fields(js)


def _jax_grad_run(js0, mesh):
    """jax.jit(jax.value_and_grad) of the loss sum(pos * w) after the JAX
    package's make_sharded_simulate(..., dynamic_params=True) on `mesh`,
    w.r.t. the overrides R.GRAD_PARAMS and the fields R.GRAD_FIELDS: a
    function of a JAX state returning (value, [gradients])."""
    sim = JS.make_sharded_simulate(mesh, J.SimConfig(), 32, R.NBR,
                                   R.GRAD_STEPS, R.GRAD_STIM_OFF,
                                   dynamic_params=True)
    w = jnp.asarray(R.grad_weights(js0.capacity).numpy())

    def loss(params, fields, js):
        out, ovf = sim(js.replace(**fields), params)
        return jnp.sum(out.pos * w), ovf
    vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))

    def run(js):
        js = JS.shard_state(js, mesh)
        params = {k: jnp.float32(R.OVERRIDES[k]) for k in R.GRAD_PARAMS}
        fields = {f: getattr(js, f) for f in R.GRAD_FIELDS}
        with jax.set_mesh(mesh):
            (v, ovf), (gp, gf) = vg(params, fields, js)
        assert int(ovf) == 0
        return float(v), [np.asarray(gp[k]) for k in R.GRAD_PARAMS] + [
            np.asarray(gf[f]) for f in R.GRAD_FIELDS]
    return run


def _rel_change(a, b) -> float:
    """|a - b| relative to max |a| (a scalar or a field)."""
    return float(np.abs(np.asarray(b) - np.asarray(a)).max()
                 / np.abs(np.asarray(a)).max())


@pytest.fixture(scope="module")
def jax_grad():
    """JAX's value-and-grad of the all-gather simulate on CPU meshes of 2
    and 4 devices (R.grad_state), and JAX's own spread: the largest
    relative change of the value and of each gradient when every live
    row's position moves one float32 ulp toward +inf or toward -inf, or
    when the mesh has the other size (the ranks' sums in another order):
    ({D: (value, [gradients])}, spreads). mu_viscosity's gradient, a
    small sum of cancelling terms, moves 1.2e-4 under the bump at D = 2
    (5e-5 at D = 4)."""
    js0 = _jax_state(R.grad_state())
    runs, spreads = {}, []
    for d in WORLDS:
        run = _jax_grad_run(js0, JS.make_mesh(jax.devices()[:d]))
        runs[d] = run(js0)
        for toward in (np.inf, -np.inf):
            spreads.append((runs[d], run(bump_pos(js0, toward))))
    spreads.append((runs[WORLDS[0]], runs[WORLDS[1]]))
    spread = [max(_rel_change(a[0], b[0]) for a, b in spreads)]
    for i in range(len(runs[WORLDS[0]][1])):
        spread.append(max(_rel_change(a[1][i], b[1][i]) for a, b in spreads))
    return runs, spread


@pytest.fixture(scope="module")
def single_grad():
    """The port's one-device value-and-grad of the same loss: simulate
    (fused=False, the adjoint scan) and the step loop under autograd
    (R.GRAD_STEP_STEPS steps): {"sim" | "step": (value, [gradients])}."""
    st0, w = R.grad_state(), R.grad_weights(512)
    out = {}
    for case in ("sim", "step"):
        st, leaves, params = R.grad_inputs(st0)
        if case == "sim":
            st, _ = T.simulate(st, R.CFG, R.GRAD_STEPS, R.GRAD_STIM_OFF,
                               fused=False, neighbor_capacity=R.NBR,
                               params=params)
        else:
            for _ in range(R.GRAD_STEP_STEPS):
                st, _ = T.step(st, R.CFG, R.NBR, params=params)
        loss = (st.pos * w).sum()
        g = torch.autograd.grad(loss, list(params.values())
                                + list(leaves.values()))
        out[case] = (float(loss.detach()), [x.numpy() for x in g])
    return out


def test_references(single, jax_gather, jax_fused, jax_halo_uniform):
    """The single-device references (computed while the ranks run):
    finite, and the halo clouds' particles all inside the grid."""
    for name, ref in list(single.items()) + [("jax_gather", jax_gather),
                                             ("jax_fused", jax_fused),
                                             ("jax_halo", jax_halo_uniform)]:
        act = ref["active"].astype(bool)
        assert np.isfinite(ref["pos"][act]).all(), name
    assert int(jax_halo_uniform["active"].sum()) == 900


# --- the collectives ------------------------------------------------------

def test_comm_primitives(world):
    d, res, _ = world
    r = _res(res, f"comm{d}")
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * k
         for k in range(d)]
    np.testing.assert_array_equal(r["all_gather"], np.concatenate(x))
    np.testing.assert_array_equal(r["all_sum"], sum(x))
    np.testing.assert_allclose(r["all_sum_f64"],
                               sum(a.astype(np.float64) / 3.0 for a in x),
                               rtol=1e-15)
    assert r["all_sum_f64"].dtype == np.float64
    zero = np.zeros(6, np.float32)
    for k, row in enumerate(r["per_rank"]):
        assert row[0] == k                                  # axis_index
        np.testing.assert_array_equal(                      # from k - 1
            row[1:7], x[k - 1].reshape(-1) if k > 0 else zero)
        np.testing.assert_array_equal(                      # from k + 1
            row[7:13], x[k + 1].reshape(-1) if k < d - 1 else zero)
    # int32 ids past 2^24 arrive bit for bit through the float32 shift
    ids = [np.array([k, (1 << 24) + 2 * k + 1], np.int32) for k in range(d)]
    for k, row in enumerate(r["shift_ids"]):
        np.testing.assert_array_equal(row, ids[k - 1] if k > 0
                                      else np.zeros(2, np.int32))


def test_transport_pick():
    assert C.pick_transport(4, "cpu") == "gloo"
    comm = C.Comm(0, 2, "gloo", "cpu")
    assert comm.axis_index() == 0 and "gloo over CPU" in comm.describe()
    with pytest.raises(ValueError):
        comm.shift(torch.arange(3.0), 2)
    with pytest.raises(ValueError):
        C.Comm(0, 2, "mpi", "cpu")


def test_ranks_import_no_jax(world):
    d, _, out = world
    files = sorted(out.glob("modules*.txt"))
    assert len(files) == d
    for path in files:
        mods = path.read_text().split()
        bad = [m for m in mods if m.split(".")[0]
               in ("jax", "sph_sm_monodomain_tpu")]
        assert not bad, f"{path.name}: {bad[:5]}"
        assert "sph_sm_monodomain_tpu_torch.parallel.halo_step" in mods


def test_port_parallel_modules_import_no_jax():
    code = ("import sys\n"
            "import sph_sm_monodomain_tpu_torch.parallel.comm\n"
            "import sph_sm_monodomain_tpu_torch.parallel.sharded_step\n"
            "import sph_sm_monodomain_tpu_torch.parallel.halo_step\n"
            "import sph_sm_monodomain_tpu_torch.ablation.bucketed_grid\n"
            "import sph_sm_monodomain_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'sph_sm_monodomain_tpu')]\n"
            "print(bad)\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert got.stdout.strip() == "[]", got.stdout


# --- the unfused all-gather path -----------------------------------------

def test_gather_matches_jax_sharded(world, jax_gather):
    _, res, _ = world
    got = _res(res, "gather")
    assert list(got["overflow"]) == [0] * R.GATHER_STEPS
    _assert_close(got, jax_gather, GATHER_TOLS, "gather vs JAX", n=300)


def test_gather_matches_single_device(world, single):
    _, res, _ = world
    _assert_close(_res(res, "gather"), single["gather"], GATHER_TOLS,
                  "gather vs single device", n=300)


def test_gather_clustered_sm_matches_single_device(world, single):
    _, res, _ = world
    _assert_close(_res(res, "gather_clustered"), single["gather_clustered"],
                  {"pos": (5e-5, 0), "goal_pos": (5e-5, 0)},
                  "clustered gather", n=288)


def test_gather_simulate_stim_off_and_params(world, single):
    _, res, _ = world
    got = _res(res, "gather_sim")
    assert int(got["overflow"]) == 0
    np.testing.assert_array_equal(got["stim"][:200], -10000.0)
    _assert_close(got, single["gather_sim"], {"pos": (1e-4, 0),
                                              "vm": (1e-3, 0)},
                  "gather simulate", n=200)


# --- the fused slab path --------------------------------------------------

def test_fused_slab_matches_single_device(world, single):
    _, res, _ = world
    _assert_close(_res(res, "fused"), single["fused"], FUSED_TOLS,
                  "fused slab vs single device", n=400)


def test_fused_slab_matches_jax(world, jax_fused):
    _, res, _ = world
    _assert_close(_res(res, "fused"), jax_fused, FUSED_TOLS,
                  "fused slab vs JAX step_fused", n=400)


def test_fused_simulate_stim_off_and_params(world, single):
    _, res, _ = world
    got = _res(res, "fused_sim")
    assert int(got["overflow"]) == 0
    np.testing.assert_array_equal(got["stim"][:300], -10000.0)
    _assert_close(got, single["fused_sim"], {"pos": (1e-4, 0),
                                             "vm": (1e-3, 0)},
                  "fused simulate", n=300)


# --- the halo path --------------------------------------------------------

@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_matches_single_device(world, single, case):
    d, res, _ = world
    got = _res(res, f"halo_{case}")
    assert list(got["overflow"]) == [0] * R.HALO_STEPS
    # every pair the exact mask accepts lies inside its sub-block's merged
    # windows (what the kernels walk; the plain sweeps read no windows)
    assert list(got["window_misses"]) == [0] * R.HALO_STEPS
    h, n_h = _by_identity(got)
    r, n_r = _by_identity(single[f"halo_{case}"])
    assert n_h == n_r, "particles lost or duplicated by migration"
    for f, tol in HALO_TOLS.items():
        np.testing.assert_allclose(h[f], r[f], atol=tol,
                                   err_msg=f"halo {case} (D={d}): {f}")
    if case == "empty":
        # the cloud spans ~3 slow planes: at D=4 some ranks own nothing
        s_cap = int(got["s_cap"])
        owners = got["active"].reshape(d, s_cap).any(axis=1)
        assert owners.sum() < d or d == 2
    if case == "stretched":
        # the slow axis is x: each rank's particles sit in its x-slab
        cfg = R.halo_cases()["stretched"][0]
        s_cap = int(got["s_cap"])
        act = got["active"].astype(bool)
        rank = np.nonzero(act)[0] // s_cap
        sb = H.slab_bounds(cfg, d)
        xcell = (got["pos"][act][:, 0] / cfg.cell_size).astype(np.int64)
        assert ((xcell >= sb[rank] - 1) & (xcell < sb[rank + 1] + 1)).mean() \
            > 0.99


def test_halo_matches_jax(world, jax_halo_uniform):
    d, res, _ = world
    h, n_h = _by_identity(_res(res, "halo_uniform"))
    r, n_r = _by_identity(jax_halo_uniform)
    assert n_h == n_r == 900
    for f, tol in HALO_TOLS.items():
        np.testing.assert_allclose(h[f], r[f], atol=tol,
                                   err_msg=f"halo vs JAX (D={d}): {f}")


def test_halo_migration_conserves_particles(world):
    d, res, _ = world
    got = _res(res, "halo_migration")
    assert int(got["overflow"]) == 0
    act = got["active"].astype(bool)
    assert int(act.sum()) == 600
    pos = got["pos"][act]
    assert np.isfinite(pos).all()
    # every particle once, by identity
    want = np.sort(R.migration_state().orig_pos.numpy()[:600], axis=0)
    np.testing.assert_array_equal(np.sort(got["orig_pos"][act], axis=0),
                                  want)
    # ownership: each particle in its rank's z-slab, one step's lag allowed
    s_cap = int(got["s_cap"])
    rank = np.nonzero(act)[0] // s_cap
    zb = H.z_slab_bounds(R.CFG, d)
    zcell = (pos[:, 2] / R.CFG.cell_size).astype(np.int64)
    drift = np.maximum(zb[rank] - 1 - zcell, zcell - zb[rank + 1])
    assert (drift <= 0).mean() > 0.99


def test_halo_dynamic_params_match_baked(world):
    _, res, _ = world
    a, n_a = _by_identity(_res(res, "halo_dyn"))
    b, n_b = _by_identity(_res(res, "halo_baked"))
    assert n_a == n_b == 900
    for f in ("pos", "vel", "vm", "dens", "iion", "w"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-6, rtol=1e-6,
                                   err_msg=f"halo dynamic params: {f}")


# --- the run loop (models/scan.run_steps) ---------------------------------

@pytest.mark.parametrize("path", R.LOOP_PATHS)
def test_simulate_equals_the_step_loop(world, path):
    """Each simulate, through models/scan.run_steps, equals bit for bit the
    step loop it replaced (torch_parallel_ranks.step_loop), with the stim
    off inside the run and physics overrides, and gives the same largest
    overflow (nonzero on the gather and halo paths, whose capacities there
    overflow). A run in two chunks (the stim-off shifted into the second)
    equals the loop's same two chunks bit for bit, and the one run: bit
    for bit on the all-gather paths, whose rows never move; within
    tests/test_halo.py's pos tolerance on the halo path, where each call
    sums the rest-shape moments anew over its migrated rows (as the JAX
    package's make_halo_simulate does)."""
    _, res, _ = world
    got = _res(res, f"loop_{path}")
    one_vs_loop, chunks_vs_loop, chunks_vs_one = got["mismatch"]
    assert one_vs_loop == 0 and chunks_vs_loop == 0
    o_run, o_loop, o_chunks = got["overflow"]
    assert o_run == o_loop == o_chunks
    assert (o_run > 0) == (path != "sharded_fused")
    if path == "halo":
        assert float(got["chunk_pos_err"]) <= HALO_TOLS["pos"]
    else:
        assert chunks_vs_one == 0
    act = got["active"].astype(bool)
    np.testing.assert_array_equal(got["stim"][act], -10000.0)
    assert np.isfinite(got["pos"][act]).all()


def test_capture_keys_name_the_path_and_the_rank(world):
    """The keys the simulates give run_steps: one a path for its one run
    and both chunks (the step count stays out of it, so the chunks after
    the first replay the first one's capture), naming the path first and
    the rank, the group size and the transport last; distinct across the
    three paths and the ranks."""
    d, res, _ = world
    keys = res["loop_keys"]
    n = len(R.LOOP_PATHS)
    assert keys.shape == (d, 3 * n)
    for r in range(d):
        for i, path in enumerate(R.LOOP_PATHS):
            calls = set(keys[r, 3 * i:3 * i + 3])
            assert len(calls) == 1
            key = calls.pop()
            assert key.startswith(f"('{path}', ")
            assert key.endswith(f", {r}, {d}, 'gloo')")
    assert len(set(keys[:, ::3].reshape(-1))) == d * n


# --- the all-gather path under autograd ----------------------------------

VALUE_RTOL, GRAD_RTOL = 1e-5, 1e-4
# the float64 collectives' VJPs against their formulas (sums in another
# order)
VJP_TOL = 1e-12


def _ranks_grad(res, prefix):
    """(value, [override gradients], [field gradients]) of a rank case,
    after asserting that every rank holds the same override gradients."""
    got = _res(res, prefix)
    per_rank = got["params"]
    assert (per_rank == per_rank[0]).all(), per_rank
    return (float(got["value"]), list(per_rank[0]),
            [got[f] for f in R.GRAD_FIELDS])


def _hold_grads(what, got, want, spread):
    """The value within max(VALUE_RTOL, SPREAD_FACTOR x JAX's spread); each
    override's gradient and each field's, row for row, within
    max(GRAD_RTOL, SPREAD_FACTOR x its spread) of the largest |want|
    (tests/test_torch_grad_scan.py's widening)."""
    value, grads = got[0], got[1] + got[2]
    np.testing.assert_allclose(value, want[0], rtol=max(
        VALUE_RTOL, SPREAD_FACTOR * spread[0]), err_msg=f"{what}: value")
    names = list(R.GRAD_PARAMS) + list(R.GRAD_FIELDS)
    for name, a, b, sp in zip(names, grads, want[1], spread[1:]):
        b = np.asarray(b)
        assert np.isfinite(a).all() and np.abs(b).max() > 0, name
        tol = max(GRAD_RTOL, SPREAD_FACTOR * sp) * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what}: d/d{name}")


def test_gather_value_and_grad_matches_jax(world, jax_grad):
    """make_sharded_simulate under autograd (3 steps, the stim off before
    step 1, k_stiffness and mu_viscosity and the initial vel, vm and
    orig_pos requiring grad; each rank differentiates its rows' share of
    sum(pos * w)) against jax.value_and_grad through the JAX package's
    make_sharded_simulate(..., dynamic_params=True) on as many devices:
    the loss, the overrides' gradients (the same on every rank) and the
    fields' gradients row for row."""
    d, res, _ = world
    assert int(_res(res, "grad_sim")["overflow"]) == 0
    runs, spread = jax_grad
    _hold_grads(f"D={d} vs JAX on {d} devices",
                _ranks_grad(res, "grad_sim"), runs[d], spread)


def test_gather_value_and_grad_matches_one_device(world, jax_grad,
                                                   single_grad):
    """The same run against the port's one-device adjoint
    (simulate(fused=False)), at the same tolerances."""
    d, res, _ = world
    _hold_grads(f"D={d} vs one device", _ranks_grad(res, "grad_sim"),
                single_grad["sim"], jax_grad[1])


def test_sharded_step_grad_matches_one_device(world, jax_grad, single_grad):
    """make_sharded_step under eager autograd, R.GRAD_STEP_STEPS steps,
    against the one-device step loop under autograd."""
    d, res, _ = world
    assert int(_res(res, "grad_step")["overflow"]) == 0
    _hold_grads(f"D={d} step vs one device", _ranks_grad(res, "grad_step"),
                single_grad["step"], jax_grad[1])


def test_grad_runs_with_an_all_padding_rank(world):
    """At D = 4 the last rank's 128 rows are all padding: it runs every
    collective of the forward and backward passes with the others (the
    run returned) and holds the same override gradients (_ranks_grad)."""
    d, res, _ = world
    last = int(_res(res, "grad_sim")["last_rank_active"])
    assert (last == 0) == (d == 4), last
    _, params, fields = _ranks_grad(res, "grad_sim")
    assert np.isfinite(params).all() and all(np.isfinite(f).all()
                                             for f in fields)


def test_collective_vjps_match_their_formulas(world):
    """all_gather's VJP is the reduce-scatter of the cotangents, all_sum's
    and replicated's the all_sum, in float64, on gloo and on gloo through
    host copies (columns: all_gather, all_sum, replicated; rows: ranks;
    a result not in float64 adds 1)."""
    _, res, _ = world
    for transport in ("gloo", "gloo-host"):
        errs = res[f"vjp/{transport}"]
        assert (errs <= VJP_TOL).all(), (transport, errs)


def test_gloo_host_gradient_equals_gloo(world):
    """The same value-and-grad through a Comm of the gloo-host transport
    (host copies inside the collectives' Functions both ways; its run
    loop scan.run_steps_uncaptured) equals the gloo run bit for bit."""
    _, res, _ = world
    assert int(res["grad_host/mismatch"]) == 0
    assert str(res["grad_host/run_loop"]).startswith(
        "eager (gloo through host copies), gradients through the eager "
        "adjoint scan")


def test_multi_device_runs_refuse_autograd(world):
    """The fused slab and halo steps and simulates raise, naming the
    missing VJPs and that the JAX package does not differentiate them
    either, when an override or the state requires grad; the all-gather
    step and simulate run; under torch.no_grad() the fused step runs."""
    _, res, _ = world
    want = np.array([[int(m in R.REFUSING)] * 2 for m in R.GRAD_MAKERS])
    np.testing.assert_array_equal(res["grad_raised"], want)
    assert int(res["grad_no_grad_ran"]) == 1


def test_run_loop_by_transport():
    """The simulates' run loop is fixed by the transport: NCCL graphed
    (run_steps), gloo over CPU tensors run_steps (eager on the CPU), gloo
    through host copies run_steps_uncaptured (eager, its gradient the
    eager adjoint scan)."""
    for transport, run, how in (
            ("nccl", scan.run_steps, "graphed"),
            ("gloo", scan.run_steps, "eager (gloo over CPU tensors)"),
            ("gloo-host", scan.run_steps_uncaptured,
             "eager (gloo through host copies)")):
        got_run, got_how = S.run_loop(C.Comm(0, 2, transport, "cpu"))
        assert got_run is run and got_how.startswith(how)


# --- cheap parity with the JAX functions ---------------------------------

@pytest.mark.parametrize("d", (2, 4, 8))
@pytest.mark.parametrize("world_size", ((1.5, 1.5, 1.5), (6.0, 1.5, 1.5)),
                         ids=("cube", "stretched"))
def test_slab_bounds_match_jax(d, world_size):
    cfg = T.SimConfig(world_size=world_size)
    np.testing.assert_array_equal(H.slab_bounds(cfg, d),
                                  JH.slab_bounds(_jcfg(cfg), d))
    np.testing.assert_array_equal(H.z_slab_bounds(cfg, d),
                                  JH.z_slab_bounds(_jcfg(cfg), d))


@pytest.mark.parametrize("case", ("uniform", "empty", "stretched"))
@pytest.mark.parametrize("d", (2, 4))
def test_halo_layout_matches_jax(case, d):
    cfg, st, _ = R.halo_cases()[case]
    mesh = JS.make_mesh(jax.devices()[:d])
    jnew, js, jm, jh = JH.shard_state_halo(_jax_state(st), mesh, _jcfg(cfg))
    lay, s_cap, mig, halo = H.halo_layout(st, d, cfg)
    assert (s_cap, mig, halo) == (js, jm, jh)
    for name, arr in lay.items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jnew, name)),
                                      err_msg=name)
    # each rank's share is its rows of the layout
    for r in range(d):
        loc = H.shard_state_halo(st, C.Comm(r, d, "gloo", "cpu"), cfg)[0]
        np.testing.assert_array_equal(loc.pos.numpy(),
                                      lay["pos"][r * s_cap:(r + 1) * s_cap])
        assert loc.is_stim_on.shape == st.is_stim_on.shape == ()


def test_window_bounds3_matches_jax():
    cfg = T.SimConfig()
    rng = np.random.default_rng(11)
    core = np.sort(rng.integers(0, cfg.num_cells, 256)).astype(np.int32)
    core[-40:] = cfg.num_cells + 2 * 38 * 38        # padding probes
    merged = np.sort(np.concatenate([
        core[:-40], rng.integers(0, cfg.num_cells, 100)])).astype(np.int32)
    got = H._window_bounds3(torch.from_numpy(core), torch.from_numpy(merged),
                            cfg, 64)
    want = JH._window_bounds3(jnp.asarray(core), jnp.asarray(merged),
                              _jcfg(cfg), 64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unshard_roundtrip_matches_jax():
    cfg, st, _ = R.halo_cases()["uniform"]
    lay, *_ = H.halo_layout(st, 4, cfg)
    full = T.ParticleState(**{k: torch.from_numpy(np.array(v))
                              for k, v in lay.items()})
    dense = H.unshard_state_halo(full, 900, cfg)
    jdense = JH.unshard_state_halo(_jax_state(full), 900, _jcfg(cfg))
    for name, arr in _state_fields(dense).items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jdense, name)),
                                      err_msg=name)
    assert dense.capacity % 128 == 0
    np.testing.assert_array_equal(
        np.sort(dense.orig_pos.numpy()[:900], axis=0),
        np.sort(st.orig_pos.numpy()[:900], axis=0))
    with pytest.raises(ValueError, match="overflow loss"):
        H.unshard_state_halo(full, 901, cfg)
    lossy = H.unshard_state_halo(full, 901, cfg, allow_loss=True)
    assert int(lossy.active.sum()) == 900


@pytest.mark.parametrize("form", ("a_slab1", "b_slab0", "a_rows"))
def test_sweep_on_a_slab_of_rows_matches_jax(form):
    """sweep_a3 / sweep_b3 with q_slice (a rank's slab of the sorted rows)
    and with queries that are not the candidates' rows (n_q != n_c), the
    port's plain versions against the JAX kernels in interpret mode."""
    from sph_sm_monodomain_tpu_torch.ops.shape_matching import (
        corrected_velocity)
    cfg, sub_q, n, cnt = R.CFG, 32, 256, 128
    st = R.blob_state(200, 0, pad_to=n, seed=12)
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                   sub_q)
    st = corrected_velocity(st, cfg)
    fs, fa = tfs.build_qm_feats(st, cx, cyz, order)
    off = 0 if form == "b_slab0" else cnt
    jlo, jhi = jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())
    jfs_, jfa = jnp.asarray(fs.numpy()), jnp.asarray(fa.numpy())
    if form == "b_slab0":
        out_a = tfs.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sub_q)
        fb = tfs.feats_b(out_a)
        got = tfs.sweep_b3(out_a, fb, lo, hi, cfg, sub_q=sub_q,
                           q_slice=(off, cnt))
        want = jfs.sweep_b3(jnp.asarray(out_a.numpy()),
                            jnp.asarray(fb.numpy()), jlo, jhi, 32, 128,
                            _jcfg(cfg), q_slice=(off, cnt), sub_q=sub_q,
                            stencil="xyz3")
    elif form == "a_slab1":
        got = tfs.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sub_q,
                           q_slice=(off, cnt))
        want = jfs.sweep_a3(jfs_, jfa, jlo, jhi, 32, 128, _jcfg(cfg),
                            q_slice=(off, cnt), sub_q=sub_q, stencil="xyz3")
    else:
        b0, b1 = off // sub_q * 4, (off + cnt) // sub_q * 4
        got = tfs.sweep_a3(fs[off:off + cnt].contiguous(), fa, lo[b0:b1],
                           hi[b0:b1], cfg, sub_q=sub_q)
        want = jfs.sweep_a3(jfs_[off:off + cnt], jfa, jlo[b0:b1],
                            jhi[b0:b1], 32, 128, _jcfg(cfg), sub_q=sub_q,
                            stencil="xyz3")
    assert tuple(got.shape) == (cnt, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_query_slab_takes_the_sub_blocks_bounds():
    """_query_slab hands the kernel the slab's rows and the bounds of its
    own sub-blocks (the CPU path reads no bounds, so this holds them)."""
    qm = torch.arange(256 * 16, dtype=torch.float32).reshape(256, 16)
    lo = torch.arange(256 // 32 * 4, dtype=torch.int32)
    q, a, b = tfs._query_slab(qm, lo, lo + 1000, (96, 64), 32)
    np.testing.assert_array_equal(q.numpy(), qm.numpy()[96:160])
    np.testing.assert_array_equal(a.numpy(), np.arange(12, 20))
    np.testing.assert_array_equal(b.numpy(), np.arange(12, 20) + 1000)
    for bad in ((16, 64), (96, 48), (224, 64)):
        with pytest.raises(ValueError):
            tfs._query_slab(qm, lo, lo, bad, 32)


def test_c_entry_points_bound_with_their_signatures():
    """Every C entry point cuda_lib binds (the slab launches' among them)
    takes the pointer and int arguments its ctypes signature passes, read
    from the declarations in csrc/*.cu (a CUDA source cannot be built
    here, and ctypes only counts arguments at the call)."""
    import ctypes
    import re
    from sph_sm_monodomain_tpu_torch.ops import cuda_lib
    decls = {}
    for src in cuda_lib.SOURCES:
        text = (cuda_lib.CSRC_DIR / src).read_text()
        for name, params in re.findall(r"\bint\s+(sph_\w+)\(([^)]*)\)\s*\{",
                                       text):
            decls[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                           for p in params.split(",")]
    assert {"sph_sweep_a3_rows", "sph_sweep_b3_rows"} <= set(decls)
    for name, argtypes in cuda_lib._SIGNATURES.items():
        assert decls[name] == argtypes, name
