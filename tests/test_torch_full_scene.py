"""The port's main path at full width against the JAX package.

`run_protocol` on full biceps_full (18,475 particles; the v4 step, on the
CPU through the sweeps' plain versions) from the two starts of
sph_sm_monodomain_tpu_torch.tools.trajectory_parity ("protocol", the scene
as built; "vm_field", a seeded vm field on the live rows) is held to the
JAX trajectory committed in tests/data/biceps_full_jax_trajectory.npz
(tests/full_trajectory.py writes it): inter_vm after step 1 row by row,
and pos, vel, vm, w, iion and dens after steps 3 and 40, each within
max(the JAX suite's one-step tolerance, 2 x the larger of JAX's own
spreads committed beside it: under a one-ulp move of every live position
and under a shuffle of the live rows), dens relative. The committed steps
1 and 3 are regenerated with JAX here and held to the file the same way:
JAX's CPU rounding differs from host to host, so not bit for bit.

A planted fault, the B-spline Laplacian constant 1e-4 off (relative),
fails the vm_field start's step-1 case at 10.1x its tolerance.
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.tools import trajectory_bisect
from sph_sm_monodomain_tpu_torch.tools import trajectory_parity as tp

import full_trajectory as ft
from torch_parity import assert_bit_equal, jax_state_arrays

MAX_BYTES = 3 * 2**20


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Thousands of small ops a step: beside the suite's other parallel
    workers, torch's full intra-op thread pool oversubscribes the cores
    (this file took 335 s there with it, ~75 s alone with two threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return tp.load()


@pytest.fixture(scope="module")
def port_runs():
    """tp.run_start(start, "cpu"), once per start in the module."""
    seen = {}

    def get(start):
        if start not in seen:
            seen[start] = tp.run_start(start, "cpu")
        return seen[start]
    return get


def test_committed_trajectory_and_its_provenance(data):
    assert tp.DATA.stat().st_size <= MAX_BYTES
    n = int(data["live_rows"])
    assert n == 18475 and str(data["scene"]) == tp.SCENE
    assert int(data["seed"]) == tp.SEED
    assert float(data["vm_scale"]) == tp.VM_SCALE
    assert tuple(data["steps"]) == tp.STEPS
    assert int(data["stim_off_step"]) == tp.STIM_OFF_STEP
    for name in ("jax_version", "numpy_version", "cpu_model"):
        assert str(data[name])
    assert int(data["shuffle_seed"]) == tp.SHUFFLE_SEED
    for start in tp.STARTS:
        for what in ("inter_vm",) + tuple(f"{k}_inter_vm" for k in tp.SPREADS):
            got = data[tp.key(start, tp.LAP_STEP, what)]
            assert got.shape == (n,) and np.isfinite(got).all()
        for step in tp.STEPS:
            for f in tp.FIELDS:
                got = data[tp.key(start, step, f)]
                assert got.shape == ((n, 3) if f in ("pos", "vel") else (n,))
                assert np.isfinite(got).all()
                for k in tp.SPREADS:
                    assert float(data[tp.key(start, step, f"{k}_{f}")]) >= 0


@pytest.mark.parametrize("start", tp.STARTS)
def test_port_start_equals_jax_start(start):
    want = jax_state_arrays(ft.jax_start(start).state)
    got = T.state_to_numpy(tp.start_scene(start, "cpu").state)
    for name, v in want.items():
        assert_bit_equal(got[name], v, name)


@pytest.mark.parametrize("start", tp.STARTS)
def test_jax_regenerates_the_committed_steps(start, data):
    """JAX on this host, steps 1 and 3, against the committed file."""
    sc = ft.jax_start(start)
    act = np.asarray(sc.state.active)
    got = {"inter_vm": np.asarray(ft.jax_run(sc, tp.LAP_STEP).inter_vm)[act]}
    r = tp.ratios(got, data, start, tp.LAP_STEP)
    r.update(tp.ratios(ft.live(ft.jax_run(sc, tp.STEPS[0])), data, start,
                       tp.STEPS[0]))
    assert max(r.values()) <= 1.0, r


@pytest.mark.parametrize("step", (tp.LAP_STEP,) + tp.STEPS)
@pytest.mark.parametrize("start", tp.STARTS)
def test_port_run_protocol_matches_jax_trajectory(start, step, data,
                                                  port_runs):
    r = tp.ratios(port_runs(start)[step], data, start, step)
    assert max(r.values()) <= 1.0, r


def test_vm_field_start_covers_the_laplacian(data, port_runs):
    """At step 3 the vm_field start's vm varies across the rows where the
    scene as built keeps it uniform; its step-1 inter_vm departs from the
    protocol start's by far more than its tolerance; at step 40 both
    starts' vm is uniform again: turnOffStim reset it before step 20."""
    lap = {s: port_runs(s)[tp.LAP_STEP]["inter_vm"] for s in tp.STARTS}
    tol = tp.LAP_RTOL * max(1.0, float(np.abs(lap["vm_field"]).max()))
    assert np.abs(lap["vm_field"] - lap["protocol"]).max() > 1e3 * tol
    first, last = tp.STEPS
    for start, uniform in (("protocol", True), ("vm_field", False)):
        for vm in (port_runs(start)[first]["vm"],
                   data[tp.key(start, first, "vm")]):
            assert (np.ptp(vm) == 0.0) if uniform else np.ptp(vm) > 10.0
        for vm in (port_runs(start)[last]["vm"],
                   data[tp.key(start, last, "vm")]):
            assert np.ptp(vm) == 0.0


def test_trajectory_bisect_runs_every_variant_on_cpu(data):
    """tools/trajectory_bisect.py at step 3 on the CPU: every variant
    gives finite ratios; shape matching in float64 departs from the CPU
    port but stays within the two spreads' tolerance."""
    res = trajectory_bisect.bisect("cpu", (3,), data)
    assert list(res) == list(trajectory_bisect.VARIANTS) + ["CPU",
                                                            "jax_shuffled"]
    for name in trajectory_bisect.VARIANTS:
        r = res[name]
        for v in list(r["ulp"][3].values()) + list(r["both"][3].values()):
            assert np.isfinite(v) and v >= 0.0
    f64 = res["shape matching f64"]
    assert max(f64["vs_cpu"].values()) > 0.0
    assert max(f64["both"][3].values()) <= 1.0
    assert res["jax_shuffled"][3]["pos"] > 1.0
