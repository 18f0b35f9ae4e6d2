"""Quadratic shape matching (SimConfig.quadratic_match, the reference app's
`quadraticMatch`) through the port's fused v4 step, held to the plain
float64 reference of the benchmark (benchmark/reference/quadratic.py,
which shares no code with the port).

On the CPU, on the 4,796-row `biceps_1` cloud with a seeded vm, with the
9 x 9 Jacobi's rotations at the app's 20 and at 100 (PortConfig's
`pinv_rotations`), where its inverse has converged: the pivots of the
rest shape's Jacobi, and one step from the start and one from the state
after 3 steps, against the reference; the fault the comparison must see,
the linear match's goals in the quadratic step's place after 3 steps (at
the start a converged inverse gives the rest shape's goals, as the linear
match does); and `pinv_rotations` leaving the 3 x 3 polar's rotations and
the linear step alone.

On the card (marker `cuda`; this file imports no jax, so it runs with
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_quadratic.py`), on all of biceps_full at the converged
count (at the app's 20 the muscle diverges to inf and NaN within 200
steps), biceps_full_quadratic's configuration: the graphed protocol against the eager steps bit for bit, a
second call served by the kept capture, and a traced unit's
pseudo-inverse spans, rotations and pivots against the reference's.

Tolerances of one step, float32 port against float64 reference:
  - goal 1e-5 (m): the port sums each step's 3 x 9 moment A9pq in float32
    and multiplies it by the rest shape's pseudo-inverse (condition
    number ~1e4; the rest moments are float64, rounded once), and the
    goals read 1.5e-6 to 2.1e-6 here. The linear
    reference's goals miss the quadratic step's by 8.9e-4 (converged) and
    0.11 (app) after 3 steps, so the fault test asks for ten times this
    tolerance;
  - vel 5e-3 (m/s): float32 sums of the pressure and viscous forces over
    each particle's neighbours, times dt / m, and the goal's error times
    alpha / dt (~97): 1.5e-3 to 1.7e-3 read at the start, 2e-4 after 3
    steps;
  - pos 2e-5 (m): the goal's tolerance plus dt (3.1e-3 s) times the
    velocity's (4.6e-6 to 5.3e-6 read at the start, 6.5e-7 after 3 steps).
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.config import PortConfig, pinv_rotations
from sph_sm_monodomain_tpu_torch.models import scan
from sph_sm_monodomain_tpu_torch.models.monodomain import run_protocol
from sph_sm_monodomain_tpu_torch.ops import shape_matching
from sph_sm_monodomain_tpu_torch.ops.shape_matching import sm_invariants
from sph_sm_monodomain_tpu_torch.state import FIELD_NAMES
from sph_sm_monodomain_tpu_torch.utils import tracing

from benchmark.drivers import PROG
from benchmark.drivers.protocol import CARRY
from benchmark.reference import physics as ref
from benchmark.reference import quadratic as quad

ROOT = Path(__file__).resolve().parents[1]
# biceps_full's constants (the package's defaults) with the switch on
PHYS = dict(json.loads((ROOT / "benchmark" / "configs"
                        / "biceps_full.json").read_text())["physics"],
            quadratic_match=True)
# the 9 x 9 Jacobi's rotations: the app's (jacobi_iterations), and a
# count at which the inverse has converged (within 1.1e-6 of its value on
# biceps_full), biceps_full_quadratic's
ROTATIONS = {"app": None, "converged": 100}
GOAL_TOL, VEL_TOL, POS_TOL = 1e-5, 5e-3, 2e-5
SPAN = "sm_invariants.pseudo_inverse"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Thousands of small ops a step (the polar chain): beside the
    suite's other parallel workers, torch's full intra-op thread pool
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(name, device, rotations, seed=3):
    """The scene with quadratic matching and a seeded vm on its live rows:
    (scene, that vm)."""
    cfg = PortConfig().replace(quadratic_match=True,
                               pinv_rotations=rotations)
    sc = T.build_scene(name, cfg=cfg, device=device)
    n = sc.num_particles
    g = torch.Generator(device=device).manual_seed(seed)
    vm = torch.randn(n, generator=g, device=device) * 5
    full = sc.state.vm.clone()
    full[:n] = vm
    return sc._replace(state=sc.state.replace(vm=full)), vm


def _pivots(state, cfg) -> list:
    """The (p, q) of each rotation of the port's rest-shape Jacobi, from
    its trace."""
    with tracing.enabled():
        sm_invariants(state, cfg)
        spans = [s for s in tracing.spans() if s["name"] == SPAN]
    assert len(spans) == 1
    return spans[0]["attrs"]["pivots"]


def _physics(sc):
    return quad.Physics(dict(PHYS, pinv_rotations=pinv_rotations(sc.cfg)))


def _reference_pivots(sc, vm) -> list:
    n = sc.num_particles
    P = _physics(sc)
    r0 = ref.initial_state(sc.state.pos[:n], vm, P, 1)
    return quad.jacobi_pinv(quad.rest_a9qq(r0["orig"], r0["mass"],
                                           r0["fixed"], P),
                            P.pinv_rotations)[1]


@pytest.fixture(scope="module", params=sorted(ROTATIONS))
def small(request):
    with torch.no_grad():
        sc, vm = _scene("biceps_1", "cpu", ROTATIONS[request.param])
        after3 = run_protocol(sc, num_steps=3, stim_off_step=-1)[0]
    return sc, vm, {0: sc.state, 3: after3}


def test_the_reference_takes_the_ports_pivots(small):
    sc, vm, _ = small
    got = _pivots(sc.state, sc.cfg)
    assert len(got) == pinv_rotations(sc.cfg)
    assert got == _reference_pivots(sc, vm)


def _one_step(small, start):
    """(the port's step, the quadratic reference's, the linear
    reference's) from the state after `start` steps."""
    sc, vm, states = small
    n = sc.num_particles
    s = states[start]
    with torch.no_grad():
        got = run_protocol(sc._replace(state=s), num_steps=1,
                           stim_off_step=-1)[0]
    P = _physics(sc)
    base = dict(ref.initial_state(sc.state.pos[:n], vm, P, 1),
                **{k: getattr(s, PROG[k])[:n].double() for k in CARRY})
    linear = ref.goals(base, ref.Physics(dict(PHYS, quadratic_match=False)))
    return ({f: getattr(got, PROG[f])[:n].double() for f in ref.FIELDS},
            quad.step(base, P), linear)


def _gap(a, b) -> float:
    return float((a - b).abs().max())


@pytest.mark.parametrize("start", [0, 3], ids=["start", "after3"])
def test_one_step_matches_the_reference(small, start):
    got, want, _ = _one_step(small, start)
    assert _gap(got["goal"], want["goal"]) < GOAL_TOL
    assert _gap(got["pos"], want["pos"]) < POS_TOL
    assert _gap(got["vel"], want["vel"]) < VEL_TOL


def test_linear_goals_miss_the_quadratic_step(small):
    got, _, linear = _one_step(small, 3)
    assert _gap(got["goal"], linear) >= 10 * GOAL_TOL


def test_pinv_rotations_leave_the_polar_and_the_linear_step_alone(
        monkeypatch):
    """The 3 x 3 polar takes jacobi_iterations whatever pinv_rotations
    says, and the linear step of a PortConfig is SimConfig's bit for
    bit."""
    taken = []
    polar = shape_matching.polar_decomposition

    def spy(a, iterations=20):
        taken.append(iterations)
        return polar(a, iterations)
    monkeypatch.setattr(shape_matching, "polar_decomposition", spy)
    with torch.no_grad():
        sc, _ = _scene("biceps_1", "cpu", ROTATIONS["converged"])
        run_protocol(sc, num_steps=1, stim_off_step=-1)
        assert taken and set(taken) == {sc.cfg.jacobi_iterations}
        lin = sc._replace(cfg=sc.cfg.replace(quadratic_match=False))
        got = run_protocol(lin, num_steps=2, stim_off_step=-1)[0]
        base = T.SimConfig(**{f.name: getattr(lin.cfg, f.name)
                              for f in dataclasses.fields(T.SimConfig)})
        want = run_protocol(lin._replace(cfg=base), num_steps=2,
                            stim_off_step=-1)[0]
    for f in FIELD_NAMES:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# --- the card -------------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no "
                    "CPU mode; the CPU tests above run their plain "
                    "versions)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graphed_quadratic_protocol_equals_eager_on_card(device):
    sc, _ = _scene("biceps_full", device, ROTATIONS["converged"])
    scan.clear_cache()
    kept = {}
    for graphed in (True, False):
        out = {}

        def keep(done, st, out=out):
            out[done] = scan.copy_state(st)
        if graphed:
            run_protocol(sc, num_steps=200, chunk=100, callback=keep)
        else:
            with scan.eager():
                run_protocol(sc, num_steps=200, chunk=100, callback=keep)
        kept[graphed] = out
    assert sorted(kept[True]) == [100, 200]
    for done, st in kept[True].items():
        for f in FIELD_NAMES:
            assert torch.equal(getattr(st, f), getattr(kept[False][done],
                                                       f)), (done, f)


@pytest.mark.cuda
def test_traced_quadratic_units_on_card(device):
    """A second unit is served by the kept capture, and each `simulate`
    call records one pseudo-inverse span of its rotations, whose pivots are
    the reference's."""
    sc, vm = _scene("biceps_full", device, ROTATIONS["converged"])
    scan.clear_cache()
    with tracing.enabled():
        run_protocol(sc, num_steps=200, chunk=100)
        before, first = tracing.snapshot(), len(tracing.spans())
        run_protocol(sc, num_steps=200, chunk=100)
        after, spans = tracing.snapshot(), tracing.spans()[first:]
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("scan.captures", "scan.loads",
                       "sm_invariants.jacobi_rotations")}
    assert delta == {"scan.captures": 0, "scan.loads": 2,
                     "sm_invariants.jacobi_rotations":
                     2 * ROTATIONS["converged"]}
    got = [s for s in spans if s["name"] == SPAN]
    assert len(got) == 2
    parents = {spans[s["parent"] - first]["name"] for s in got}
    assert parents == {"simulate.sm_invariants"}
    want = _reference_pivots(sc, vm)
    assert all(s["attrs"]["pivots"] == want for s in got)
