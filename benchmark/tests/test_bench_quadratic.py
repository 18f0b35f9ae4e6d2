"""The quadratic cell, `biceps_full_quadratic.protocol`: its reference, its
driver and its metric.

On the CPU: the reference's quadratic goals against a direct float64
evaluation in numpy (explicit Givens rotations for the 9 x 9 inverse, the
polar factor from an SVD); the cell cut to the small cloud here (the
4,796-particle `biceps_1`, a 6-step protocol, as small.py cuts the linear
protocol), where a sound run is correct and the control, a step that
returns its state unchanged, and the linear match's goals in the
program's place are not; the new metric's reader off the card; a run of
the new driver loads no jax. On the card (marker `cuda`): the same runs.
"""

from __future__ import annotations

import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.common import ROOT, cell_files, load_manifest
from benchmark.reference import physics as ref
from benchmark.reference import quadratic as quad
from small import CLOUD, PARTICLES, SCENE

CELL = "biceps_full_quadratic.protocol"
SEED = 2 ** 31 + 29


def small_quadratic():
    """(manifest, files) of the cell on the small cloud, 6 steps (stim off
    before step 3, 2-step chunks), with the cell's own limits."""
    man = load_manifest()
    cell, conf, traffic, checks = cell_files(man, CELL)
    conf = dict(conf, scene=SCENE, cloud=CLOUD, particles=PARTICLES)
    return man, (cell, conf, dict(traffic, steps=6, stim_off=3, chunk=2),
                 checks)


def _direct_goals(pos, orig, mass, fixed, P):
    """Quadratic goals (cpp:331-445) in numpy float64: the moments by
    einsum, A9qq^+ from explicit Givens products G^T A G, R = U V^T."""
    mcm = mass * np.where(fixed, P.fixed_mass_scale, 1.0)
    cm = mcm @ pos / mcm.sum()
    ocm = mcm @ orig / mcm.sum()
    p, q = pos - cm, orig - ocm
    x, y, z = q.T
    q9 = np.stack([x, y, z, x * x, y * y, z * z, x * y, y * z, z * x], 1)
    mp = mass[:, None] * p
    apq = np.einsum("ni,nj->ij", mp, q)
    a9pq = np.einsum("ni,nj->ij", mp, q9)
    a = np.einsum("ni,nj->ij", mass[:, None] * q9, q9)
    r9 = np.eye(9)
    for _ in range(P.pinv_rotations):
        off = np.where(np.triu(np.ones((9, 9), bool), 1), np.abs(a), -1.0)
        i, j = divmod(int(np.argmax(off)), 9)
        d = (a[i, i] - a[j, j]) / (2.0 * a[i, j])
        t = np.sign(d) / (abs(d) + np.sqrt(d * d + 1.0)) if d else 1.0
        c = 1.0 / np.sqrt(t * t + 1.0)
        g = np.eye(9)
        g[i, i] = g[j, j] = c
        g[j, i], g[i, j] = t * c, -t * c
        a = g.T @ a @ g
        a[i, j] = a[j, i] = 0.0
        r9 = r9 @ g
    lam = np.diagonal(a)
    pinv = (r9 * np.where(lam != 0.0, 1.0 / lam, 0.0)) @ r9.T
    flip = np.array(quad._FLIP)
    if np.linalg.det(apq) < 0.0:
        apq = apq * flip
    u, _, vt = np.linalg.svd(apq)
    a9 = P.sm_beta * a9pq @ pinv
    a9[:, :3] += (1.0 - P.sm_beta) * (u @ vt)
    det = np.linalg.det(a9[:, :3])
    if det < 0.0:
        a9[:, :3] *= flip
    if det != 0.0:
        a9 *= min(1.0 / np.sqrt(abs(det)), 2.0)
    return q9 @ a9.T + cm


def test_reference_goals_match_a_direct_evaluation():
    """On a bent and twisted copy of the small cloud."""
    _, (_, conf, _, _) = small_quadratic()
    from benchmark.common import cloud
    pts = torch.from_numpy(cloud(conf))
    P = quad.Physics(conf["physics"])
    s = ref.initial_state(pts, torch.zeros(len(pts)), P, 1)
    o = s["orig"]
    x, y, z = o.T
    ang = 0.3 * (x - 0.5)
    bent = torch.stack([x + 0.05 * y * y, y * torch.cos(ang)
                        - z * torch.sin(ang) + 0.1 * x * x,
                        y * torch.sin(ang) + z * torch.cos(ang)], 1)
    got = quad.goals(dict(s, pos=bent), P)
    want = _direct_goals(bent.numpy(), o.numpy(), s["mass"].numpy(),
                         s["fixed"].numpy(), P)
    live = ~s["fixed"].numpy()
    assert np.abs(got.numpy() - want)[live].max() < 1e-9
    assert torch.equal(got[s["fixed"]], o[s["fixed"]])
    # the app's 20 rotations leave A9qq^+ far from converged; the
    # configuration's count brings it there
    a9qq = quad.rest_a9qq(o, s["mass"], s["fixed"], P)
    true = torch.linalg.pinv(a9qq)

    def off(rotations):
        got = quad.jacobi_pinv(a9qq, rotations)[0]
        return float((got - true).abs().max() / true.abs().max())
    assert off(quad.JACOBI_ROTATIONS) > 0.1
    assert off(P.pinv_rotations) < 1e-5


def test_the_reference_refuses_the_linear_configuration():
    _, (_, conf, _, _) = small_quadratic()
    with pytest.raises(ValueError):
        quad.Physics(dict(conf["physics"], quadratic_match=False))


def _failed(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


def test_control_is_not_correct():
    _, files = small_quadratic()
    (line,) = control.readings(CELL, [SEED], {SEED}, device="cpu",
                               files=files)
    limits = files[3]["limits"]
    assert not _failed(line["program"], limits)
    assert _failed(line["control"], limits)


def _unchanged(monkeypatch):
    from sph_sm_monodomain_tpu_torch.models import monodomain

    def step(state, *a, **kw):
        return state, monodomain.StepAux(
            overflow=torch.zeros((), dtype=torch.int32,
                                 device=state.device))
    monkeypatch.setattr(monodomain, "step_fused", step)


def _linear(monkeypatch):
    """The linear match's invariants and goals in the quadratic step."""
    from sph_sm_monodomain_tpu_torch.models import monodomain
    inv, cv = monodomain.sm_invariants, monodomain.corrected_velocity

    def lin(cfg):
        return cfg.replace(quadratic_match=False)
    monkeypatch.setattr(monodomain, "sm_invariants",
                        lambda st, cfg, *a, **kw: inv(st, lin(cfg), *a, **kw))
    monkeypatch.setattr(monodomain, "corrected_velocity",
                        lambda st, cfg, *a, **kw: cv(st, lin(cfg), *a, **kw))


def _sound(monkeypatch):
    pass


def _correct(device):
    man, files = small_quadratic()
    result, checks = run.execute(CELL, SEED, 0.1, False, device=device,
                                 manifest=man, files=files)
    return result["correct"], checks


FAULTS = [(_sound, True), (_unchanged, False), (_linear, False)]
IDS = ["sound", "unchanged", "linear"]


@pytest.mark.parametrize("fault,correct", FAULTS, ids=IDS)
def test_correct_only_when_sound(monkeypatch, fault, correct):
    fault(monkeypatch)
    got, checks = _correct("cpu")
    assert got is correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("fault,correct", FAULTS, ids=IDS)
def test_correct_only_when_sound_on_the_card(card, monkeypatch, fault,
                                            correct):
    fault(monkeypatch)
    got, checks = _correct(card)
    assert got is correct, checks


def test_the_metric_reads_nothing_off_the_card():
    job = types.SimpleNamespace(device=torch.device("cpu"))
    assert run.reader("pseudo_inverse_ms.fwd")(job) is None


def test_a_run_of_the_cell_loads_no_jax():
    code = ("import benchmark.drivers.protocol_quadratic, "
            "sph_sm_monodomain_tpu_torch.config, "
            "benchmark.reference.quadratic; from benchmark.common import "
            "forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_a_traced_small_run_reports_its_metrics_on_the_card(card):
    man, files = small_quadratic()
    result, _ = run.execute(CELL, SEED, 0.1, True, device=card,
                            manifest=man, files=files)
    want = {m["name"] for m in man["per_layer"]
            if CELL in m.get("workloads", [])}
    assert want <= set(result["metrics"]), result["metrics"]
