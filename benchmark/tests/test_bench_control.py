"""`correct` has to come out false for the control and for every fault a
cell can have. The control is the reference in float32 with TF32 products
in the program's place; the faults break the timed path underneath a run
that skips the harness's look for a card: a step that returns its state
unchanged, and an answer altered where it is produced; on the card also the
captured graphs the window replays, some of their replays skipped or each
one's answer altered, while the eager steps stay sound."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, run
from small import small_cell

CELLS = ("biceps_full.protocol", "biceps_full.wave")
SEED = 2 ** 31 + 11


def _failed(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _, files = small_cell(cell)
    (line,) = control.readings(cell, [SEED], {SEED}, device="cpu",
                               files=files)
    limits = files[3]["limits"]
    assert not _failed(line["program"], limits)
    assert _failed(line["control"], limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["biceps_full.protocol",
                                  "biceps_x56.protocol", "biceps_full.wave"])
def test_control_is_not_correct_at_full_size(card, cell):
    from benchmark.common import cell_files, load_manifest
    files = cell_files(load_manifest(), cell)
    seeds = [SEED, SEED + 1, SEED + 2]
    for line in control.readings(cell, seeds, set(seeds), files=files):
        assert _failed(line["control"], files[3]["limits"]), line


def _unchanged(monkeypatch, cell):
    from sph_sm_monodomain_tpu_torch.models import monodomain, variants
    if cell.endswith("protocol"):
        def step(state, *a, **kw):
            return state, monodomain.StepAux(
                overflow=torch.zeros((), dtype=torch.int32))
        monkeypatch.setattr(monodomain, "step_fused", step)
    else:
        monkeypatch.setattr(variants, "_vm_frames",
                            lambda body, state, *a, **kw: state)


def _altered(monkeypatch, cell):
    from sph_sm_monodomain_tpu_torch.models import monodomain, variants
    if cell.endswith("protocol"):
        orig = monodomain.step_fused

        def step(*a, **kw):
            st, aux = orig(*a, **kw)
            return st.replace(pos=st.pos + torch.tensor(
                [[1e-3, 0.0, 0.0]] + [[0.0] * 3] * (st.capacity - 1))), aux
        monkeypatch.setattr(monodomain, "step_fused", step)
    else:
        orig = variants.fhn_cell_model

        def fhn(st, cfg):
            st = orig(st, cfg)
            return st.replace(iion=st.iion + 1e-4)
        monkeypatch.setattr(variants, "fhn_cell_model", fhn)


@pytest.mark.parametrize("fault", [_unchanged, _altered],
                         ids=["unchanged", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    man, files = small_cell(cell)
    fault(monkeypatch, cell)
    result, checks = run.execute(cell, SEED, 0.1, False, device="cpu",
                                 manifest=man, files=files)
    assert result["correct"] is False, checks


def test_a_sound_small_run_is_correct():
    for cell in CELLS:
        man, files = small_cell(cell)
        result, checks = run.execute(cell, SEED, 0.1, False, device="cpu",
                                     manifest=man, files=files)
        assert result["correct"] is True, checks


def _skipped_replays(monkeypatch):
    from sph_sm_monodomain_tpu_torch.models import scan
    orig, count = scan._replay, [0]

    def replay(graph, counted):
        count[0] += 1
        if count[0] % 2:
            orig(graph, counted)
    monkeypatch.setattr(scan, "_replay", replay)


def _altered_replays(monkeypatch):
    from sph_sm_monodomain_tpu_torch.models import scan
    orig = scan._Capture.replay

    def replay(self, step, length):
        orig(self, step, length)
        self.bufs.pos[0, 0] += 1e-3
    monkeypatch.setattr(scan._Capture, "replay", replay)


PROTOCOLS = ("biceps_full.protocol", "biceps_x56.protocol")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", PROTOCOLS)
def test_a_sound_small_run_is_correct_on_the_card(card, cell):
    man, files = small_cell(cell)
    result, checks = run.execute(cell, SEED, 0.1, False, device=card,
                                 manifest=man, files=files)
    assert result["correct"] is True, checks


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_skipped_replays, _altered_replays],
                         ids=["skipped", "altered"])
@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("cell", PROTOCOLS)
def test_a_broken_replay_is_not_correct(card, monkeypatch, cell, size,
                                        fault):
    from benchmark.common import cell_files, load_manifest
    if size == "small":
        man, files = small_cell(cell)
    else:
        man = load_manifest()
        files = cell_files(man, cell)
    fault(monkeypatch)
    result, checks = run.execute(cell, SEED, 0.1, False, device=card,
                                 manifest=man, files=files)
    assert result["correct"] is False, checks
    assert dict((k, v) for k, v, _ in checks)["eager_mismatch"] > 0, checks
