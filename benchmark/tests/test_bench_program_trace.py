"""The per-layer metrics that read the program's own trace
(benchmark/program_trace.py): each has a reader, a `workloads` list and
returns None without a card; the idle time cut by the innermost program
span; the readings' arithmetic on a trace made by hand; and on the card,
a traced small run reports each of them in every cell it lists.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import flops, program_trace, run
from benchmark.common import BENCH, ROOT
from small import small_cell

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {m["name"]: m for m in MAN["per_layer"]
       if f"{m['name'][:-4]}" in program_trace.READINGS}
SEED = 2 ** 31 + 23


def test_every_program_trace_metric_is_in_the_manifest():
    assert set(NEW) == {f"{k}.fwd" for k in program_trace.READINGS}
    assert len(NEW) == 11


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_has_a_reader_and_a_cell_list(name):
    m = NEW[name]
    cells = {w["name"] for w in MAN["workloads"]}
    assert m["workloads"] and set(m["workloads"]) <= cells
    assert m["moves"] == "particle_steps_per_s"
    assert m["source"] in ("device_trace", "host_clock", "program_counter")
    assert (BENCH / "metrics" / f"{name}.py").is_file()
    job = types.SimpleNamespace(device=torch.device("cpu"))
    assert run.reader(name)(job) is None


def test_innermost_cuts_nested_spans():
    spans = [(0, 100, "unit"), (10, 40, "chunk"), (20, 30, "replay"),
             (60, 90, "chunk")]
    assert program_trace.innermost(spans) == [
        (0, 10, "unit"), (10, 20, "chunk"), (20, 30, "replay"),
        (30, 40, "chunk"), (40, 60, "unit"), (60, 90, "chunk"),
        (90, 100, "unit")]


def test_idle_by_span_sums_each_gap_by_its_innermost_span():
    host = [(0, 100, "unit"), (10, 40, "chunk"), (20, 30, "replay")]
    device = [(5, 15), (12, 22), (28, 50), (55, 120)]
    got = program_trace.idle_by_span(device, host, (0, 110))
    # busy [5, 22], [28, 50] and [55, 110]: idle [0, 5) and [50, 55)
    # under the unit alone, [22, 28) under the replay
    assert got["window_ns"] == 110 and got["busy_ns"] == 17 + 22 + 55
    assert got["idle_ns"] == {"unit": 10, "replay": 6}
    got = program_trace.idle_by_span([(20, 30)], [(25, 35, "x")], (0, 40))
    assert got["idle_ns"] == {program_trace.NO_SPAN: 25, "x": 5}


def test_by_stage_charges_each_operation_to_the_next_stamp():
    ops = [(0, 1, "stamp_kernel"), (1, 3, "sort"), (3, 4, "stamp_kernel"),
           (4, 9, "polar"), (9, 10, "stamp_kernel"), (10, 12, "copy"),
           (12, 13, "stamp_kernel"), (13, 14, "sort"), (14, 15, "tail")]
    got = program_trace.by_stage(ops, ["off_step", "book", "sm"])
    assert got == {"off_step": {"copy": 2}, "book": {"sort": 2},
                   "sm": {"polar": 5},
                   program_trace.AFTER: {"sort": 1, "tail": 1}}


def test_by_stage_adds_up_a_slot_a_step_stamps_twice():
    ops = [(0, 1, "stamp_kernel"), (1, 3, "cat_a"), (3, 4, "stamp_kernel"),
           (4, 9, "k1"), (9, 10, "stamp_kernel"), (10, 11, "cat_b"),
           (11, 12, "stamp_kernel"), (12, 16, "k2"), (16, 17, "stamp_kernel")]
    got = program_trace.by_stage(ops, ["off_step", "gathers", "k1",
                                       "gathers", "k2"])
    assert got == {"off_step": {}, "gathers": {"cat_a": 2, "cat_b": 1},
                   "k1": {"k1": 5}, "k2": {"k2": 4}}


def test_mean_counts_over_a_protocol_cells_chunk_starts():
    counts = {"full": 10, "h": 2, "2h": 4}
    plain = types.SimpleNamespace()
    assert program_trace.mean_counts(plain, counts) is counts
    keep = {0: 1, 100: 2, 200: 6}
    job = types.SimpleNamespace(
        starts=lambda: range(0, 300, 100), boundaries=lambda: keep,
        _counts=lambda s: {"full": 10 * s, "h": 2 * s, "2h": 4 * s})
    assert program_trace.mean_counts(job, counts) == {"full": 30, "h": 6,
                                                      "2h": 12}


def _trace(stamps, spans, counters, steps=4):
    return {"steps": steps, "stamps": stamps, "wall_ns": 1, "spans": spans,
            "counters": counters, "idle": {}, "stages": {}}


def test_readings_of_a_trace_made_by_hand():
    ms = 1_000_000
    stamps = {"off_step": 4 * ms, "bookkeeping": 2 * ms,
              "shape_matching": 8 * ms, "gathers": ms, "k1": 2 * ms,
              "k2": 3 * ms, "apply": ms}
    replay = {"name": "scan.replay", "start": 0, "end": 30_000,
              "attrs": {"kernels": 1333, "steps": 1}}
    spans = [replay, dict(replay, end=10_000),
             {"name": "scan.warmup", "start": 0, "end": 5 * ms, "attrs": {}},
             {"name": "scan.capture", "start": 0, "end": 7 * ms,
              "attrs": {}}]
    t = _trace(stamps, spans, {"scan.captures": 1})
    counts, rows = {"full": 10 ** 6, "h": 10 ** 5, "2h": 3 * 10 ** 5}, 1024
    job = types.SimpleNamespace(
        device=torch.device("cpu"), _program_trace=t,
        kernel_inputs=lambda k: (None, counts, rows)
        if k in ("sweep_a3", "sweep_b3") else None)
    got = {k: program_trace.reading(job, k) for k in program_trace.READINGS}
    assert got["bookkeeping_span_ms"] == 0.5
    assert got["shape_matching_span_ms"] == 2.0
    assert got["sweep_stage_span_ms"] == 1.75
    assert got["off_step_share"] == pytest.approx(100 * 4 / 21)
    assert got["k1_span_roofline"] == pytest.approx(
        100 * flops.least_seconds("sweep_a3", counts, rows) / 0.5e-3)
    assert got["k2_span_roofline"] == pytest.approx(
        100 * flops.least_seconds("sweep_b3", counts, rows) / 0.75e-3)
    assert got["k3_span_roofline"] is None
    assert got["graph_kernels_per_step"] == 1333
    assert got["replay_enqueue_us"] == pytest.approx(20.0)
    assert got["captures_per_unit"] == 1 and got["rebuild_ms"] == 12.0
    wave = _trace({"off_step": ms, "reaction": ms, "k3": 2 * ms,
                   "update": ms}, [], {})
    job.kernel_inputs = lambda k: (None, counts, rows)
    job._program_trace = wave
    assert program_trace.reading(job, "bookkeeping_span_ms") is None
    assert program_trace.reading(job, "k3_span_roofline") == pytest.approx(
        100 * flops.least_seconds("sweep_lap3", counts, rows) / 0.5e-3)
    assert program_trace.reading(job, "captures_per_unit") == 0
    assert program_trace.reading(job, "rebuild_ms") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["biceps_full.protocol",
                                  "biceps_full.wave"])
def test_a_traced_small_run_reports_them_on_the_card(card, cell):
    man, files = small_cell(cell)
    result, _ = run.execute(cell, SEED, 0.1, True, device=card,
                            manifest=man, files=files)
    want = {n for n, m in NEW.items() if cell in m["workloads"]}
    assert want <= set(result["metrics"]), result["metrics"]
    assert result["metrics"]["captures_per_unit.fwd"]["value"] == (
        1 if cell.endswith("protocol") else 0)
