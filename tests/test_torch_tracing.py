"""Program tracing of the port (sph_sm_monodomain_tpu_torch/utils/
tracing.py): spans, counters and device stamps, off by default.

On the CPU: spans nest with their parent and unit; off records and emits
nothing, on emits the same names into a torch.profiler trace (and
utils/profiling.trace switches it on); the Chrome trace export;
run_protocol's spans and host syncs; the CPU stamps of a v4
step and of a wave step against the step's span; the capture key; and a
traced run's state against an untraced one, bit for bit.

On the card (marker `cuda`; this file imports no jax, so it runs with
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_tracing.py`): the traced graphed protocol against the
untraced one, bit for bit; the step graph's kernel nodes against the
device kernels of one profiled replay, traced and untraced (the stamps are
the only difference); a traced unit's stamped slots against its CUDA-event
wall (3%); the captures a unit makes.
"""

import collections
import contextlib
import json
import re

import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.models import scan, variants
from sph_sm_monodomain_tpu_torch.models.monodomain import (run_protocol,
                                                           step_fused)
from sph_sm_monodomain_tpu_torch.ops.shape_matching import sm_invariants
from sph_sm_monodomain_tpu_torch.state import FIELD_NAMES
from sph_sm_monodomain_tpu_torch.utils import tracing

V4_SLOTS = set(tracing.STEP_STAMPS["v4"])
WAVE_SLOTS = set(tracing.STEP_STAMPS["wave"])


@pytest.fixture(scope="module")
def susane():
    return T.build_scene("susane", device="cpu")


def _names(spans, name):
    return [s for s in spans if s["name"] == name]


def _bits_equal(a, b):
    for f in FIELD_NAMES:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# --- the CPU ----------------------------------------------------------------

def test_spans_nest_with_their_parent_and_unit():
    with tracing.enabled() as store:
        with tracing.span("outer", unit=True):
            with tracing.span("mid", k=1):
                with tracing.span("inner", unit=True):
                    pass
        with tracing.span("free"):
            pass
        with tracing.span("second", unit=True):
            pass
    assert store is not None and not tracing.on()
    by = {s["name"]: (i, s) for i, s in enumerate(tracing.spans())}
    assert [s["name"] for s in tracing.spans()] == ["outer", "mid", "inner",
                                                    "free", "second"]
    assert by["outer"][1]["parent"] is None
    assert by["mid"][1]["parent"] == by["outer"][0]
    assert by["inner"][1]["parent"] == by["mid"][0]
    assert by["mid"][1]["attrs"]["k"] == 1
    # a unit span inside a unit joins it; a new unit after it gets a new id
    assert {by[n][1]["unit"] for n in ("outer", "mid", "inner")} == {0}
    assert by["free"][1]["unit"] is None and by["second"][1]["unit"] == 1
    for _, s in by.values():
        assert s["start"] <= s["end"]
    assert by["outer"][1]["start"] <= by["inner"][1]["start"] \
        <= by["inner"][1]["end"] <= by["outer"][1]["end"]


def test_off_records_nothing_and_emits_no_range(susane):
    with tracing.enabled():
        pass
    before = list(tracing.spans())
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.span("protocol.never", unit=True):
            tracing.count("never")
            tracing.stamp("k1", torch.device("cpu"))
        run_protocol(susane, num_steps=2, chunk=1)
    assert tracing.span("x") is tracing.span("y")   # one shared no-op
    assert tracing.spans() == before == []
    assert "never" not in tracing.snapshot() and tracing.stamps() == {}
    names = {e.name for e in prof.events()}
    assert not any(n.startswith(("protocol.", "simulate.", "scan."))
                   for n in names), names


def test_on_emits_the_spans_into_a_profile(susane):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with tracing.enabled():
        with torch.profiler.profile(activities=acts) as prof:
            run_protocol(susane, num_steps=2, chunk=1)
        recorded = {s["name"] for s in tracing.spans()}
    names = {e.name for e in prof.events()}
    assert {"protocol.unit", "protocol.chunk", "protocol.overflow_fetch",
            "simulate.sm_invariants"} <= recorded
    assert recorded <= names


def test_export_writes_a_chrome_trace(tmp_path, susane):
    with tracing.enabled():
        run_protocol(susane, num_steps=2, chunk=1)
    path = tmp_path / "spans.json"
    tracing.export(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == len(tracing.spans())
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    unit = [e for e in events if e["name"] == "protocol.unit"]
    assert len(unit) == 1 and unit[0]["args"]["parent"] is None
    assert set(unit[0]["args"]["stamps"]) == V4_SLOTS


def test_profiling_trace_carries_the_spans(tmp_path, susane):
    from sph_sm_monodomain_tpu_torch.utils import profiling
    with profiling.trace(str(tmp_path / "tr")):
        assert tracing.on()
        run_protocol(susane, num_steps=1, chunk=1)
    assert not tracing.on()
    names = {e.get("name") for e in json.loads(
        (tmp_path / "tr" / "trace.json").read_text())["traceEvents"]}
    assert {"protocol.unit", "protocol.chunk"} <= names


def test_run_protocol_spans_and_host_syncs(susane):
    with tracing.enabled():
        run_protocol(susane, num_steps=10, chunk=2)
        counters = tracing.snapshot()
    spans = tracing.spans()
    assert len(_names(spans, "protocol.unit")) == 1
    assert len(_names(spans, "protocol.chunk")) == 5
    assert len(_names(spans, "protocol.overflow_fetch")) == 5
    assert len(_names(spans, "protocol.copy_state")) == 1
    assert len(_names(spans, "simulate.sm_invariants")) == 5
    assert counters["protocol.host_syncs"] == 5
    unit = spans.index(_names(spans, "protocol.unit")[0])
    for s in _names(spans, "protocol.chunk"):
        assert s["parent"] == unit and s["unit"] == 0
    # the launch counters sit beside the store's
    assert "fused_step.sweep_a3.launches" in counters
    assert "roofline.fma_chains.launches" in counters


def test_cpu_stamps_of_a_v4_step_sum_to_its_span(susane):
    sc = susane
    inv = sm_invariants(sc.state, sc.cfg)
    step_fused(sc.state, sc.cfg, sc.sub_block, sm_inv=inv)    # warm
    with tracing.enabled():
        with tracing.span("step", unit=True):
            step_fused(sc.state, sc.cfg, sc.sub_block, sm_inv=inv)
        stamps = tracing.stamps()
        (span,) = _names(tracing.spans(), "step")
    # the first stamp (off_step) charges nothing: no stamp came before it
    assert set(stamps) == V4_SLOTS - {"off_step"}
    total, wall = sum(stamps.values()), span["end"] - span["start"]
    assert abs(total - wall) <= 0.05 * wall, (total, wall)
    assert span["attrs"]["stamps"] == stamps


def test_cpu_stamps_of_wave_steps(susane):
    sc = susane
    tables = variants.monodomain_prepare_fused(sc.state, sc.cfg,
                                               sc.sub_block)
    with tracing.enabled():
        with tracing.span("wave", unit=True):
            variants.simulate_monodomain_only_fused(
                sc.state, tables, sc.cfg, 3, sub_q=sc.sub_block)
        stamps = tracing.stamps()
        (span,) = _names(tracing.spans(), "wave")
    assert set(stamps) == WAVE_SLOTS
    total, wall = sum(stamps.values()), span["end"] - span["start"]
    assert total <= wall and total >= 0.9 * wall, (total, wall)


def test_capture_key_holds_the_tracing_state(susane):
    leaves = scan._leaves(susane.state)
    args = (("k",), 1, False, leaves, [], None)
    off = scan._full_key(*args)
    with tracing.enabled():
        on = scan._full_key(*args)
    assert off != on and off[:-1] == on[:-1]
    assert (off[-1], on[-1]) == (False, True)


def test_traced_run_equals_untraced_bit_for_bit(susane):
    kept = {False: {}, True: {}}
    for traced in (False, True):
        def keep(done, st, traced=traced):
            kept[traced][done] = scan.copy_state(st)
        with tracing.enabled() if traced else contextlib.nullcontext():
            out = run_protocol(susane, num_steps=6, stim_off_step=3,
                               chunk=2, callback=keep)[0]
        kept[traced]["end"] = out
    assert sorted(kept[True], key=str) == sorted(kept[False], key=str)
    for k, st in kept[False].items():
        _bits_equal(st, kept[True][k])


def test_device_counters_move_only_while_on():
    tracing.add_device_counters((0, 3))
    with tracing.enabled():
        base = tracing.read_device_counters()
        tracing.add_device_counters((5, 2))
        tracing.add_device_counters((9, -2))
        assert tracing.read_device_counters() == base
        tracing.add_device_counters((0, 4))
        assert tracing.read_device_counters() == (base[0] + 4,)
    tracing.add_device_counters((0, 4))
    assert tracing.read_device_counters() == (base[0] + 4,)


def test_the_lru_remembers_evictions_only_while_on():
    saved = list(scan._captures.items())
    scan.clear_cache()
    try:
        for i in range(scan.MAX_CAPTURES + 1):
            scan._cache(("untraced", i), None)
        assert not scan._evicted
        with tracing.enabled():
            for i in range(2):
                scan._cache(("traced", i), None)
        assert scan._evicted == {("untraced", 1), ("untraced", 2)}
    finally:
        scan.clear_cache()
        scan._captures.update(saved)


# --- the card ---------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stamp kernel and the captured "
                    "graphs run on the card only)")
    return torch.device("cuda", 0)


def _device_ops(run) -> collections.Counter:
    """Device operations of run() under the profiler, by name (the
    program's span annotations left out)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    spans = {s["name"] for s in tracing.spans()}
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.name not in spans)


def _kernels(ops) -> int:
    """The kernels among profiled device operations: not the copies and
    sets (the CUDA runtime runs some graph copies as kernels of its own,
    such as `memcpy32_post`)."""
    return sum(n for name, n in ops.items()
               if not re.search("memcpy|memset", name, re.I))


def _coupled_graph(traced: bool):
    """The one-step graph of the cached coupled capture, traced or not."""
    for key, entry in scan._captures.items():
        if isinstance(key[0], tuple) and key[0][0] == "coupled" \
                and key[-1] is traced:
            return entry.graphs[1][0]
    raise AssertionError(f"no coupled capture (traced={traced})")


@pytest.mark.cuda
def test_traced_graphed_protocol_matches_untraced_on_card(device):
    sc = T.build_scene("biceps_1", device=device)
    scan.clear_cache()
    kept = {False: {}, True: {}}
    for traced in (False, True):
        def keep(done, st, traced=traced):
            kept[traced][done] = scan.copy_state(st)
        with tracing.enabled() if traced else contextlib.nullcontext():
            out = run_protocol(sc, num_steps=20, stim_off_step=10, chunk=5,
                               callback=keep)[0]
        kept[traced]["end"] = scan.copy_state(out)
    assert len(kept[True]) == len(kept[False]) == 5
    for k, st in kept[False].items():
        _bits_equal(st, kept[True][k])


@pytest.mark.cuda
def test_step_graph_kernel_nodes_match_a_profiled_replay(device):
    sc = T.build_scene("biceps_1", device=device)
    scan.clear_cache()
    run_protocol(sc, num_steps=4, chunk=2)
    untraced = _coupled_graph(False)
    with tracing.enabled():
        run_protocol(sc, num_steps=4, chunk=2)
        captures = tracing.snapshot()["scan.captures"]
    traced = _coupled_graph(True)
    kernels = traced.trace_info["kernels"]
    assert captures == 1 and traced.trace_info["steps"] == 1
    nodes = tracing.graph_nodes(traced)
    ops = _device_ops(untraced.replay)
    other = {k: v for k, v in ops.items()
             if re.search("memcpy|memset", k, re.I)}
    assert _kernels(ops) == kernels, (nodes, other)
    # the traced graph differs by its eight stamps, and only by them
    stamps = len(tracing.STEP_STAMPS["v4"])
    assert nodes["kernel"] == kernels + stamps
    assert _kernels(_device_ops(traced.replay)) == kernels + stamps


@pytest.mark.cuda
def test_traced_unit_slots_cover_its_event_wall(device):
    sc = T.build_scene("biceps_full", device=device)
    scan.clear_cache()
    with tracing.enabled():
        run_protocol(sc, num_steps=300, chunk=100)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0.record()
        run_protocol(sc, num_steps=300, chunk=100)
        t1.record()
        t1.synchronize()
        stamps = tracing.stamps()
    wall_ns = t0.elapsed_time(t1) * 1e6
    assert set(stamps) == V4_SLOTS
    total = sum(stamps.values())
    assert abs(total - wall_ns) <= 0.03 * wall_ns, (total, wall_ns, stamps)


@pytest.mark.cuda
def test_captures_a_unit_makes(device):
    sc = T.build_scene("biceps_1", device=device)
    tables = variants.monodomain_prepare_fused(sc.state, sc.cfg,
                                               sc.sub_block)

    def wave():
        variants.simulate_monodomain_only_fused(
            sc.state, tables, sc.cfg, 20, sub_q=sc.sub_block).vm[0].item()

    def protocol():
        run_protocol(sc, num_steps=20, chunk=10)

    scan.clear_cache()
    with tracing.enabled():
        got = {}
        for name, unit in (("protocol", protocol), ("wave", wave)):
            unit()
            before = tracing.snapshot()
            unit()
            after = tracing.snapshot()
            got[name] = {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("scan.captures", "scan.warmups",
                                   "scan.captures.not_held")}
    assert got["protocol"] == {"scan.captures": 1, "scan.warmups": 1,
                               "scan.captures.not_held": 1}
    assert got["wave"] == {"scan.captures": 0, "scan.warmups": 0,
                           "scan.captures.not_held": 0}
