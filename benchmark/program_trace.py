"""The program's own trace of a cell, which the per-layer metrics
`*_span_*`, `off_step_share`, `graph_kernels_per_step`,
`replay_enqueue_us`, `captures_per_unit` and `rebuild_ms` read: one pass,
cached on the job, with the package's tracing on
(sph_sm_monodomain_tpu_torch/utils/tracing.py).

After one warm unit of the cell's own work (Job.trace_stretch), two more
units run with tracing on:
- the traced unit: the device stamps at the step's stage and kernel
  boundaries (inside the captured graphs), the run loop's host spans and
  counters, and the unit's CUDA-event wall;
- the profiled unit: the same under torch.profiler, where the program's
  spans are record_function ranges on the profiler's clock beside the
  device's kernels; the device's idle time in that unit, by the innermost
  program span open at each idle instant, and its operations' time by the
  stamped stage they ran in (the stamps are kernels of the timeline too),
  are printed to standard error.
Neither is the window: the traced run's other metrics and the end-to-end
numbers are taken with tracing off.

A checkout whose package has no tracing module, or a job on no card,
gives no trace: every reader then returns None.
"""

from __future__ import annotations

import bisect
import sys
import time

import torch

from . import flops

WARM, TRACED, PROFILED = ("benchmark.warm", "benchmark.unit",
                          "benchmark.profiled")
SWEEP_SLOTS = ("gathers", "k1", "k2", "apply")
# kernel -> the stamp slot that bounds it in the step
KERNEL_SLOT = {"sweep_a3": "k1", "sweep_b3": "k2", "sweep_lap3": "k3"}
NO_SPAN = "(no program span)"
AFTER = "(after the last stamp)"


def get(job):
    """The cell's program trace (a dict), or None."""
    if not hasattr(job, "_program_trace"):
        job._program_trace = _collect(job)
    return job._program_trace


def _collect(job):
    if torch.device(job.device).type != "cuda":
        return None
    try:
        from sph_sm_monodomain_tpu_torch.utils import tracing
    except ImportError:
        return None
    got = job.trace_stretch()
    if got is None:
        return None
    run, steps = got
    dev = job.device
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    clock = [time.perf_counter()]
    with tracing.enabled():
        with tracing.span(WARM, unit=True):
            run()
        torch.cuda.synchronize(dev)
        before, first = tracing.snapshot(), len(tracing.spans())
        with tracing.span(TRACED, unit=True):
            t0.record()
            run()
            t1.record()
        t1.synchronize()
        after, stamps = tracing.snapshot(), tracing.stamps()
        spans = tracing.spans()[first:]
        order = tracing.STEP_STAMPS["wave" if "k3" in stamps else "v4"]
        clock.append(time.perf_counter())
        idle, stages = _profiled(run, dev, tracing, order)
        clock.append(time.perf_counter())
    trace = {"steps": steps, "stamps": stamps,
             "wall_ns": t0.elapsed_time(t1) * 1e6, "spans": spans,
             "counters": {k: v - before.get(k, 0) for k, v in after.items()
                          if v != before.get(k, 0)},
             "idle": idle, "stages": stages}
    _print(trace)
    print(f"program trace: the pass took {clock[2] - clock[0]:.1f} s (warm "
          f"and traced units {clock[1] - clock[0]:.1f} s, the profiled unit "
          f"and its reading {clock[2] - clock[1]:.1f} s)", file=sys.stderr)
    return trace


def _profiled(run, device, tracing, order) -> tuple:
    """One unit under torch.profiler with tracing on: ({"window_ns",
    "busy_ns", "idle_ns": {innermost program span: ns}}, by_stage(...) of
    its device operations, the stamps taken in the `order` a step stamps
    its slots)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.span(PROFILED, unit=True):
            run()
        torch.cuda.synchronize(device)
    names = {s["name"] for s in tracing.spans()}
    host, dev = [], []
    for start, end, name, on_device, note in _events(prof):
        if on_device:
            if not note and name not in names:
                dev.append((start, end, name))
        elif name in names:
            host.append((start, end, name))
    window = [(a, b) for a, b, n in host if n == PROFILED]
    if not window:
        return {}, {}
    return (idle_by_span([d[:2] for d in dev], host, window[-1]),
            by_stage(dev, order))


def by_stage(ops, order) -> dict:
    """{slot: {operation: ns}}: the device operations (start, end, name),
    each charged to the slot of the next stamp kernel on the timeline,
    the stamps taken to cycle through `order` (a step's stamps, in order;
    a slot may recur); operations after the last stamp go to AFTER."""
    out, pending, k = {}, {}, 0
    for a, b, name in sorted(ops):
        if "stamp_kernel" in name and order:
            slot = out.setdefault(order[k % len(order)], {})
            for n, d in pending.items():
                slot[n] = slot.get(n, 0) + d
            pending, k = {}, k + 1
        else:
            pending[name] = pending.get(name, 0) + (b - a)
    if pending:
        out[AFTER] = pending
    return out


def _events(prof):
    """(start ns, end ns, name, on the device, a user annotation) of each
    event of the profiler's raw (kineto) results."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        raise RuntimeError("torch.profiler kept no kineto results: the "
                           "program trace cannot tell kernels from the "
                           "spans' device-side annotations")
    cuda = torch.autograd.DeviceType.CUDA
    for e in raw.events():
        yield (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
               e.device_type() == cuda, e.is_user_annotation())


def innermost(spans) -> list:
    """[(start, end, name)] cutting the time the nested `spans` ((start,
    end, name), properly nested) cover into pieces, each named by the
    innermost span over it, in order."""
    out, stack, t = [], [], None

    def emit(upto):
        nonlocal t
        if t is not None and upto > t and stack:
            out.append((t, upto, stack[-1][1]))
        t = upto

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return out


def idle_by_span(device, host, window) -> dict:
    """The device's idle time in `window` (start, end): the gaps between
    the `device` intervals, each cut by the innermost `host` span (start,
    end, name) over it, summed by name (NO_SPAN where none is open)."""
    lo, hi = window
    merged = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in device):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    pieces = innermost(host)
    starts = [p[0] for p in pieces]
    idle: dict = {}
    for a, b in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, e, name = pieces[i]
            part = min(b, e) - max(a, s)
            if part > 0:
                idle[name] = idle.get(name, 0) + part
                covered += part
            i += 1
        if b - a > covered:
            idle[NO_SPAN] = idle.get(NO_SPAN, 0) + (b - a - covered)
    return {"window_ns": hi - lo,
            "busy_ns": sum(b - a for a, b in merged), "idle_ns": idle}


def _print(t) -> None:
    st, steps = t["stamps"], t["steps"]
    total = sum(st.values())
    print(f"program trace: {steps} steps, stamped {total / 1e6:.4f} ms of a "
          f"{t['wall_ns'] / 1e6:.4f} ms CUDA-event wall "
          f"({100 * total / t['wall_ns']:.2f}%); ms a step by slot "
          + ", ".join(f"{k} {v / steps / 1e6:.5f}" for k, v in st.items()),
          file=sys.stderr)
    print(f"program trace: counters over the unit {t['counters']}",
          file=sys.stderr)
    idle = t["idle"]
    if idle:
        print(f"program trace: profiled unit, window "
              f"{idle['window_ns'] / 1e6:.3f} ms, device busy "
              f"{idle['busy_ns'] / 1e6:.3f} ms; device idle ms by the "
              "innermost program span:", file=sys.stderr)
        for name, ns in sorted(idle["idle_ns"].items(), key=lambda kv:
                               -kv[1]):
            print(f"  {name:32s} {ns / 1e6:10.3f}", file=sys.stderr)
    if t["stages"]:
        print("program trace: profiled unit, device ms by stamped stage "
              "(the profiler's kernel times), the largest operations:",
              file=sys.stderr)
        for slot, ops in t["stages"].items():
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:4]
            print(f"  {slot:16s} {sum(ops.values()) / 1e6:10.3f} ms, "
                  f"{len(ops)} names: " + "; ".join(
                      f"{n[:60]} {v / 1e6:.3f}" for n, v in top),
                  file=sys.stderr)


# --- the readings -----------------------------------------------------------

def _spans(t, name) -> list:
    return [s for s in t["spans"] if s["name"] == name]


def _ms(s) -> float:
    return (s["end"] - s["start"]) / 1e6


def slot_ms(t, *slots):
    """Stamped ms a step in the slots, or None where none was stamped."""
    got = [t["stamps"][s] for s in slots if s in t["stamps"]]
    return sum(got) / t["steps"] / 1e6 if got else None


def span_roofline(job, t, kernel: str):
    """The kernel's least time at the cell's inputs (benchmark/flops.py)
    over its stamped slot a step, in %."""
    ms = slot_ms(t, KERNEL_SLOT[kernel])
    got = job.kernel_inputs(kernel) if ms is not None else None
    if got is None:
        return None
    _, counts, rows = got
    counts = mean_counts(job, counts)
    return 100.0 * flops.least_seconds(kernel, counts, rows) / (ms * 1e-3)


def mean_counts(job, counts) -> dict:
    """The pair counts over the steps the slots time: of a protocol cell
    the mean over the boundary states its chunks start from (as its
    flops_per_step takes them); of a cell whose cloud does not move,
    `counts`."""
    if not hasattr(job, "starts"):
        return counts
    keep = job.boundaries()
    got = [job._counts(keep[b]) for b in job.starts()]
    return {k: sum(c[k] for c in got) / len(got) for k in counts}


def off_step_share(t):
    total = sum(t["stamps"].values())
    if "off_step" not in t["stamps"] or not total:
        return None
    return 100.0 * t["stamps"]["off_step"] / total


def graph_kernels_per_step(t):
    """Kernel nodes of the replayed step graphs (stamps left out) over the
    steps they hold, over the unit's replays."""
    got = [s["attrs"] for s in _spans(t, "scan.replay")
           if s["attrs"].get("kernels") is not None]
    if not got:
        return None
    return sum(a["kernels"] for a in got) / sum(a["steps"] for a in got)


def replay_enqueue_us(t):
    got = _spans(t, "scan.replay")
    return sum(_ms(s) for s in got) / len(got) * 1e3 if got else None


def captures_per_unit(t):
    return t["counters"].get("scan.captures", 0)


def rebuild_ms(t):
    return sum(_ms(s) for s in _spans(t, "scan.warmup")
               + _spans(t, "scan.capture"))


READINGS = {
    "bookkeeping_span_ms": lambda job, t: slot_ms(t, "bookkeeping"),
    "shape_matching_span_ms": lambda job, t: slot_ms(t, "shape_matching"),
    "sweep_stage_span_ms": lambda job, t: slot_ms(t, *SWEEP_SLOTS),
    "k1_span_roofline": lambda job, t: span_roofline(job, t, "sweep_a3"),
    "k2_span_roofline": lambda job, t: span_roofline(job, t, "sweep_b3"),
    "k3_span_roofline": lambda job, t: span_roofline(job, t, "sweep_lap3"),
    "off_step_share": lambda job, t: off_step_share(t),
    "graph_kernels_per_step": lambda job, t: graph_kernels_per_step(t),
    "replay_enqueue_us": lambda job, t: replay_enqueue_us(t),
    "captures_per_unit": lambda job, t: captures_per_unit(t),
    "rebuild_ms": lambda job, t: rebuild_ms(t),
}


def reading(job, name: str):
    """The metric `name` (a key of READINGS) of the cell's program trace,
    or None."""
    t = get(job)
    return None if t is None else READINGS[name](job, t)
