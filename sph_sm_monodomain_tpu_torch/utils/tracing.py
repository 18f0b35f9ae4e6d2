"""Program tracing of the port: host spans, counters and device stamps in
one store, off by default.

    from sph_sm_monodomain_tpu_torch.utils import tracing
    with tracing.enabled():
        state, aux, _ = run_protocol(scene)
    tracing.export("spans.json")    # the host spans as a Chrome trace
    tracing.snapshot()              # every counter, the launch counters too
    tracing.stamps()                # device ns a slot, of the last unit

Off (outside `enabled()`), each instrumented site of the package tests one
module-global flag and goes on: nothing is recorded, allocated or
launched, and the run loop (models/scan.py) captures its graphs without
stamps. `enabled()` reads no environment variable.

Spans. `span(name)` records its name, start and end (time.perf_counter_ns),
its parent span and its unit. A span opened with `unit=True` outside any
unit starts a new unit id (run_protocol's `protocol.unit`, one call): the
device stamps are zeroed at its start and read at its end. While tracing
is on, each span is also a `torch.profiler.record_function` range, so a
profile taken inside `enabled()` shows the spans on the profiler's own
clock beside the device's kernels. (Off, none is emitted: the profiler
turns such ranges into device-side annotations, which a profile taken
untraced would count as busy.)

Counters. `count(name, n)` adds to a named counter of the store, and
`snapshot()` returns them beside the package's kernel launch counters
(ops/cuda_lib.launch_counters). A counter bumped inside a step that a CUDA
graph captures is one of DEVICE_COUNTERS (`tracing.stamps`, the stamps
launched), which models/scan.py corrects after a capture and a replay as
it corrects the launch counters.

Device stamps. `stamp(slot, device)` charges the time since the device's
previous stamp to `slot` (SLOTS): on the card a one-thread kernel
(csrc/tracing.cu) reads the global timer into a small int64 buffer owned
here, inside the captured graphs too; on the CPU the host clock. The
coupled v4 step (models/monodomain.step_fused) stamps `off_step` at its
start (the time since the previous step ended: idle, copies, the host) and
then `bookkeeping`, `shape_matching`, `gathers` (K1's inputs), `k1`,
`gathers` again (K2's inputs: the slot adds both), `k2` and `apply` as
each stage ends; the fused wave step (models/variants.
simulate_monodomain_only_fused) `off_step`, `reaction` (up to the
Laplacian sweep's launch), `k3` and `update`. STEP_STAMPS lists each
step's stamps in order. No time is charged before a
unit's first stamp. The host reads the buffer once a unit, at the unit
span's end, after the unit's own final sync.
"""

from __future__ import annotations

import ctypes
import json
import os
import time
from contextlib import contextmanager, nullcontext

import torch

from ..ops import cuda_lib

SLOTS = ("off_step", "bookkeeping", "shape_matching", "gathers", "k1", "k2",
         "apply", "reaction", "k3", "update")
# the slots a step stamps, in the order it stamps them
STEP_STAMPS = {
    "v4": ("off_step", "bookkeeping", "shape_matching", "gathers", "k1",
           "gathers", "k2", "apply"),
    "wave": ("off_step", "reaction", "k3", "update"),
}
_SLOT = {s: i for i, s in enumerate(SLOTS)}
# the stamp buffer's element that holds the previous stamp's time (0: none)
_LAST = len(SLOTS)
DEVICE_COUNTERS = ("tracing.stamps",)

_on = False
_store = None
# device -> the int64 stamp buffer, kept for the process: a captured graph
# holds its address
_acc: dict = {}
_OFF = nullcontext()


class Store:
    """What one `enabled()` block recorded."""

    def __init__(self):
        # dicts of name, start, end (ns), parent (index into spans or
        # None), unit (id or None) and attrs
        self.spans: list = []
        self.counters: dict = {}
        self.units: dict = {}       # unit id -> {slot: ns}
        self.open: list = []        # indices of the open spans
        self.unit = None            # the open unit's id
        self.cpu = [0] * (_LAST + 1)


def on() -> bool:
    """Whether tracing is on."""
    return _on


@contextmanager
def enabled():
    """Trace the block into a new store (yielded); inside an enabled block,
    the same store. The store stays readable after the block."""
    global _on, _store
    if _on:
        yield _store
        return
    _store = Store()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _buffer(torch.device("cuda", torch.cuda.current_device()))
    _on = True
    try:
        yield _store
    finally:
        _on = False


def _buffer(device) -> torch.Tensor:
    """The stamp buffer of a CUDA device, made on first use (never inside a
    capture: a graph must not own it)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    acc = _acc.get(device)
    if acc is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"tracing: no stamp buffer on {device} yet; "
                               "stamp there once outside a capture first")
        acc = _acc[device] = torch.zeros(_LAST + 1, dtype=torch.int64,
                                         device=device)
    return acc


class _Span:
    __slots__ = ("name", "unit", "attrs", "index", "starts_unit", "rf")

    def __init__(self, name: str, unit: bool, attrs: dict):
        self.name, self.unit, self.attrs = name, unit, attrs

    def __enter__(self):
        st = _store
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        self.starts_unit = self.unit and st.unit is None
        if self.starts_unit:
            st.unit = len(st.units)
            st.units[st.unit] = {}
            _zero_stamps(st)
        self.index = len(st.spans)
        st.spans.append({"name": self.name, "start": time.perf_counter_ns(),
                         "end": None,
                         "parent": st.open[-1] if st.open else None,
                         "unit": st.unit, "attrs": self.attrs})
        st.open.append(self.index)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        st = _store
        st.spans[self.index]["end"] = end
        st.open.pop()
        if self.starts_unit:
            if exc[0] is None:
                st.units[st.unit] = self.attrs["stamps"] = _read_stamps(st)
            st.unit = None
        self.rf.__exit__(*exc)
        return False


def span(name: str, unit: bool = False, **attrs):
    """A context manager that records a span while tracing is on (a shared
    no-op context otherwise). `unit=True` starts a unit if none is open.
    `attrs` are kept with the span."""
    return _Span(name, unit, attrs) if _on else _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while tracing is on."""
    if _on:
        c = _store.counters
        c[name] = c.get(name, 0) + n


def read_device_counters() -> tuple:
    """The values of DEVICE_COUNTERS, in order (models/scan.py)."""
    c = _store.counters if _store is not None else {}
    return tuple(c.get(n, 0) for n in DEVICE_COUNTERS)


def add_device_counters(delta) -> None:
    """Add the last len(DEVICE_COUNTERS) values of `delta` to those
    counters while tracing is on (models/scan.py: a capture takes off what
    it counted, a replay adds it)."""
    if _on:
        for name, d in zip(DEVICE_COUNTERS, delta[-len(DEVICE_COUNTERS):]):
            if d:
                count(name, d)


def stamp(slot: str, device) -> None:
    """Charge the time since the device's previous stamp to `slot`."""
    if not _on:
        return
    i = _SLOT[slot]
    if device.type != "cuda":
        buf, now = _store.cpu, time.perf_counter_ns()
        if buf[_LAST]:
            buf[i] += now - buf[_LAST]
        buf[_LAST] = now
        return
    acc = _buffer(device)
    rc = cuda_lib.load().sph_stamp(acc.data_ptr(), i, _LAST,
                                   torch.cuda.current_stream(device)
                                   .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sph_stamp: CUDA error {rc} "
                           f"({cuda_lib.error_string(rc)})")
    count("tracing.stamps")


def _zero_stamps(st: Store) -> None:
    for acc in _acc.values():
        acc.zero_()
    st.cpu[:] = [0] * (_LAST + 1)


def _read_stamps(st: Store) -> dict:
    total = list(st.cpu[:_LAST])
    for acc in _acc.values():
        for i, v in enumerate(acc.tolist()[:_LAST]):
            total[i] += v
    return {s: total[i] for i, s in enumerate(SLOTS) if total[i]}


def stamps() -> dict:
    """{slot: ns} of the last unit that ended (empty if none)."""
    if _store is None or not _store.units:
        return {}
    return _store.units[len(_store.units) - 1]


def spans() -> list:
    """The recorded spans (dicts: name, start, end, parent, unit, attrs)."""
    return _store.spans if _store is not None else []


def snapshot() -> dict:
    """Every counter by name: the kernel launch counters
    (`<module>.<wrapper>.<attribute>`) and the store's."""
    out = {f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}.{attr}":
           getattr(fn, attr) for fn, attr in cuda_lib.launch_counters()}
    if _store is not None:
        out.update(_store.counters)
    return out


def graph_nodes(graph) -> dict:
    """{"kernel", "memcpy", "memset": nodes} of a torch.cuda.CUDAGraph
    captured with keep_graph=True, child graphs included: the kernels are
    every kernel one replay launches."""
    n = (ctypes.c_int * 3)()
    rc = cuda_lib.load().sph_graph_nodes(graph.raw_cuda_graph(),
                                         ctypes.addressof(n))
    if rc != 0:
        raise RuntimeError(f"sph_graph_nodes: CUDA error {rc} "
                           f"({cuda_lib.error_string(rc)})")
    return dict(zip(("kernel", "memcpy", "memset"), n))


def export(path) -> None:
    """Write the recorded spans as a Chrome trace (chrome://tracing,
    Perfetto): complete events in microseconds of perf_counter, with each
    span's index, parent, unit and attributes under `args`."""
    events = []
    pid = os.getpid()
    for i, s in enumerate(spans()):
        if s["end"] is None:
            continue
        events.append({"name": s["name"], "ph": "X", "pid": pid, "tid": 0,
                       "ts": s["start"] / 1e3,
                       "dur": (s["end"] - s["start"]) / 1e3,
                       "args": dict(s["attrs"], id=i, parent=s["parent"],
                                    unit=s["unit"])})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)
