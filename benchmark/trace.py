"""Device time from torch.profiler and CUDA events, for the traced run.

The profiler's timeline is used for what ran on the device (the union of
its operations' intervals, by name) and for what the host was doing in the
device's longest idle gaps. It is never the wall a share is taken of: its
tracing of a graph's many nodes opens gaps of its own, so the wall of the
same steps comes from CUDA events around an unprofiled pass.
"""

from __future__ import annotations

import time

import torch

TOP = 10


def union(spans) -> tuple:
    """(busy, merged) of (start, end) spans: the length of their union and
    the merged, sorted intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def gaps(merged, host, top: int = TOP) -> list:
    """The `top` longest gaps between merged device intervals, each named
    by the innermost host operation running at its start: [name, seconds]
    with times in microseconds in, seconds out."""
    longest = sorted(((b - a, a) for (_, a), (b, _) in zip(merged,
                                                          merged[1:])
                      if b > a), reverse=True)[:top]
    out = []
    for length, a in longest:
        name, best = "idle host", None
        for s, e, nm in host:
            if s <= a < e and (best is None or e - s < best):
                name, best = nm, e - s
        out.append([name, length * 1e-6])
    return out


def event_wall(run, device) -> float:
    """Seconds of run() between two CUDA events on the current stream."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    t0.record()
    run()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) * 1e-3


def kernel_seconds(launch, device, count: int = 200) -> float:
    """Seconds a launch of `launch()`: CUDA events around the replay of a
    captured graph of `count` launches (no host launch cost between
    them), after ten warm-up launches and one warm-up replay."""
    for _ in range(10):
        launch()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            launch()
    graph.replay()
    return event_wall(graph.replay, device) / count


def profile(run, device) -> dict:
    """run() under torch.profiler (CPU and CUDA activity), then: busy_s
    (the union of the device operations' intervals), window_s (the host
    wall of the profiled call), ops (device seconds by operation name, the
    `TOP` largest), idle_gaps, and the count of device operations."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev_t = torch.autograd.DeviceType.CUDA
    spans, host, by_name = [], [], {}
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == dev_t:
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) * 1e-6
        else:
            host.append((a, b, e.name))
    busy, merged = union(spans)
    ops = sorted(([k[:120], v] for k, v in by_name.items()),
                 key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy * 1e-6, "window_s": window, "ops": ops,
            "idle_gaps": gaps(merged, host), "count": len(spans)}
