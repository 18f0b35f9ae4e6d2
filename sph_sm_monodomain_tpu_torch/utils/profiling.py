"""Profiling helpers: torch.profiler traces and chained per-step wall time
(mirror of `sph_sm_monodomain_tpu.utils.profiling`).

Phase-level numbers come from utils/report.profile_phases*; this module
adds whole-program traces and wall-time measurement of the dispatched path.
torch.profiler may drop the events of the ctypes-launched sweep kernels,
so time those with CUDA events (utils/report), not with a trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str = "sphsm_trace"):
    """Capture a torch.profiler trace of the block (CPU, and CUDA when torch
    sees a GPU) and write it as a Chrome trace, `log_dir`/trace.json
    (open in chrome://tracing or Perfetto). Yields the directory."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(st) -> float:
    """Wait for the card (when `st` lives there) and fetch one value of
    `st.pos` to the host: the end of every timed region."""
    if st.pos.is_cuda:
        torch.cuda.synchronize(st.pos.device)
    return float(st.pos[0, 0])


def time_chained(step_fn, state, steps: int = 50):
    """Per-step wall time of `steps` chained dependent calls (each call's
    input is the previous output, so no caching can hide work), after one
    warm-up call, ended with `sync` (torch.cuda.synchronize and a host
    fetch when the state is on the card).

    Each call pays its launch overhead, so this measures the dispatched
    path, not device time alone.

    Returns (seconds_per_step, final_state).
    """
    out = step_fn(state)
    sync(out[0] if isinstance(out, tuple) else out)

    st = state
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step_fn(st)
        st = out[0] if isinstance(out, tuple) else out
    sync(st)
    return (time.perf_counter() - t0) / steps, st
