"""The host's time in `graph.replay()` (the run loop's `scan.replay` span),
microseconds a replay, the mean over one traced unit
(benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "replay_enqueue_us")
