"""The host's time in the run loop's eager warm-up steps and graph captures
(the `scan.warmup` and `scan.capture` spans) in one traced unit, ms
(benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "rebuild_ms")
