"""The sweep stage of the v4 step, ms a step: the device stamp slots of the
sweeps' input gathers, K1, K2 and the apply (unsort) in one traced unit
of the cell's own work, inside the captured graphs
(benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "sweep_stage_span_ms")
