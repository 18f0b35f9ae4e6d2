"""The shape matching stage of the v4 step (corrected_velocity: the moments
and the polar chain), ms a step: its device stamp slot in one traced unit
of the cell's own work, inside the captured graphs
(benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "shape_matching_span_ms")
