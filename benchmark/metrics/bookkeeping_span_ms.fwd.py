"""The bookkeeping stage of the v4 step (the sort and the windows), ms a
step: its device stamp slot in one traced unit of the cell's own work,
inside the captured graphs (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "bookkeeping_span_ms")
