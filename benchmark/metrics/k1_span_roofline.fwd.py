"""K1 (`sweep_a3`) inside the real step: the least time the card could take
at the cell's own inputs (benchmark/flops.py) over K1's device stamp slot
a step in one traced unit, in % (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "k1_span_roofline")
