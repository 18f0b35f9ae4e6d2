"""K3 (`sweep_lap3`) inside the real step: the least time the card could
take at the cell's own inputs (benchmark/flops.py) over K3's device stamp
slot a step in one traced unit, in % (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "k3_span_roofline")
