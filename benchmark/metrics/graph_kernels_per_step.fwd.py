"""Kernel nodes of the replayed step graph (the run loop's
`scan.graph_kernels`, counted from the captured graph, aten kernels
included, stamps left out) over the steps it holds, over one traced
unit's replays (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "graph_kernels_per_step")
