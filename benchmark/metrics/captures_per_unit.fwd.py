"""Graphs the run loop captured in one traced unit of the cell's own work
(its `scan.captures` counter; benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "captures_per_unit")
