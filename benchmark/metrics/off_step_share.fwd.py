"""The device wall between steps (the `off_step` stamp slot: idle, the
state's copies, the host) over every stamped slot of one traced unit, in
%, with no profiler (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(job):
    return program_trace.reading(job, "off_step_share")
