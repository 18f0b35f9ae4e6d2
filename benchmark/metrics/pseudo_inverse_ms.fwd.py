"""The host's time in the 9 x 9 pseudo-inverse of the quadratic rest-shape
invariants (the `sm_invariants.pseudo_inverse` spans, one a `simulate`
call) in one traced unit, ms (benchmark/program_trace.py); None where the
package records no such span."""

from benchmark import program_trace

SPAN = "sm_invariants.pseudo_inverse"


def read(job):
    t = program_trace.get(job)
    got = [] if t is None else [s for s in t["spans"] if s["name"] == SPAN]
    if not got:
        return None
    return sum(s["end"] - s["start"] for s in got) / 1e6
