"""The window's counted operations a step (fwd) over its wall a step, as a
share (%) of the card's float32 peak (benchmark/flops.py)."""


def read(job):
    return job.step_mfu("fwd")
