"""1 - the union of device operations' intervals (torch.profiler) over the
CUDA-event wall of the same stretch of the cell's work unprofiled, in %."""


def read(job):
    return job.idle_share()
