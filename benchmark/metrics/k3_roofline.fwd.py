"""K3 (`sweep_lap3`) at the cell's own inputs: the least time the card
could take (benchmark/flops.py, from the pairs' geometry) over the measured
time of a launch, CUDA events over many launches, in %."""


def read(job):
    return job.kernel_roofline("sweep_lap3")
