"""The shape matching stage of the v4 step, ms a step (the protocol cells'
incremental ablation of graphed chains, drivers/protocol.Job.stage_ms)."""


def read(job):
    return job.stage_ms("shape_matching")
