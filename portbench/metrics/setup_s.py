"""Set-up: process start to the first timed request or step (imports, the
kernels' build or load, weights, frames, warm-up)."""


def read(run):
    return run.setup_s
