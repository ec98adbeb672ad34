"""Seconds from the process's start to the first timed step: imports,
the kernels' build or load, the weights, the trainer and its first
steps, less the time the correctness check spent reading the state."""


def read(ctx):
    return ctx.setup_s
