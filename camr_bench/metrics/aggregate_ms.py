"""Mean milliseconds of the step's aggregate phase over the window's steps,
as the trainer's CUDA events between its phase marks time it
(``CAMRTrainReport.phase_ms``)."""


def read(ctx):
    return ctx.phase_mean("aggregate")
