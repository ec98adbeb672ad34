"""The whole step's share of the card's dense bf16 peak: the step's
model FLOPs over the mean step time of the window (host clock)."""


def read(ctx):
    if ctx.peak_flops is None:
        return None
    return 100.0 * ctx.step_flops / (ctx.window_s / ctx.steps
                                     * ctx.peak_flops)
