"""The map phase's share of the card's dense bf16 peak: the step's
model FLOPs (every one of them is in the map) over the mean map time."""


def read(ctx):
    ms = ctx.phase_mean("map")
    if ctx.peak_flops is None or not ms:
        return None
    return 100.0 * ctx.step_flops / (ms / 1e3 * ctx.peak_flops)
