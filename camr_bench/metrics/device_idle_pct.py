"""The share of the traced sub-window in which no kernel, copy or set
ran on the device (the union of the profiler's device intervals)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_events:
        return None
    return 100.0 * ctx.trace.idle_share
