"""The CUDA caching allocator's peak of allocated bytes over the
window (its statistics reset as the window opens), in GB (1e9 bytes)."""


def read(ctx):
    if ctx.window_peak_bytes is None:
        return None
    return ctx.window_peak_bytes / 1e9
