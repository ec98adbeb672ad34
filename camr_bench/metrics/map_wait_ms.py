"""Mean milliseconds a step in which the host was blocked in the map's
uploads of its batches (a copy from pageable memory returns once the
card's stream has drained): the host clock inside the span
``map.upload`` of every map call, summed
(``CAMRTrainReport.phase_ms``). None where the program records no such
span."""

PART = "map.upload:host"


def read(ctx):
    if not ctx.phase_ms or any(PART not in ms for ms in ctx.phase_ms):
        return None
    return ctx.phase_mean(PART)
