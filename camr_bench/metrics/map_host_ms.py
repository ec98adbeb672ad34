"""Mean milliseconds a step in which the host issued the map's work: the
host clock inside the spans ``map.forward``, ``map.backward`` and
``map.row`` of every map call, summed (``CAMRTrainReport.phase_ms``).
Near ``map_ms``, the host sets the map's pace. None where the program
records no such spans."""

PARTS = ("map.forward:host", "map.backward:host", "map.row:host")


def read(ctx):
    if not ctx.phase_ms or any(p not in ms for ms in ctx.phase_ms
                               for p in PARTS):
        return None
    return sum(ctx.phase_mean(p) for p in PARTS)
