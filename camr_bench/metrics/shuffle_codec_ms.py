"""Mean milliseconds a step of the shuffle's XOR codec: the device ms
of the spans ``shuffle.encode`` and ``shuffle.decode`` of both coded
stages, summed (``CAMRTrainReport.phase_ms``). The rest of
``shuffle_ms`` is glue: the wire buffer, the exchange, stage 3 and the
assembly. None where the program records no such spans."""

PARTS = ("shuffle.encode", "shuffle.decode")


def read(ctx):
    if not ctx.phase_ms or any(p not in ms for ms in ctx.phase_ms
                               for p in PARTS):
        return None
    return sum(ctx.phase_mean(p) for p in PARTS)
