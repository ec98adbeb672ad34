"""The gradient sync's share of its roofline: the least bytes it must
move (each per-subfile gradient row read once in the sync dtype, the
f32 master and both moments read and written once) at the card's HBM
bandwidth, over the mean time of the aggregate, shuffle and update
phases together (so moving work between them cannot lift the share)."""


def read(ctx):
    ms = sum(ctx.phase_mean(p) for p in ("aggregate", "shuffle", "update"))
    if ctx.hbm_bytes_per_s is None or not ms:
        return None
    return 100.0 * ctx.sync_least_bytes / ctx.hbm_bytes_per_s / (ms / 1e3)
