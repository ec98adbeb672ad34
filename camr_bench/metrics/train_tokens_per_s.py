"""Tokens trained per second over the whole window: every token of
every step that started in it (J jobs x N subfiles x rows x length a
step) over the time from the first step's start to the last step's end,
the device synchronised."""


def read(ctx):
    return ctx.steps * ctx.tokens_per_step / ctx.window_s
