"""Tokens of every optimizer step the window completed over the time
those steps took, the whole window end to end (host clock around steps
that end in a device synchronise)."""


def read(ctx):
    return ctx.steps * ctx.tokens_per_step / ctx.elapsed_s
