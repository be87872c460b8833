"""Seconds from the process's start to the first timed request or
step: weights, builds, captures and warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
