"""Share of the traced window in which no operation ran on the card
(the profiler's trace). It reads ``device.idle_share.serve`` and
``device.idle_share.train`` alike: one quantity, named for the
end-to-end metric it moves in each kind of cell."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
