"""Share of the traced sub-window in which no operation ran on the device
(the union of the profiler's device intervals), in percent."""


def read(ctx, name):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
