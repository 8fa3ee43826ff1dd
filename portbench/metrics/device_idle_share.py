"""The traced trial's share of wall time in which no kernel, copy or
fill ran on the device: 1 - the union of the trace's device intervals
over the traced trial's span."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
