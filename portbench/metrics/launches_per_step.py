"""Launches of the port's hand-written kernels a train step: the
wrappers' counters (``ops.counts``; a replay adds what its capture
counted) over the window, summed over the per-wrapper totals (the
per-kernel breakdowns are subsets of them), over the window's train
steps (a lane step counts once)."""


def read(ctx):
    total = sum(v for v in ctx.launches.values() if isinstance(v, int))
    return total / ctx.steps if ctx.steps else None
