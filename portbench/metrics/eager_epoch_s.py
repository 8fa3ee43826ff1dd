"""Seconds a trial spends in its eager first epoch: the program's
``graph.eager`` spans (``train.Graphed``'s warm-up call, the host's time
to queue it) inside the window's trials, over the window's trials."""

from portbench.harness.spans import in_window, seconds


def read(ctx):
    spans = in_window(ctx, "graph.eager")
    if not spans or not ctx.trials:
        return None
    return sum(seconds(s) for s in spans) / ctx.trials
