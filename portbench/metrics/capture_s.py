"""Seconds a trial spends capturing its epoch's CUDA graph: the
program's ``graph.capture`` spans (``train.Graphed``: prepare, record,
instantiate) inside the window's trials, over the window's trials (a
bucket of lanes is one trial)."""

from portbench.harness.spans import in_window, seconds


def read(ctx):
    spans = in_window(ctx, "graph.capture")
    if not spans or not ctx.trials:
        return None
    return sum(seconds(s) for s in spans) / ctx.trials
