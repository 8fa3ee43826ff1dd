"""Nodes of the captured epoch graph a train step: the ``nodes``
attribute of the program's ``graph.capture`` spans in the window's
trials (the driver's count of the graph's kernels, copies, fills and
other nodes), over the epoch's train steps (``ctx.batches``; the
epoch's evaluation and bookkeeping included), averaged over the
window's captures (a lane step counts once)."""

from portbench.harness.spans import in_window


def read(ctx):
    spans = in_window(ctx, "graph.capture")
    if not spans or not ctx.batches:
        return None
    nodes = [s.attrs["nodes"] for s in spans]
    return sum(nodes) / len(nodes) / ctx.batches
