"""The whole train step's share of the card's float32 peak: the model
FLOPs of every lane's train steps in the window (the frozen closed-form
count, ``counts/model_flops.py``), over the window's seconds, over the
peak (``peaks.json``; the power limit is in the result's ``device``)."""

from portbench.counts.model_flops import train_step_flops


def read(ctx):
    if not ctx.peaks or not ctx.steps:
        return None
    flops = train_step_flops(ctx.config) * ctx.lanes * ctx.steps
    return 100.0 * flops / ctx.window_s / ctx.peaks["fp32_flops"]
