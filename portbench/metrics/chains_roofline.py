"""The recurrence chains' share of their roofline in the traced trial
(``lstm_fwd.cu``: decoder and multi-cell forward; ``lstm_bwd.cu``: their
backward): the least time of the work they must do
(``counts/kernels.py``, family ``chains``) over their device time."""

from portbench.counts import kernels

KERNELS = ("lstm_chain_fwd_kernel", "lstm_chain_bwd_kernel")


def read(ctx):
    return kernels.roofline_share(ctx, "chains", KERNELS)
