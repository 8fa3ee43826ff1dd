"""The encode kernels' share of their roofline in the traced trial: the
least time of the work they must do (``counts/kernels.py``, family
``encode``) over their device time in the trace."""

from portbench.counts import kernels

KERNELS = ("cell_chains_fwd_kernel", "product_fwd_kernel",
           "softmax_fwd_kernel", "mem_chain_fwd_kernel", "gates_kernel",
           "mem_chain_kernel", "recompute_att_kernel", "product_kernel",
           "softmax_bwd_kernel", "lstm_chains_kernel",
           "mfm_encode_dw_kernel")


def read(ctx):
    return kernels.roofline_share(ctx, "encode", KERNELS)
