"""Memory Fusion Network (port of ``factorized_tpu/ops/mfn.py``).

``mfn_apply`` is the fused encode with no encoder cell
(``ops/fused.py::fused_mfm_encode``): the MFN's three modality LSTMs,
the delta-memory attention and the memory update as one recurrence, the
encode kernel of ``ops/cuda_mfn.py`` on the card, its plain version on
the CPU.
"""

from __future__ import annotations

from factorized_tpu_torch.ops.core import mlp2_init
from factorized_tpu_torch.ops.fused import fused_mfm_encode
from factorized_tpu_torch.ops.lstm import lstm_cell_init


def mfn_init(generator, input_dims, h_dims, mem_dim: int, window_dim: int,
             att1_shape: int, att2_shape: int, gamma1_shape: int,
             gamma2_shape: int):
    d_l, d_a, d_v = input_dims
    dh_l, dh_a, dh_v = h_dims
    att_in = (dh_l + dh_a + dh_v) * window_dim
    gamma_in = att_in + mem_dim
    return {
        "lstm_l": lstm_cell_init(generator, d_l, dh_l),
        "lstm_a": lstm_cell_init(generator, d_a, dh_a),
        "lstm_v": lstm_cell_init(generator, d_v, dh_v),
        "att1": mlp2_init(generator, att_in, att1_shape, att_in),
        "att2": mlp2_init(generator, att_in, att2_shape, mem_dim),
        "gamma1": mlp2_init(generator, gamma_in, gamma1_shape, mem_dim),
        "gamma2": mlp2_init(generator, gamma_in, gamma2_shape, mem_dim),
    }


def mfn_apply(params, x_l, x_a, x_v, *, mem_dim: int, drops, train=False,
              generator=None, masks=None):
    """x_m time-major (t, n, d_m) -> last_hs ``[h_l, h_a, h_v, mem]``
    (n, sum(h_dims) + mem). ``drops`` are the rates of att1, att2, gamma1
    and gamma2; in train mode their dropout masks are ``masks`` (t, n,
    att1 + att2 + gamma1 + gamma2 widths, ``cuda_mfn.make_dropout_masks``)
    when handed in, else drawn from ``generator``."""
    _, last = fused_mfm_encode([], params, x_l, x_a, x_v, mem_dim=mem_dim,
                               drops=drops, train=train, generator=generator,
                               masks=masks, enc_xs=())
    return last
