"""Memory Fusion Network parameters (port of ``factorized_tpu/ops/mfn.py``).

Only ``mfn_init`` is ported: the MFN's forward runs inside the fused
encode (``ops/fused.py::fused_mfm_encode``). The modular ``mfn_apply``
comes with the modular path.
"""

from __future__ import annotations

from factorized_tpu_torch.ops.core import mlp2_init
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
