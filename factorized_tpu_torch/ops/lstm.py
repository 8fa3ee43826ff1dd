"""LSTM cell, encoder and autoregressive decoder (port of
``factorized_tpu/ops/lstm.py``).

Gate order is [i, f, g, o] along the 4h axis; one summed bias stands
for torch's ``b_ih + b_hh``. ``nn.LSTM`` is not used: its ``(4h, d)``
weights and two biases would break the shared parameter tree.
"""

from __future__ import annotations

import torch

from factorized_tpu_torch.ops.core import (linear_apply, linear_init,
                                           uniform_fan_in)


def lstm_cell_init(generator, d: int, h: int):
    """One LSTM cell: wx (d, 4h), wh (h, 4h), b (4h). The bias is the
    sum of two independent uniforms, like torch's ``b_ih + b_hh``."""
    return {
        "wx": uniform_fan_in(generator, (d, 4 * h), h),
        "wh": uniform_fan_in(generator, (h, 4 * h), h),
        "b": uniform_fan_in(generator, (4 * h,), h)
        + uniform_fan_in(generator, (4 * h,), h),
    }


def lstm_step(c_prev, gates):
    """Element-wise gate math on pre-activation gates [i, f, g, o]."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def recurrent_weight_grad(allh, dgates):
    """dWh = sum_{i >= 1} h_{i-1}^T dgates_i over a zero-state recurrence
    with all hidden states ``allh (t, n, H)`` and gate gradients
    ``dgates (t, n, 4H)``: one product, zero when t == 1."""
    t, n, H = allh.shape
    if t == 1:
        return allh.new_zeros((H, 4 * H))
    return allh[:-1].reshape(-1, H).T @ dgates[1:].reshape(-1, 4 * H)


def lstm_scan(cell, x):
    """LSTM over time-major ``x (t, n, d)`` with the input projection
    hoisted into one matmul. Returns (all_h, last_h, last_c)."""
    t, n, d = x.shape
    h_dim = cell["wh"].shape[0]
    xproj = (x.reshape(t * n, d) @ cell["wx"]).reshape(t, n, 4 * h_dim) \
        + cell["b"]
    h = x.new_zeros((n, h_dim))
    c = x.new_zeros((n, h_dim))
    all_h = []
    for i in range(t):
        h, c = lstm_step(c, xproj[i] + h @ cell["wh"])
        all_h.append(h)
    return torch.stack(all_h), h, c


def encoder_init(generator, d: int, h: int):
    return {
        "lstm": lstm_cell_init(generator, d, h),
        "fc1": linear_init(generator, h, h),
    }


def encoder_apply(params, x):
    """x (t, n, d) -> latent (n, h): fc1 of the last hidden state."""
    _, h_last, _ = lstm_scan(params["lstm"], x)
    return linear_apply(params["fc1"], h_last)


def decoder_init(generator, h: int, d: int):
    return {
        "lstm": lstm_cell_init(generator, h, h),
        "fc1": linear_init(generator, h, d),
    }


def decoder_apply(params, hT, t: int):
    """Autoregressive decode: hT (n, h) -> reconstructions (t, n, d).

    Step 0 takes the latent with a zero state; every later step's input
    is the previous hidden state, so its two matmuls fuse into one
    against ``wx + wh``."""
    cell = params["lstm"]
    n, h_dim = hT.shape
    h, c = lstm_step(hT.new_zeros((n, h_dim)), hT @ cell["wx"] + cell["b"])
    w_sum = cell["wx"] + cell["wh"]
    all_h = [h]
    for _ in range(t - 1):
        h, c = lstm_step(c, h @ w_sum + cell["b"])
        all_h.append(h)
    all_h = torch.stack(all_h)
    d_out = params["fc1"]["w"].shape[1]
    return linear_apply(params["fc1"], all_h.reshape(t * n, h_dim)).reshape(
        t, n, d_out)
