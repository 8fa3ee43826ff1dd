"""Memory Fusion Network (port of ``factorized_tpu/ops/mfn.py``).

Two forms of the same recurrence:

- ``mfn_apply`` is the fused encode with no encoder cell
  (``ops/fused.py::fused_mfm_encode``): the MFN's three modality LSTMs,
  the delta-memory attention and the memory update as one recurrence, the
  encode kernel of ``ops/cuda_mfn.py`` on the card, its plain version on
  the CPU;
- ``mfn_scan`` is the modular recurrence, the JAX package's
  ``mfn_apply`` (``factorized_tpu/ops/mfn.py:60-139``): three hoisted
  input products, then a loop over the steps of plain PyTorch (the
  three cells' ``h @ W_h`` and gate math, the softmax attention over
  cStar, the tanh proposal, the two sigmoid gates and the memory
  update). The MFM family runs it above the FLOPs crossover
  (``models/mfm.py::fused_active``).
"""

from __future__ import annotations

import torch

from factorized_tpu_torch.ops import cuda_mfn
from factorized_tpu_torch.ops.core import mlp2_apply, mlp2_init, rate_active
from factorized_tpu_torch.ops.fused import (fused_mfm_encode, hoist_xproj,
                                            split_heads)
from factorized_tpu_torch.ops.lstm import lstm_cell_init, lstm_step

# the MLP sites of the step, in the order of their dropout masks
SITES = ("att1", "att2", "gamma1", "gamma2")


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


def mfn_scan(params, x_l, x_a, x_v, *, mem_dim: int, drops, train=False,
             generator=None, masks=None):
    """The modular recurrence of ``mfn_apply``, with its contract: x_m
    time-major (t, n, d_m) -> ``[h_l, h_a, h_v, mem]`` (n, sum(h_dims) +
    mem), the same dropout ``masks`` (t, n, att1 + att2 + gamma1 + gamma2
    widths), drawn by ``cuda_mfn.make_dropout_masks`` from ``generator``
    when not handed in, so a run's draws do not depend on the path. A
    site whose rate is a float of 0 runs no dropout; a tensor rate (a
    lane's, under ``torch.func.vmap``) always runs its site."""
    t, n, _ = x_l.shape
    cells = [params["lstm_l"], params["lstm_a"], params["lstm_v"]]
    if params["att2"]["fc2"]["w"].shape[1] != mem_dim:
        raise ValueError(f"memory width {params['att2']['fc2']['w'].shape[1]}"
                         f" != mem_dim {mem_dim}")
    xps = [hoist_xproj(c, x) for c, x in zip(cells, (x_l, x_a, x_v))]
    active = [rate_active(d, train) for d in drops]
    site_masks = [None] * len(SITES)
    if any(active):
        widths = [params[k]["fc1"]["w"].shape[1] for k in SITES]
        if masks is None:
            if generator is None:
                raise ValueError("train-mode MFN needs a torch.Generator "
                                 "or masks")
            masks = cuda_mfn.make_dropout_masks(generator, t, n, widths,
                                                drops)
        site_masks = split_heads(masks, widths)

    def mlp(i, x, s):
        return mlp2_apply(params[SITES[i]], x, drop=drops[i], train=train,
                          mask=site_masks[i][s] if active[i] else None)

    hs = [x_l.new_zeros((n, c["wh"].shape[0])) for c in cells]
    cs = [x_l.new_zeros((n, c["wh"].shape[0])) for c in cells]
    mem = x_l.new_zeros((n, mem_dim))
    for s in range(t):
        new = [lstm_step(c, xp[s] + h @ cell["wh"])
               for cell, xp, h, c in zip(cells, xps, hs, cs)]
        c_star = torch.cat([*cs, *(c for _, c in new)], dim=1)
        hs = [h for h, _ in new]
        cs = [c for _, c in new]
        attended = torch.softmax(mlp(0, c_star, s), dim=1) * c_star
        c_hat = torch.tanh(mlp(1, attended, s))
        both = torch.cat([attended, mem], dim=1)
        g1 = torch.sigmoid(mlp(2, both, s))
        g2 = torch.sigmoid(mlp(3, both, s))
        mem = g1 * mem + g2 * c_hat
    return torch.cat([*hs, mem], dim=1)
