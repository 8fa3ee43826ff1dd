"""Block-diagonal fusion of independent LSTM recurrences (port of
``factorized_tpu/ops/fused.py``).

k independent cells run as one recurrence over the concatenated state,
with a gate-major layout ``[i of all cells | f | g | o]``, so one
block-diagonal product per step serves them all. Weights stay per cell
in the parameter tree; the training forward assembles the packed
matrices per call (its gradients flow through them), the serving forward
once (``models/predict.py``, with ``input_projection``). The
hoisted input projections and the output projections are plain
``torch.matmul``; the recurrences run in the CUDA kernels of
``ops/cuda_mfn.py`` and ``ops/cuda_lstm.py`` (their plain versions on
the CPU), behind ``torch.autograd.Function``s with hand-written
backward kernels.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
from factorized_tpu_torch.ops.core import rate_active
from factorized_tpu_torch.ops.lstm import lstm_step


def blockdiag(mats: Sequence[torch.Tensor], cols: Sequence[int]):
    """Block-diagonal assembly: block m at rows after block m-1's and
    columns ``cols[:m]`` onwards."""
    c_tot = sum(cols)
    strips = []
    c = 0
    for m, cc in zip(mats, cols):
        strips.append(F.pad(m, (c, c_tot - c - cc)))
        c += cc
    return torch.cat(strips, dim=0)


def gate_major_blockdiag(mats: Sequence[torch.Tensor],
                         h_dims: Sequence[int]):
    """Per-cell (d_i, 4*h_i) weights -> (sum_d, 4*sum_h) block-diagonal
    with gate-major columns."""
    h_tot = sum(h_dims)
    strips = []
    col = 0
    for m, h in zip(mats, h_dims):
        gates = [F.pad(m[:, g * h:(g + 1) * h], (col, h_tot - col - h))
                 for g in range(4)]
        strips.append(torch.cat(gates, dim=1))
        col += h
    return torch.cat(strips, dim=0)


def gate_major_bias(biases: Sequence[torch.Tensor], h_dims: Sequence[int]):
    parts = []
    for g in range(4):
        parts.extend(b[g * h:(g + 1) * h] for b, h in zip(biases, h_dims))
    return torch.cat(parts)


def repack_gate_major(xprojs: Sequence[torch.Tensor],
                      h_dims: Sequence[int]):
    """Per-cell projections (t, n, 4*h_i) -> (t, n, 4*sum_h) gate-major."""
    parts = []
    for g in range(4):
        parts.extend(xp[..., g * h:(g + 1) * h]
                     for xp, h in zip(xprojs, h_dims))
    return torch.cat(parts, dim=-1)


def hoist_xproj(cell, x):
    t, n, d = x.shape
    h4 = cell["wx"].shape[1]
    return (x.reshape(t * n, d) @ cell["wx"]).reshape(t, n, h4) + cell["b"]


def split_heads(h_cat, h_dims: Sequence[int]) -> List[torch.Tensor]:
    outs = []
    o = 0
    for h in h_dims:
        outs.append(h_cat[..., o:o + h])
        o += h
    return outs


def lstm_operands(cells: Sequence[dict], xs: Sequence[torch.Tensor]):
    """What the fused encoder-cell kernel takes for k independent cells
    ({'wx', 'wh', 'b'}) over the (t, n, d_i) inputs ``xs``: (xp, wh,
    h_dims), the gate-major input projections (t, n, 4H), bias included,
    and the block-diagonal recurrent weight (H, 4H)."""
    h_dims = [c["wh"].shape[0] for c in cells]
    xp = repack_gate_major(
        [hoist_xproj(c, x) for c, x in zip(cells, xs)], h_dims)
    wh = gate_major_blockdiag([c["wh"] for c in cells], h_dims)
    return xp, wh, h_dims


def fused_lstm_scan(cells: Sequence[dict], xs: Sequence[torch.Tensor]):
    """k independent LSTMs as one recurrence from a zero state. Returns
    the last hidden states [(n, h_i)]."""
    xp, wh, h_dims = lstm_operands(cells, xs)
    return split_heads(cuda_lstm.multi_lstm(xp, wh, h_dims), h_dims)


def decoder_operands(dec_params: Sequence[dict],
                     hTs: Sequence[torch.Tensor]):
    """What the decoder kernel takes: the state after the latent-driven
    step 0, and the packed recurrence. Returns (h0, c0, wsum, b, h_dims)
    with wsum = wx + wh block-diagonal, gate-major, and b (1, 4H)."""
    cells = [p["lstm"] for p in dec_params]
    h_dims = [c["wh"].shape[0] for c in cells]
    n = hTs[0].shape[0]
    # step 0: input hT, state 0 — the h @ wh term vanishes
    wx_bd = gate_major_blockdiag([c["wx"] for c in cells], h_dims)
    b_cat = gate_major_bias([c["b"] for c in cells], h_dims)
    hT_cat = torch.cat(list(hTs), dim=1)
    h0, c0 = lstm_step(hT_cat.new_zeros((n, sum(h_dims))),
                       hT_cat @ wx_bd + b_cat)
    # steps >= 1: input == previous hidden -> one (wx + wh) product
    wsum = gate_major_blockdiag([c["wx"] + c["wh"] for c in cells], h_dims)
    return (h0.contiguous(), c0.contiguous(), wsum, b_cat.reshape(1, -1),
            h_dims)


def fused_decoder_scan(dec_params: Sequence[dict],
                       hTs: Sequence[torch.Tensor], t: int):
    """k autoregressive decoders as one recurrence plus one block output
    projection. dec_params: [{'lstm': cell, 'fc1': linear}]; hTs: the
    (n, h_i) latents. Returns the (t, n, d_i) reconstructions."""
    h0, c0, wsum, b, h_dims = decoder_operands(dec_params, hTs)
    n, h_tot = h0.shape
    if t > 1:
        all_h = cuda_lstm.decoder_lstm(h0, c0, wsum, b, t, h_dims)
    else:
        all_h = h0[None]

    d_dims = [p["fc1"]["w"].shape[1] for p in dec_params]
    w_out = blockdiag([p["fc1"]["w"] for p in dec_params], d_dims)
    b_out = torch.cat([p["fc1"]["b"] for p in dec_params])
    recon = (all_h.reshape(t * n, h_tot) @ w_out + b_out).reshape(
        t, n, sum(d_dims))
    return split_heads(recon, d_dims)


def encode_operands(enc_cells, mfn_params, x_l, x_a, x_v, enc_xs=None):
    """What the encode kernel takes for k encoder cells (k = 0, 1 or 3)
    and the MFN. The fused carry is ordered [the k encoder cells, mfn_l,
    mfn_a, mfn_v], so the MFN's cStar is the ``[:, z_tot:]`` slice of the
    fused cell state, z_tot the encoder cells' widths summed.
    ``enc_xs`` are the encoder cells' (t, n, d_i) inputs, by default the
    three modalities (MFM's unimodal encoders). Returns (xp, weights,
    z_tot, h_dims): the gate-major input projections (t, n, 4H) and the
    packed weights of ``cuda_mfn.W_NAMES``."""
    if enc_xs is None:
        enc_xs = (x_l, x_a, x_v)
    if len(enc_xs) != len(enc_cells):
        raise ValueError(f"{len(enc_cells)} encoder cells, {len(enc_xs)} "
                         f"inputs")
    cells = encode_cells(enc_cells, mfn_params)
    xs = [*enc_xs, x_l, x_a, x_v]
    h_dims = [c["wh"].shape[0] for c in cells]
    xp = repack_gate_major(
        [hoist_xproj(c, x) for c, x in zip(cells, xs)], h_dims)
    z_tot = sum(h_dims[:len(enc_cells)])
    return xp, encode_weights(cells, mfn_params), z_tot, h_dims


def encode_cells(enc_cells, mfn_params):
    """The LSTM cells of the fused encode, in the carry's order: the
    encoder cells, then the MFN's l, a and v cells."""
    return list(enc_cells) + [mfn_params["lstm_l"], mfn_params["lstm_a"],
                              mfn_params["lstm_v"]]


def encode_weights(cells, mfn_params):
    """The encode kernel's packed weights of ``cuda_mfn.W_NAMES`` for the
    ``encode_cells`` and the MFN's attention and gamma MLPs, biases
    ``(1, d)``, each contiguous."""
    h_dims = [c["wh"].shape[0] for c in cells]

    def b2(p):
        return p["b"].reshape(1, -1)

    att1, att2 = mfn_params["att1"], mfn_params["att2"]
    gam1, gam2 = mfn_params["gamma1"], mfn_params["gamma2"]
    weights = {
        "wh": gate_major_blockdiag([c["wh"] for c in cells], h_dims),
        "a1w1": att1["fc1"]["w"], "a1b1": b2(att1["fc1"]),
        "a1w2": att1["fc2"]["w"], "a1b2": b2(att1["fc2"]),
        "a2w1": att2["fc1"]["w"], "a2b1": b2(att2["fc1"]),
        "a2w2": att2["fc2"]["w"], "a2b2": b2(att2["fc2"]),
        # gamma1 and gamma2 share their input: fc1s side by side
        "gw1": torch.cat([gam1["fc1"]["w"], gam2["fc1"]["w"]], dim=1),
        "gb1": torch.cat([b2(gam1["fc1"]), b2(gam2["fc1"])], dim=1),
        "g1w2": gam1["fc2"]["w"], "g1b2": b2(gam1["fc2"]),
        "g2w2": gam2["fc2"]["w"], "g2b2": b2(gam2["fc2"]),
    }
    return {k: v.contiguous() for k, v in weights.items()}


def input_projection(cells, rows, d_in: int):
    """The input projections of k cells as one product: a gate-major
    ``(d_in, 4H)`` block matrix, cell k's ``wx`` at the input rows
    ``rows[k]`` (a ``(start, stop)`` range of the input's last axis) and
    at its own columns of each gate, zeros elsewhere, and the gate-major
    ``(4H,)`` bias; so ``x @ w + b`` over the whole input equals the k
    hoisted projections repacked (``hoist_xproj``, ``repack_gate_major``)
    but for the zero blocks' exact zeros in the sums."""
    h_dims = [c["wh"].shape[0] for c in cells]
    H = sum(h_dims)
    w = cells[0]["wx"].new_zeros((d_in, 4 * H))
    o = 0
    for cell, (r0, r1), h in zip(cells, rows, h_dims):
        for g in range(4):
            w[r0:r1, g * H + o:g * H + o + h] = \
                cell["wx"][:, g * h:(g + 1) * h]
        o += h
    return w, gate_major_bias([c["b"] for c in cells], h_dims)


def fused_mfm_encode(enc_cells, mfn_params, x_l, x_a, x_v, *, mem_dim,
                     drops, train=False, generator=None, masks=None,
                     bwd_variant="stream", enc_xs=None):
    """The encode stage — k encoder LSTMs (``enc_cells`` over ``enc_xs``,
    by default MFM's three unimodal encoders over the modalities), the
    MFN's 3 modality LSTMs and the delta-memory attention — as one
    recurrence; with no encoder cell it is the MFN alone
    (``ops.mfn.mfn_apply``). In train mode with a site among ``drops``
    (att1, att2, gamma1, gamma2) that runs (``core.rate_active``: a float
    above 0, or a lane's tensor rate) the dropout masks are ``masks``
    when handed in (the injection point), else drawn from ``generator``
    by ``cuda_mfn.make_dropout_masks``. Gradients reach the per-cell
    weights through the packing, which is plain PyTorch; ``bwd_variant``
    picks the encode's reverse kernel (``cuda_mfn.BWD_VARIANTS``).
    Returns ([the k encoders' last h], mfn_last_hs)."""
    xp, weights, z_tot, h_dims = encode_operands(enc_cells, mfn_params,
                                                 x_l, x_a, x_v, enc_xs)
    if any(rate_active(d, train) for d in drops):
        if masks is None:
            if generator is None:
                raise ValueError("train-mode encode needs a torch.Generator "
                                 "or masks")
            t, n, _ = xp.shape
            masks = cuda_mfn.make_dropout_masks(
                generator, t, n, cuda_mfn.sizes(weights)[:4], drops)
    else:
        masks = None
    h_last, mem = cuda_mfn.encode(xp, weights, z_tot, h_dims, masks,
                                  variant=bwd_variant)
    if mem.shape[1] != mem_dim:
        raise ValueError(f"memory width {mem.shape[1]} != mem_dim {mem_dim}")
    enc_hs = split_heads(h_last[:, :z_tot], h_dims[:len(enc_cells)])
    return enc_hs, torch.cat([h_last[:, z_tot:], mem], dim=1)
