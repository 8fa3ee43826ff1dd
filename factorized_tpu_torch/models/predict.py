"""The serving forward of the MFM family: ``y_hat`` alone, over operands
packed once (the port's counterpart of the JAX ``Predictor``'s jitted
forward, in which XLA folds the packing into constants and drops what
``y_hat`` does not read).

``y_hat = decoded[3]`` reads only the label path, so this forward runs
no MMD draw, no zl/za/zv heads, no decoder and, for ``missing``, no
surrogate encoder (its all-present decode reads the MFM encode alone):

- ``mfm``, ``kl``, ``missing``: one ``x @ Wx + b`` for the six encode
  cells' input projections (``ops.fused.input_projection``), the eval
  encode (``ftt::mfm_encode_eval``), ``mfn_enc.last_to_zy``, the zy -> fy
  MLP and the label head;
- ``kl_ef``: the early-fusion cell alone (its input projection, then
  ``ftt::multi_lstm_eval`` over that one cell), ``ef_encoder.fc1``,
  ``last_to_zy``, the zy -> fy MLP and the label head.

``YHat`` holds the operands as buffers, so ``torch.export`` carries them
inside the artifact; the two recurrences are custom ops, the kernels on
the card and their plain versions on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

# importing the two wrapper modules registers the ftt:: custom ops
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn  # noqa: F401
from factorized_tpu_torch.ops.fused import (encode_cells, encode_weights,
                                            input_projection)

# the model types whose y_hat this forward computes
FAMILIES = {"mfm": "encode", "kl": "encode", "missing": "encode",
            "kl_ef": "early_fusion"}
_ENCODERS = ("encoder_l", "encoder_a", "encoder_v")


def pack(params, cfg, model_type: str):
    """The operands of ``YHat``'s forward from a parameter tree, packed
    once: ``(operands, h_dims, z_tot)``, operands a dict of contiguous
    tensors (``w_<name>`` the encode's ``cuda_mfn.W_NAMES``)."""
    if model_type not in FAMILIES:
        raise ValueError(f"no y_hat forward for model type {model_type!r}; "
                         f"known: {sorted(FAMILIES)}")
    params = _tensors(params)
    zf, head = params["zf"]["zy_to_fy"], params["fy_to_y"]
    ops = {"f1w": zf["fc1"]["w"], "f1b": zf["fc1"]["b"],
           "f2w": zf["fc2"]["w"], "f2b": zf["fc2"]["b"],
           "y1w": head["fc1"]["w"], "y1b": head["fc1"]["b"],
           "y2w": head["fc2"]["w"], "y2b": head["fc2"]["b"]}
    if FAMILIES[model_type] == "early_fusion":
        cell, fc1 = params["ef_encoder"]["lstm"], params["ef_encoder"]["fc1"]
        h_dims, z_tot = [cell["wh"].shape[0]], 0
        ops.update(wx=cell["wx"], bx=cell["b"], wh=cell["wh"],
                   e1w=fc1["w"], e1b=fc1["b"],
                   zyw=params["last_to_zy"]["w"],
                   zyb=params["last_to_zy"]["b"])
    else:
        d_l, d_a, d_v = cfg.input_dims
        spans = ((0, d_l), (d_l, d_l + d_a), (d_l + d_a, d_l + d_a + d_v))
        mfn = params["mfn_enc"]["mfn"]
        cells = encode_cells([params["enc"][k]["lstm"] for k in _ENCODERS],
                             mfn)
        h_dims = [c["wh"].shape[0] for c in cells]
        z_tot = sum(h_dims[:3])
        wx, bx = input_projection(cells, spans + spans, cfg.d_total)
        ops.update(wx=wx, bx=bx,
                   zyw=params["mfn_enc"]["last_to_zy"]["w"],
                   zyb=params["mfn_enc"]["last_to_zy"]["b"])
        ops.update({f"w_{k}": v for k, v in
                    encode_weights(cells, mfn).items()})
    return ({k: v.detach().contiguous() for k, v in ops.items()}, h_dims,
            z_tot)


def _tensors(tree):
    """A tree of arrays or tensors as float32 tensors (no copy where it
    already is one)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32)


class YHat(nn.Module):
    """``y_hat`` of the eval forward of ``model_type`` (see the module's
    docstring): x (t, n, d_total) time-major -> (n,) for scalar
    regression, else (n, output_dim). The packed operands are buffers on
    ``device``."""

    def __init__(self, cfg, params, model_type: str, device=None):
        super().__init__()
        with torch.no_grad():
            ops, self.h_dims, self.z_tot = pack(params, cfg, model_type)
        self.family = FAMILIES[model_type]
        self.squeeze = cfg.task == "regression" and cfg.output_dim == 1
        for k, v in ops.items():
            self.register_buffer(k, v.to(device=device, dtype=torch.float32))

    def forward(self, x):
        t, n, d = x.shape
        xp = (x.reshape(t * n, d) @ self.wx + self.bx).reshape(t, n, -1)
        if self.family == "early_fusion":
            h = torch.ops.ftt.multi_lstm_eval(xp, self.wh, self.h_dims)
            last = h @ self.e1w + self.e1b
        else:
            h_last, mem = torch.ops.ftt.mfm_encode_eval(
                xp, [getattr(self, f"w_{k}") for k in cuda_mfn.W_NAMES],
                self.z_tot, self.h_dims)
            last = torch.cat([h_last[:, self.z_tot:], mem], dim=1)
        zy = last @ self.zyw + self.zyb
        fy = torch.relu(torch.relu(zy @ self.f1w + self.f1b) @ self.f2w
                        + self.f2b)
        y = torch.relu(fy @ self.y1w + self.y1b) @ self.y2w + self.y2b
        return y[:, 0] if self.squeeze else y
