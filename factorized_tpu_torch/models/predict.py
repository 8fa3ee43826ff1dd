"""The serving forward of the MFM family, the ablations and the
standalone MFN predictor: ``y_hat`` alone, over operands packed once
(the port's counterpart of the JAX ``Predictor``'s jitted forward, in
which XLA folds the packing into constants and drops what ``y_hat`` does
not read).

``y_hat = decoded[3]`` reads only the label path, so this forward runs
no MMD draw, no decoder and no latent that the label path does not read
(for ``missing`` no surrogate encoder: its all-present decode reads the
MFM encode alone). The families:

- ``"encode"`` (``mfm``, ``kl``, ``missing``): one ``x @ Wx + b`` for the
  six encode cells' input projections (``ops.fused.input_projection``),
  the eval encode (``ftt::mfm_encode_eval``), ``mfn_enc.last_to_zy``, the
  zy -> fy MLP and the label head;
- ``"mfn"`` (``m_a``, ``m_c``): the same over the MFN's three cells alone,
  the encode with no encoder cell (``m_a``'s joint encoder feeds no
  y_hat);
- ``"early_fusion"`` (``kl_ef``): the early-fusion cell alone (its input
  projection, then ``ftt::multi_lstm_eval`` over that one cell),
  ``ef_encoder.fc1``, ``last_to_zy``, the zy -> fy MLP and the label
  head;
- ``"trio"`` (``m_b``, ``m_d``): the three unimodal encoder cells as one
  ``ftt::multi_lstm_eval`` over one input product, their ``fc1`` heads
  and the three z -> f MLPs each as one block-diagonal product, then
  ``m_b``'s two-layer head over [fl, fa, fv] or ``m_d``'s linear
  ``fs_to_y``;
- ``"mfn_predictor"`` (the model type ``mfn``, the ``predictor``
  command's MFN, whose output is y_hat): the MFN's three cells' input
  product, the encode with no encoder cell, then its two-layer ``out``
  head over [h, mem].

``YHat`` holds the operands as buffers, so ``torch.export`` carries them
inside the artifact; the two recurrences are custom ops, the kernels on
the card and their plain versions on the CPU.

Serving follows the training path's gate (``models/mfm.py::
fused_active``), as the JAX ``Predictor`` does: at a config at or above
the FLOPs crossover the ``"encode"`` family runs the modular MFN
(``ops/mfn.py::mfn_scan``) and ``"early_fusion"`` the early-fusion
cell's own recurrence (``ops/lstm.py::lstm_scan``), plain PyTorch over
the parameters as they are (``YHat.recurrence``), then the same heads.
Below it nothing changes.
"""

from __future__ import annotations

import torch
from torch import nn

# importing the two wrapper modules registers the ftt:: custom ops
from factorized_tpu_torch.models.common import split_modalities
from factorized_tpu_torch.models.mfm import ParamTree, fused_active
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn  # noqa: F401
from factorized_tpu_torch.ops.fused import (blockdiag, encode_cells,
                                            encode_weights,
                                            gate_major_blockdiag,
                                            input_projection)
from factorized_tpu_torch.ops.lstm import lstm_scan
from factorized_tpu_torch.ops.mfn import mfn_scan

# the model types whose y_hat this forward computes, by family
FAMILIES = {"mfm": "encode", "kl": "encode", "missing": "encode",
            "m_a": "mfn", "m_c": "mfn", "kl_ef": "early_fusion",
            "m_b": "trio", "m_d": "trio", "mfn": "mfn_predictor"}
_ENCODERS = ("encoder_l", "encoder_a", "encoder_v")
_TRIO_ZF = ("zl_to_fl", "za_to_fa", "zv_to_fv")
# the families whose recurrence follows the gate
GATED = ("encode", "early_fusion")


def modular(cfg, model_type: str) -> bool:
    """Whether ``YHat`` serves ``model_type`` at ``cfg`` on the modular
    path (``fused_active`` is false for a gated family)."""
    return FAMILIES.get(model_type) in GATED and not fused_active(cfg)


def pack(params, cfg, model_type: str):
    """The operands of ``YHat``'s forward from a parameter tree, packed
    once: ``(operands, h_dims, z_tot)``, operands a dict of contiguous
    tensors (``w_<name>`` the encode's ``cuda_mfn.W_NAMES``; ``zy*``
    only where a zy head is read; ``f*`` only where the z -> f MLP is;
    ``y1*`` only for a two-layer label head) and, on the modular path,
    ``"recurrence"`` the tree of its recurrence's parameters."""
    if model_type not in FAMILIES:
        raise ValueError(f"no y_hat forward for model type {model_type!r}; "
                         f"known: {sorted(FAMILIES)}")
    params = _tensors(params)
    family = FAMILIES[model_type]
    d_l, d_a, d_v = cfg.input_dims
    spans = ((0, d_l), (d_l, d_l + d_a), (d_l + d_a, d_l + d_a + d_v))
    if family == "trio":
        return _pack_trio(params, cfg, model_type, spans)
    if family == "mfn_predictor":
        head = params["out"]
        return _pack_encode(
            params["mfn"], [], spans, cfg,
            {"y1w": head["fc1"]["w"], "y1b": head["fc1"]["b"],
             "y2w": head["fc2"]["w"], "y2b": head["fc2"]["b"]})
    zf = (params["zf"]["zy_to_fy"] if family in ("encode", "early_fusion")
          else params["zy_to_fy"])
    head = params["fy_to_y"]
    ops = {"f1w": zf["fc1"]["w"], "f1b": zf["fc1"]["b"],
           "f2w": zf["fc2"]["w"], "f2b": zf["fc2"]["b"],
           "y1w": head["fc1"]["w"], "y1b": head["fc1"]["b"],
           "y2w": head["fc2"]["w"], "y2b": head["fc2"]["b"]}
    if family == "early_fusion":
        cell, fc1 = params["ef_encoder"]["lstm"], params["ef_encoder"]["fc1"]
        h_dims, z_tot = [cell["wh"].shape[0]], 0
        ops.update(dict(recurrence=cell) if modular(cfg, model_type)
                   else dict(wx=cell["wx"], bx=cell["b"], wh=cell["wh"]))
        ops.update(e1w=fc1["w"], e1b=fc1["b"],
                   zyw=params["last_to_zy"]["w"],
                   zyb=params["last_to_zy"]["b"])
    elif modular(cfg, model_type):
        ops.update(zyw=params["mfn_enc"]["last_to_zy"]["w"],
                   zyb=params["mfn_enc"]["last_to_zy"]["b"],
                   recurrence=params["mfn_enc"]["mfn"])
        h_dims, z_tot = [], 0
    else:
        encoders = ([params["enc"][k]["lstm"] for k in _ENCODERS]
                    if family == "encode" else [])
        ops.update(zyw=params["mfn_enc"]["last_to_zy"]["w"],
                   zyb=params["mfn_enc"]["last_to_zy"]["b"])
        return _pack_encode(params["mfn_enc"]["mfn"], encoders, spans, cfg,
                            ops)
    return ({k: _detached(v) for k, v in ops.items()}, h_dims, z_tot)


def _detached(tree):
    """A tensor, or each leaf of a tree, detached and contiguous."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().contiguous()


def _pack_encode(mfn, encoders, spans, cfg, ops):
    """``pack`` of a family that runs the encode: the ``encoders`` (over
    the modalities) and the MFN's three cells as one input product, and
    the encode's weights, beside the head's operands ``ops``."""
    cells = encode_cells(encoders, mfn)
    h_dims = [c["wh"].shape[0] for c in cells]
    wx, bx = input_projection(cells, spans[:len(encoders)] + spans,
                              cfg.d_total)
    ops = dict(ops, wx=wx, bx=bx)
    ops.update({f"w_{k}": v for k, v in encode_weights(cells, mfn).items()})
    return ({k: v.detach().contiguous() for k, v in ops.items()}, h_dims,
            sum(h_dims[:len(encoders)]))


def _pack_trio(params, cfg, model_type, spans):
    """``pack`` of the ``"trio"`` family: the three encoder cells' input
    projections as one block matrix, their recurrent weights as one
    block-diagonal, each layer of the three ``fc1`` heads and z -> f MLPs
    as one block-diagonal product."""
    enc = params["enc"]
    cells = [enc[k]["lstm"] for k in _ENCODERS]
    h_dims = [c["wh"].shape[0] for c in cells]
    wx, bx = input_projection(cells, spans, cfg.d_total)
    zf = [params[k] for k in _TRIO_ZF]
    z_dims = [enc[k]["fc1"]["w"].shape[1] for k in _ENCODERS]
    f_dims = [p["fc2"]["w"].shape[1] for p in zf]
    ops = {"wx": wx, "bx": bx,
           "wh": gate_major_blockdiag([c["wh"] for c in cells], h_dims),
           "e1w": blockdiag([enc[k]["fc1"]["w"] for k in _ENCODERS], z_dims),
           "e1b": torch.cat([enc[k]["fc1"]["b"] for k in _ENCODERS]),
           "f1w": blockdiag([p["fc1"]["w"] for p in zf], f_dims),
           "f1b": torch.cat([p["fc1"]["b"] for p in zf]),
           "f2w": blockdiag([p["fc2"]["w"] for p in zf], f_dims),
           "f2b": torch.cat([p["fc2"]["b"] for p in zf])}
    if model_type == "m_b":
        head = params["fy_to_y"]
        ops.update(y1w=head["fc1"]["w"], y1b=head["fc1"]["b"],
                   y2w=head["fc2"]["w"], y2b=head["fc2"]["b"])
    else:
        ops.update(y2w=params["fs_to_y"]["w"], y2b=params["fs_to_y"]["b"])
    return ({k: v.detach().contiguous() for k, v in ops.items()}, h_dims, 0)


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
        self.zy_head = "zyw" in ops
        self.zf = "f1w" in ops
        self.two_layer_head = "y1w" in ops
        self.modular = "recurrence" in ops
        if self.modular:
            self.recurrence = ParamTree(ops.pop("recurrence")).to(device)
            self.recurrence.requires_grad_(False)
        self.input_dims = list(cfg.input_dims)
        self.mem_dim = cfg.memsize
        for k, v in ops.items():
            self.register_buffer(k, v.to(device=device, dtype=torch.float32))

    def forward(self, x):
        if self.modular:
            return self._head(self._modular_last(x))
        t, n, d = x.shape
        xp = (x.reshape(t * n, d) @ self.wx + self.bx).reshape(t, n, -1)
        if self.family in ("early_fusion", "trio"):
            h = torch.ops.ftt.multi_lstm_eval(xp, self.wh, self.h_dims)
            last = h @ self.e1w + self.e1b
        else:
            h_last, mem = torch.ops.ftt.mfm_encode_eval(
                xp, [getattr(self, f"w_{k}") for k in cuda_mfn.W_NAMES],
                self.z_tot, self.h_dims)
            last = torch.cat([h_last[:, self.z_tot:], mem], dim=1)
        return self._head(last)

    def _modular_last(self, x):
        """The gated family's last state on the modular path."""
        tree = self.recurrence.tree()
        if self.family == "early_fusion":
            _, h, _ = lstm_scan(tree, x)
            return h @ self.e1w + self.e1b
        return mfn_scan(tree, *split_modalities(x, self.input_dims),
                        mem_dim=self.mem_dim, drops=(0.0,) * 4)

    def _head(self, last):
        f = last @ self.zyw + self.zyb if self.zy_head else last
        if self.zf:
            f = torch.relu(torch.relu(f @ self.f1w + self.f1b) @ self.f2w
                           + self.f2b)
        if self.two_layer_head:
            f = torch.relu(f @ self.y1w + self.y1b)
        y = f @ self.y2w + self.y2b
        return y[:, 0] if self.squeeze else y
