"""Checkpoints of the port (port of ``factorized_tpu/utils/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of
``{"params": flat state_dict}``, plus ``"opt_state"`` when given) and a
``meta.json`` with the JAX package's schema: ``step``, ``config``,
``has_opt_state`` and ``format`` (here ``"torch"``). Reading the JAX
package's Orbax or msgpack directories needs JAX and is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from factorized_tpu_torch.convert import from_state_dict, to_state_dict


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    config: Optional[dict] = None):
    """Save ``params`` (a nested dict of tensors) under the directory
    ``path``; tensors are stored on the CPU."""
    os.makedirs(path, exist_ok=True)
    state = {"params": {k: v.detach().cpu()
                        for k, v in to_state_dict(params).items()}}
    if opt_state is not None:
        state["opt_state"] = opt_state
    torch.save(state, os.path.join(path, "state.pt"))
    meta = {"step": int(step), "config": config or {},
            "has_opt_state": opt_state is not None, "format": "torch"}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def restore_checkpoint(path: str):
    """-> (state, meta): ``state["params"]`` is the nested dict of CPU
    tensors."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "torch":
        raise NotImplementedError(
            f"checkpoint format {meta.get('format')!r} was written by the "
            f"JAX package; reading it is not yet ported")
    state = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       weights_only=True)
    state["params"] = from_state_dict(state["params"])
    return state, meta
