"""Checkpoints of the port (port of ``factorized_tpu/utils/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of
``{"params": flat state_dict}``, plus ``"opt_state"`` when given, e.g. a
``torch.optim.Adam`` state dict) and a ``meta.json`` with the JAX
package's schema: ``step``, ``config``, ``has_opt_state`` and ``format``
(here ``"torch"``). Every tensor is stored on the CPU. Reading the JAX
package's Orbax or msgpack directories needs JAX and is not ported.
``BestKeeper`` keeps the parameters of the best epoch in host memory;
``keeps`` is its rule on tensors, for the chunked training loop.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from factorized_tpu_torch.convert import from_state_dict, to_state_dict


def to_cpu(obj):
    """A copy of ``obj`` (nested dicts, lists and tuples of tensors and
    plain values) with every tensor detached and on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    config: Optional[dict] = None):
    """Save ``params`` (a nested dict of tensors) under the directory
    ``path``; tensors are stored on the CPU."""
    os.makedirs(path, exist_ok=True)
    state = {"params": to_cpu(to_state_dict(params))}
    if opt_state is not None:
        state["opt_state"] = to_cpu(opt_state)
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


class BestKeeper:
    """Track the best metric's parameters in host memory, the reference's
    save-on-best-valid policy: ``<=`` in mode 'min', ``>=`` in mode
    'max', so a tie replaces the incumbent."""

    def __init__(self, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.mode = mode
        self.best = float("inf") if mode == "min" else float("-inf")
        self.best_params = None
        self.best_epoch = -1

    def update(self, metric: float, params, epoch: int) -> bool:
        better = (metric <= self.best if self.mode == "min"
                  else metric >= self.best)
        if better:
            self.best = metric
            self.best_params = to_cpu(params)
            self.best_epoch = epoch
        return better


def keeps(metric, best, ok, mode: str = "min", save_always: bool = False):
    """``BestKeeper.update``'s rule on tensors: whether a healthy (``ok``)
    epoch's ``metric`` replaces ``best``, ``<=`` in mode 'min' and ``>=``
    in mode 'max'; with ``save_always`` (the beta-VAE trainer's
    unconditional save) every healthy epoch replaces it."""
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    if save_always:
        return ok
    return ok & (metric <= best if mode == "min" else metric >= best)
