"""Checkpoints of the port (port of ``factorized_tpu/utils/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of
``{"params": flat state_dict}``, plus ``"opt_state"`` when given, e.g. a
``torch.optim.Adam`` state dict) and a ``meta.json`` with the JAX
package's schema: ``step``, ``config``, ``has_opt_state`` and ``format``
(here ``"torch"``). Every tensor is stored on the CPU.

``restore_checkpoint`` also reads the directories the JAX package's
``save_checkpoint`` writes, with no package beyond numpy: ``"orbax"``
(``state/``, an Orbax PyTree in an OCDBT store of zarr arrays:
``utils/orbax.py``, ``utils/ocdbt.py``, ``utils/zarr.py``,
``utils/zstd.py``) and ``"msgpack"`` (``state.msgpack``, flax's state
dict: ``utils/msgpack.py``). It returns the port's own state: the
parameters as nested dicts of CPU tensors under the JAX tree's keys, and
the optimizer state of ``optax.flatten(scale_by_adam)`` (``count``,
``mu``, ``nu``) or ``optax.flatten(trace)`` (``trace``), for one model or
``(K, P)`` lanes, in the layout of ``train.FlatAdam``, ``LaneAdam`` and
``FlatSGD``, with the lr the meta records. ``ravel_pytree`` lays the
moments out in the sorted order of the parameters' keys, so the JAX
parameters come back with their keys sorted; an optimizer's
``load_state_dict(state, params=...)`` lays the slots out again in its
own order by those keys.
``BestKeeper`` keeps the parameters of the best epoch in host memory;
``keeps`` is its rule on tensors, for the chunked training loop.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
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
    tensors, ``state["opt_state"]`` the optimizer's state where one was
    saved. Reads the port's checkpoints and the JAX package's (Orbax or
    msgpack); ``meta`` as written."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    fmt = meta.get("format")
    if fmt == "torch":
        state = torch.load(os.path.join(path, "state.pt"),
                           map_location="cpu", weights_only=True)
        state["params"] = from_state_dict(state["params"])
        return state, meta
    if fmt == "orbax":
        from factorized_tpu_torch.utils.orbax import read_pytree

        tree = read_pytree(os.path.join(path, "state"))
    elif fmt == "msgpack":
        from factorized_tpu_torch.utils.msgpack import restore

        with open(os.path.join(path, "state.msgpack"), "rb") as f:
            tree = restore(f.read())
    else:
        raise ValueError(f"{path}: checkpoint format {fmt!r}; the port reads "
                         f"'torch', 'orbax' and 'msgpack'")
    return _from_jax(tree, meta, path), meta


def _tensors(tree, where):
    """A JAX state's nested dicts of arrays as nested dicts of CPU tensors,
    the keys of each dict sorted (``ravel_pytree``'s order)."""
    if isinstance(tree, dict):
        return {k: _tensors(tree[k], f"{where}/{k}") for k in sorted(tree)}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    raise ValueError(f"{where}: a {type(tree).__name__} where the port "
                     f"takes nested dicts of arrays")


def _resume_lr(cfg):
    """The lr a JAX checkpoint records: the run's (``_resume_lr``), the
    lanes' (``_ms_lrs``, ``_ev["lrs"]``), else the config's; None where
    the meta has none (the optimizer then keeps its own)."""
    for lr in (cfg.get("_resume_lr"), cfg.get("_ms_lrs"),
               (cfg.get("_ev") or {}).get("lrs"), cfg.get("lr")):
        if lr is not None:
            return lr
    return None


def _from_jax(tree, meta, path):
    """The port's state of a JAX package's checkpoint tree: ``params``,
    and ``opt_state`` as ``{"state": {...}, "lr": ...}``."""
    extra = sorted(set(tree) - {"params", "opt_state"})
    if extra or "params" not in tree:
        raise ValueError(f"{path}: state holds {sorted(tree)}; the port reads "
                         f"'params' and 'opt_state'")
    state = {"params": _tensors(tree["params"], f"{path}:params")}
    if meta.get("has_opt_state") and "opt_state" not in tree:
        raise ValueError(f"{path}: meta says it holds an optimizer state, "
                         f"the state has none")
    if "opt_state" not in tree:
        return state
    opt = tree["opt_state"]
    slots = {"adam": ("count", "mu", "nu"), "sgd": ("trace",)}
    kind = next((k for k, names in slots.items()
                 if isinstance(opt, dict) and sorted(opt) == sorted(names)),
                None)
    if kind is None:
        raise ValueError(f"{path}: optimizer state with fields "
                         f"{sorted(opt) if isinstance(opt, dict) else opt!r}; "
                         f"the port reads optax.flatten(scale_by_adam) "
                         f"(count, mu, nu) and optax.flatten(trace) (trace)")
    st = _tensors(opt, f"{path}:opt_state")
    state["opt_state"] = {"state": {k: st[k] for k in slots[kind]},
                          "lr": _resume_lr(meta.get("config", {}))}
    return state


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
