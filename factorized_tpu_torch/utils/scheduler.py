"""The learning-rate scheduler (port of ``factorized_tpu/utils/scheduler.py``):
the host class ``ReduceLROnPlateau`` and ``plateau_step``, the same
schedule as a function of tensors that the chunked training loop steps on
the device (``train.ChunkedLoop``).

The class reproduces ``torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer,
'min')`` with torch's defaults (factor 0.1, patience 10, relative
threshold 1e-4, cooldown 0), with the comparisons and the reduction in
float32 as the JAX package does, so the two packages step the same
schedule from the same metrics.
"""

from __future__ import annotations

import numpy as np
import torch


def plateau_step(state, metric, *, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
    """One scheduler step on tensors of one shape: ``state`` is {"lr",
    "best" (float32), "bad", "cooldown" (int32)}, ``metric`` a float32
    tensor; returns the new state, nothing changed in place. The update
    order of ``ReduceLROnPlateau.step``: the is-better test against the
    old best, the cooldown's decrement clearing the bad-epoch count, the
    patience overrun reducing the lr and arming the cooldown. The
    comparisons and the reduction run in float32, as the JAX package's
    ``plateau_step`` and the host class; ``lr`` keeps its own dtype (the
    chunked training loop's is float32, as the JAX package's)."""
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    metric = metric.to(torch.float32)
    if mode == "min":
        is_better = metric < state["best"] * (1.0 - threshold)
    else:
        is_better = metric > state["best"] * (1.0 + threshold)
    best = torch.where(is_better, metric, state["best"])
    bad = torch.where(is_better, 0, state["bad"] + 1)
    in_cd = state["cooldown"] > 0
    cd = torch.where(in_cd, state["cooldown"] - 1, state["cooldown"])
    bad = torch.where(in_cd, 0, bad)
    reduce_ = bad > patience
    lr = state["lr"]
    reduced = torch.clamp_min(lr.to(torch.float32) * factor, min_lr)
    return {"lr": torch.where(reduce_, reduced.to(lr.dtype), lr),
            "best": best, "bad": torch.where(reduce_, 0, bad),
            "cooldown": torch.where(reduce_, cooldown, cd)}


class ReduceLROnPlateau:
    def __init__(self, lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float) -> bool:
        cur = np.float32(current)
        if self.mode == "min":
            return bool(cur < np.float32(self.best)
                        * np.float32(1.0 - self.threshold))
        return bool(cur > np.float32(self.best)
                    * np.float32(1.0 + self.threshold))

    def step(self, metric: float) -> float:
        """Feed this epoch's metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = float(np.maximum(
                np.float32(self.lr) * np.float32(self.factor),
                np.float32(self.min_lr)))
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr
