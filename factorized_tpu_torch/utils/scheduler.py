"""The host-side learning-rate scheduler (port of the ``ReduceLROnPlateau``
class of ``factorized_tpu/utils/scheduler.py``).

It reproduces ``torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer,
'min')`` with torch's defaults (factor 0.1, patience 10, relative
threshold 1e-4, cooldown 0), with the comparisons and the reduction in
float32 as the JAX package does, so the two packages step the same
schedule from the same metrics.
"""

from __future__ import annotations

import numpy as np


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
