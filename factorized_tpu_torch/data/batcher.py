"""Normalisation by train statistics (port of ``compute_train_max`` of
``factorized_tpu/data/batcher.py``)."""

from __future__ import annotations

import numpy as np


def compute_train_max(x):
    """Per-feature max-abs over the (n, t) train axes, zeros -> 1."""
    m = np.max(np.abs(np.asarray(x)), axis=(0, 1))
    m[m == 0] = 1.0
    return m.astype(np.float32)
