"""Between the JAX package's parameter trees and the port's.

Both packages use the same nested keys and the same ``(d_in, d_out)``
layouts, so each conversion is a plain tree map: no transpose, no
reshuffle. The JAX side is handed over as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(tree, device=None):
    """Nested dict of arrays -> nested dict of tensors (copies)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def to_state_dict(tree, prefix: str = ""):
    """Nested dict -> flat ``{'a.b.c': leaf}``, the keys ``MFM.state_dict``
    uses."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(to_state_dict(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def from_state_dict(flat):
    """Flat ``{'a.b.c': leaf}`` -> nested dict."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
