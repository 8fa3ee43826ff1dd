"""PyTorch/CUDA port of ``factorized_tpu``.

The JAX package stays the reference; this package computes the same
functions over the same nested parameter tree (``(d_in, d_out)``
weights, gate order [i, f, g, o], one summed LSTM bias), with the
recurrent kernels written by hand in CUDA for Hopper (``csrc/``).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); with no card and no such request they raise.
"""

from __future__ import annotations

import torch

from factorized_tpu_torch.config import MFMConfig, best_acc_mosi_config

__all__ = ["MFMConfig", "best_acc_mosi_config", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card is an error, never a
    quiet move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
