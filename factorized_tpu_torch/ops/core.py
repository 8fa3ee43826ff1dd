"""Linear / two-layer-MLP / dropout primitives (port of
``factorized_tpu/ops/core.py``).

Weights are stored ``(d_in, d_out)`` as in the JAX package, so
``x @ w + b`` needs no transpose and a JAX param tree converts by a
plain tree map. Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch


def uniform_fan_in(generator: torch.Generator, shape, fan_in: int):
    """U(-1/sqrt(fan_in), +1/sqrt(fan_in)) — torch's default Linear/LSTM
    init, drawn on the generator's device."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * (2.0 * bound) - bound


def linear_init(generator, d_in: int, d_out: int):
    return {
        "w": uniform_fan_in(generator, (d_in, d_out), d_in),
        "b": uniform_fan_in(generator, (d_out,), d_in),
    }


def linear_apply(params, x):
    return x @ params["w"] + params["b"]


def dropout_mask(generator: torch.Generator, shape, rate: float):
    """The scaled keep-mask of inverted dropout, drawn on the generator's
    device: ``1 / keep`` where kept, else 0; all ones at rate <= 0 and
    all zeros at rate >= 1 (as torch's ``nn.Dropout``)."""
    device = generator.device
    if rate <= 0.0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    if rate >= 1.0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    keep = 1.0 - rate
    kept = torch.rand(shape, generator=generator, device=device) < keep
    return kept.to(torch.float32) * (1.0 / keep)


def dropout(x, rate: float, train: bool, generator=None, mask=None):
    """Inverted dropout with a static (python float) rate: a no-op in
    eval mode or at rate <= 0, all zeros at rate >= 1, else ``x * mask``
    with ``mask`` the scaled keep-mask of ``dropout_mask``, drawn from
    ``generator`` unless handed in (the injection point of the draw)."""
    if not train or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if mask is None:
        if generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator "
                             "or a mask")
        mask = dropout_mask(generator, x.shape, rate)
    return x * mask


def mlp2_init(generator, d_in: int, d_hidden: int, d_out: int):
    return {
        "fc1": linear_init(generator, d_in, d_hidden),
        "fc2": linear_init(generator, d_hidden, d_out),
    }


def mlp2_apply(params, x, *, drop: float = 0.0, train: bool = False,
               generator=None, mask=None):
    """``fc2(dropout(relu(fc1(x))))``; the caller applies the final
    nonlinearity, which differs per use site."""
    h = torch.relu(linear_apply(params["fc1"], x))
    h = dropout(h, drop, train, generator, mask)
    return linear_apply(params["fc2"], h)
