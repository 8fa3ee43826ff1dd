"""Linear / two-layer-MLP / dropout primitives (port of
``factorized_tpu/ops/core.py``).

Weights are stored ``(d_in, d_out)`` as in the JAX package, so
``x @ w + b`` needs no transpose and a JAX param tree converts by a
plain tree map. Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from factorized_tpu_torch.ops.rows import draw


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


def rate_is_static(rate) -> bool:
    """True where a dropout rate is a plain python number; False for a
    tensor (a lane's rate under ``torch.func.vmap`` in the config-bucketed
    search, ``parallel/multiconfig.py``). The JAX package's
    ``rate_is_static``."""
    return isinstance(rate, (int, float))


def rate_active(rate, train: bool) -> bool:
    """Whether a dropout site runs: always for a tensor rate (its value is
    the lane's, known only at run time), else only above 0."""
    return bool(train) and (not rate_is_static(rate) or rate > 0.0)


def dropout_mask(generator: torch.Generator, shape, rate, rows=0):
    """The scaled keep-mask of inverted dropout, drawn on the generator's
    device: ``1 / keep`` where kept, else 0. A float rate gives all ones
    at rate <= 0 (nothing drawn) and all zeros at rate >= 1 (as torch's
    ``nn.Dropout``). A tensor rate always draws: at 0 the mask is exactly
    ones (keep 1, scale 1), at 1 or more exactly zeros (the keep floor
    of 1e-6 lets a draw survive, and its scale is then 0, not 1e6).
    ``rows`` is the batch axis of ``shape`` (``ops.rows.draw``)."""
    device = generator.device
    if not rate_is_static(rate):
        keep = torch.clamp(1.0 - rate, min=1e-6)
        kept = draw(torch.rand, generator, shape, rows) < keep
        scale = torch.where(rate >= 1.0, torch.zeros_like(keep), 1.0 / keep)
        return kept.to(torch.float32) * scale
    if rate <= 0.0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    if rate >= 1.0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    keep = 1.0 - rate
    kept = draw(torch.rand, generator, shape, rows) < keep
    return kept.to(torch.float32) * (1.0 / keep)


def dropout(x, rate, train: bool, generator=None, mask=None):
    """Inverted dropout: a no-op in eval mode, else ``x * mask`` with
    ``mask`` the scaled keep-mask of ``dropout_mask``, drawn from
    ``generator`` unless handed in (the injection point of the draw). A
    float rate (static) is a no-op at rate <= 0 and gives zeros at rate
    >= 1; a tensor rate (the JAX package's traced one) always runs the
    site, and its rate 0 gives ``x`` exactly."""
    if not rate_active(rate, train):
        return x
    if rate_is_static(rate) and rate >= 1.0:
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
