"""Prior-matching and task losses (port of ``factorized_tpu/ops/losses.py``).

``compute_kernel`` keeps the reference's double division by ``dim``: the
exponent is ``-||x_i - y_j||^2 / dim^2``. ``loss_mmd`` takes its Gaussian
sample from a ``torch.Generator`` or as an injected tensor.
"""

from __future__ import annotations

import torch

from factorized_tpu_torch.ops.rows import draw, gather_rows, row_sum


def compute_kernel(x, y):
    """Kernel matrix (n_x, n_y): exp(-sqdist(x_i, y_j) / dim^2)."""
    dim = x.shape[1]
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True)
    sq = torch.clamp(x2 + y2.T - 2.0 * (x @ y.T), min=0.0)
    return torch.exp(-sq / float(dim * dim))


def loss_mmd(z, generator=None, noise=None):
    """MMD(z, N(0, I)) against a Gaussian sample of z's shape: ``noise``
    when handed in, else drawn from ``generator``. Under a data group it
    is the MMD of the whole batch's z (``ops.rows``)."""
    if noise is None:
        noise = draw(torch.randn, generator, z.shape, whole=True)
    z = gather_rows(z)
    return (torch.mean(compute_kernel(noise, noise))
            + torch.mean(compute_kernel(z, z))
            - 2.0 * torch.mean(compute_kernel(noise, z)))


def loss_kld(mu, logvar):
    """Summed KL( N(mu, exp(logvar)) || N(0, I) ) (under a data group
    this rank's part, ``ops.rows.row_sum``)."""
    return row_sum(-0.5 * torch.sum(1.0 + logvar - mu * mu
                                    - torch.exp(logvar)))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    d = pred - target
    return torch.mean(d * d)


def cross_entropy_loss(logits, labels):
    """Mean cross-entropy over the batch; labels are integer classes."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))
