"""Training core of the port (port of ``factorized_tpu/train.py``, the
``"joint"``, ``"beta_vae"`` and ``"missing"`` variants).

A train step is the model's forward with dropout, the variant's loss
(for ``"joint"``: ``disc + gen + lda_mmd * mmd``, the L1 label loss, the
three weighted reconstruction MSEs and the MMD regulariser),
``backward`` through the hand-written backward kernels, and an Adam
update with the semantics of
``optax.scale_by_adam(eps=1e-8)`` followed by ``p -= lr * u``. PyTorch
runs eagerly: an epoch is a Python loop over device-resident batches.
Parameters are a nested dict of leaf tensors updated in place.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from factorized_tpu_torch.ops.losses import (cross_entropy_loss, l1_loss,
                                             l2_loss)

# ------------------------------------------------------------ batching


def shuffle_and_time_major(X, y, seed_or_rng):
    """The reference's preamble: permute the samples once (not per
    epoch), then swap to time-major."""
    rng = (seed_or_rng if isinstance(seed_or_rng, np.random.RandomState)
           else np.random.RandomState(seed_or_rng))
    p = rng.permutation(X.shape[0])
    X = np.ascontiguousarray(np.asarray(X)[p].swapaxes(0, 1),
                             dtype=np.float32)
    return X, np.asarray(y)[p]


def make_batches(X, y, batchsize: int, include_remainder: bool):
    """X time-major (t, N, d) -> (Xb (nb, t, B, d), yb (nb, B),
    remainder): the remainder batch is returned apart, or dropped."""
    t, n, d = X.shape
    nb = n // batchsize
    if nb == 0:
        raise ValueError(
            f"batchsize {batchsize} exceeds the {n} training samples - "
            f"no full batch can be formed")
    Xb = X[:, :nb * batchsize].reshape(t, nb, batchsize, d).transpose(
        1, 0, 2, 3)
    yb = y[:nb * batchsize].reshape(nb, batchsize, *y.shape[1:])
    rem = None
    if include_remainder and n % batchsize:
        rem = (X[:, nb * batchsize:], y[nb * batchsize:])
    return np.ascontiguousarray(Xb), yb, rem


# ------------------------------------------------------ loss composition

def _split_x(x, input_dims):
    d_l, d_a, _ = input_dims
    return x[..., :d_l], x[..., d_l:d_l + d_a], x[..., d_l + d_a:]


def _disc(y_hat, y, task: str):
    if task == "classification":
        return cross_entropy_loss(y_hat, y)
    if y_hat.dim() == y.dim():
        return l1_loss(y_hat, y)
    return l1_loss(torch.squeeze(y_hat, 1), y)


# the loss variants of the JAX package that the port has
VARIANTS = ("joint", "beta_vae", "missing")


def _check_variant(variant):
    if variant in ("s2s", "bm"):
        raise NotImplementedError(
            f"loss variant {variant!r} is not yet ported; ported: "
            f"{VARIANTS}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown loss variant {variant!r}")


def _gen(decoded, x, cfg):
    """The three weighted reconstruction MSEs of ``decoded``."""
    x_l, x_a, x_v = _split_x(x, cfg.input_dims)
    return (cfg.lda_xl * l2_loss(decoded[0], x_l)
            + cfg.lda_xa * l2_loss(decoded[1], x_a)
            + cfg.lda_xv * l2_loss(decoded[2], x_v))


def _missing_loss(out, x, y, cfg):
    """The composite loss of the ``missing`` model's six outputs: the four
    label losses, six reconstruction MSEs, MMD and the surrogates' loss.
    It keeps the reference's bug of scoring x_v against the a-missing
    decode's ``x_v_hat`` where the v-missing one is meant."""
    decoded, dec_nol, dec_noa, dec_nov, mmd, missing = out
    x_l, x_a, x_v = _split_x(x, cfg.input_dims)
    gen = (_gen(decoded, x, cfg)
           + cfg.lda_xl * l2_loss(dec_nol[0], x_l)
           + cfg.lda_xa * l2_loss(dec_noa[1], x_a)
           + cfg.lda_xv * l2_loss(dec_noa[2], x_v))
    disc = sum(_disc(d[3], y, cfg.task)
               for d in (decoded, dec_nol, dec_noa, dec_nov))
    return disc + gen + cfg.lda_mmd * mmd + missing


def make_loss_fn(apply_fn, cfg, variant: str = "joint",
                 stage: int = 0) -> Callable:
    """``loss_fn(params, x, y, *, generator=None, draws=None) -> (loss,
    tracked)``, ``tracked`` the quantity the reference prints as the
    epoch's train loss; ``draws`` are the injected random draws of
    ``apply_fn`` (see ``models.mfm``). The variants of the JAX package's
    ``make_loss_fn``:

    - ``"joint"``: ``disc + gen + lda_mmd * reg + missing``, tracking
      the label loss;
    - ``"beta_vae"``: stage 1 ``gen + lda_mmd * reg``, stage 2
      ``disc + lda_mmd * reg``, tracking the loss;
    - ``"missing"``: the composite loss of the ``missing`` model,
      tracking the all-present decode's x_l MSE."""
    _check_variant(variant)

    def loss_fn(params, x, y, *, generator=None, draws=None):
        out = apply_fn(params, x, cfg, generator=generator, train=True,
                       **(draws or {}))
        if variant == "missing":
            x_l = _split_x(x, cfg.input_dims)[0]
            return _missing_loss(out, x, y, cfg), l2_loss(out[0][0], x_l)
        decoded, reg, missing = out
        disc = _disc(decoded[3], y, cfg.task)
        reg = cfg.lda_mmd * reg
        if variant == "joint":
            return disc + _gen(decoded, x, cfg) + reg + missing, disc
        loss = _gen(decoded, x, cfg) + reg if stage == 1 else disc + reg
        return loss, loss

    return loss_fn


def make_eval_fn(apply_fn, cfg, variant: str = "joint") -> Callable:
    """``eval_fn(params, x, y, *, generator) -> validation loss`` in eval
    mode: the label loss, or for ``"missing"`` the whole composite loss,
    as the reference evaluates it."""
    _check_variant(variant)

    def eval_fn(params, x, y, *, generator=None):
        out = apply_fn(params, x, cfg, generator=generator, train=False)
        if variant == "missing":
            return _missing_loss(out, x, y, cfg)
        return _disc(out[0][3], y, cfg.task)

    return eval_fn


def make_optimizer(params, lr: float):
    """Adam over the leaves of ``params`` with the semantics of
    ``optax.scale_by_adam(eps=1e-8)`` and ``p -= lr * u`` (b1 0.9,
    b2 0.999, bias-corrected). The lr is set per step, so the scheduler
    changes it freely."""
    return torch.optim.Adam(leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def leaves(tree):
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


# ------------------------------------------------------- epoch machinery

class TrainProgram:
    """The train step, epoch and evaluation for one (model, cfg):

    - ``step(params, optimizer, x, y, generator, lr)`` -> the batch's
      tracked loss (a 0-d tensor; the host does not wait for it);
    - ``epoch(params, optimizer, Xb, yb, generator, lr)`` -> the mean
      tracked loss over the nb batches;
    - ``evaluate(params, x, y, generator)`` -> the full-set validation
      loss of the variant;
    - ``run_epoch(...)`` -> ``epoch`` plus the optional remainder batch,
      as a float.
    """

    def __init__(self, apply_fn, cfg, variant: str = "joint", stage: int = 0,
                 loss_fn=None, eval_fn=None):
        self.cfg = cfg
        self.loss_fn = loss_fn or make_loss_fn(apply_fn, cfg, variant, stage)
        self.eval_fn = eval_fn or make_eval_fn(apply_fn, cfg, variant)

    def step(self, params, optimizer, x, y, generator, lr):
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        loss, tracked = self.loss_fn(params, x, y, generator=generator)
        loss.backward()
        optimizer.step()
        return tracked.detach()

    def epoch(self, params, optimizer, Xb, yb, generator, lr):
        acc = torch.zeros((), dtype=torch.float32, device=Xb.device)
        for x, y in zip(Xb, yb):
            acc = acc + self.step(params, optimizer, x, y, generator, lr)
        return acc / Xb.shape[0]

    def evaluate(self, params, x, y, generator):
        with torch.no_grad():
            return self.eval_fn(params, x, y, generator=generator)

    def run_epoch(self, params, optimizer, Xb, yb, generator, lr,
                  remainder=None) -> float:
        """One epoch and the optional ragged remainder batch; the
        remainder's tracked loss is divided by nb like the full batches'
        (the reference sums nb + 1 batches and divides by nb)."""
        nb = Xb.shape[0]
        acc = self.epoch(params, optimizer, Xb, yb, generator, lr)
        if remainder is not None and remainder[0].shape[1] > 0:
            rx, ry = remainder
            acc = acc + self.step(params, optimizer, rx, ry, generator,
                                  lr) / nb
        return float(acc)
