"""Training core of the port (port of ``factorized_tpu/train.py``, the
``"joint"``, ``"beta_vae"``, ``"missing"``, ``"s2s"`` and ``"bm"``
variants).

A train step is the model's forward with dropout, the variant's loss
(for ``"joint"``: ``disc + gen + lda_mmd * mmd``, the L1 label loss, the
three weighted reconstruction MSEs and the MMD regulariser),
``backward`` through the hand-written backward kernels, and one update
over the flat parameter vector (``FlatAdam``: the semantics of
``optax.flatten(optax.scale_by_adam(eps=1e-8))`` followed by ``p -= lr *
u``; ``FlatSGD``: ``optax.flatten(optax.trace(momentum))``).
Parameters are a nested dict of leaf tensors, views of that
vector, updated in place. An epoch is a Python loop over device-resident
batches (``TrainProgram``); ``ChunkedLoop`` is the JAX package's chunked
loop of whole epochs with the eval, the best-keeper's select, the
plateau scheduler and the divergence gate on the device, each epoch on
a CUDA card one replay of a CUDA graph (``Graphed``).
"""

from __future__ import annotations

import ctypes
import functools
import gc
from typing import Callable

import numpy as np
import torch

from factorized_tpu_torch.ops import counts
from factorized_tpu_torch.ops.losses import (cross_entropy_loss, l1_loss,
                                             l2_loss)
from factorized_tpu_torch.utils.checkpoint import keeps
from factorized_tpu_torch.utils.profiling import span
from factorized_tpu_torch.utils.scheduler import plateau_step

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


# the loss variants of the JAX package
VARIANTS = ("joint", "beta_vae", "missing", "s2s", "bm")


def _check_variant(variant):
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


def _s2s_gen(out, x, cfg):
    """The three weighted cross-modal reconstruction MSEs of ``s2s``'s
    ``(nol, noa, nov, mmd)``."""
    nol, noa, nov, _ = out
    return _gen((nol[0], noa[0], nov[0]), x, cfg)


def _bm_disc(out, y, cfg):
    """The three heads' label losses of ``bm``'s ``(y_nol, y_noa, y_nov,
    mmd)``."""
    y_nol, y_noa, y_nov, _ = out
    return (_disc(y_nol, y, cfg.task) + _disc(y_noa, y, cfg.task)
            + _disc(y_nov, y, cfg.task))


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
      tracking the all-present decode's x_l MSE;
    - ``"s2s"``: the three cross-modal reconstruction MSEs plus
      ``lda_mmd * mmd``, tracking the loss;
    - ``"bm"``: the three heads' label losses plus ``lda_mmd * mmd``,
      tracking the loss."""
    _check_variant(variant)

    def loss_fn(params, x, y, *, generator=None, draws=None):
        out = apply_fn(params, x, cfg, generator=generator, train=True,
                       **(draws or {}))
        if variant == "missing":
            x_l = _split_x(x, cfg.input_dims)[0]
            return _missing_loss(out, x, y, cfg), l2_loss(out[0][0], x_l)
        if variant in ("s2s", "bm"):
            part = (_s2s_gen(out, x, cfg) if variant == "s2s"
                    else _bm_disc(out, y, cfg))
            loss = part + cfg.lda_mmd * out[3]
            return loss, loss
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
    mode, as the reference evaluates it: the label loss; for
    ``"missing"`` the whole composite loss; for ``"s2s"`` the three
    reconstruction MSEs without the MMD; for ``"bm"`` the l-missing
    head's label loss alone."""
    _check_variant(variant)

    def eval_fn(params, x, y, *, generator=None):
        out = apply_fn(params, x, cfg, generator=generator, train=False)
        if variant == "missing":
            return _missing_loss(out, x, y, cfg)
        if variant == "s2s":
            return _s2s_gen(out, x, cfg)
        if variant == "bm":
            return _disc(out[0], y, cfg.task)
        return _disc(out[0][3], y, cfg.task)

    return eval_fn


# ------------------------------------------------------------ optimizer

class _FlatOptimizer:
    """What the flat optimizers share: the leaves of ``params`` moved into
    one float32 buffer, ``state``, whose first view is ``flat`` and whose
    other views are the optimizer's ``slots`` (each as long as ``flat``),
    so the chunked loop's divergence gate copies the whole state at once.
    Each leaf stays the same tensor, of the same shape and ``(d_in,
    d_out)`` layout, requiring grad, with its storage a view of ``flat``
    and its ``.grad`` a view of ``grad``; so the models, ``convert.py``
    and the checkpoints see the same nested dict. ``zero_grad`` zeroes
    ``grad`` (never to None) and backward adds into it in place, so a leaf
    the loss does not reach gets a zero gradient, as under ``jax.grad``.
    ``lr`` is a 0-d float32 tensor on the parameters' device that ``step``
    reads, so a captured CUDA graph reads the lr of the moment, not the
    one of its capture; float32, as the JAX package's chunked loop keeps
    it (the product ``lr * u`` is float32 whatever the lr's type, so the
    update is the same)."""

    def __init__(self, params, lr: float, slots):
        self.params = params
        ls = leaves(params)
        dev = ls[0].device
        for leaf in ls:
            if leaf.dtype != torch.float32 or leaf.device != dev:
                raise ValueError(f"{type(self).__name__} takes float32 "
                                 f"leaves on one device, got {leaf.dtype} "
                                 f"on {leaf.device}")
        n = sum(leaf.numel() for leaf in ls)
        self.state = torch.zeros((1 + len(slots)) * n, dtype=torch.float32,
                                 device=dev)
        self.flat, *views = self.state.split(n)
        self.slots = dict(zip(slots, views))
        for name, view in self.slots.items():
            setattr(self, name, view)
        self.grad = torch.zeros(n, dtype=torch.float32, device=dev)
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=dev)
        at = 0
        with torch.no_grad():
            for leaf in ls:
                k = leaf.numel()
                self.flat[at:at + k].copy_(leaf.reshape(-1))
                leaf.data = self.flat[at:at + k].view(leaf.shape)
                leaf.requires_grad_(True)
                leaf.grad = self.grad[at:at + k].view(leaf.shape)
                at += k

    def set_lr(self, lr: float):
        self.lr.fill_(lr)

    def zero_grad(self):
        self.grad.zero_()

    def flatten(self, tree):
        """A tree shaped like ``params`` as one vector like ``flat``, its
        leaves taken by key in ``params``' order."""
        def walk(like, t):
            if isinstance(like, dict):
                return [x for k, v in like.items() for x in walk(v, t[k])]
            return [t.detach().reshape(-1)]

        return torch.cat(walk(self.params, tree)).to(self.flat.device)

    def tree_of(self, vec):
        """A vector like ``flat`` as a nested dict shaped like ``params``,
        each leaf a copy."""
        def build(tree, at):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k], at = build(v, at)
                else:
                    out[k] = vec[at:at + v.numel()].view(v.shape).clone()
                    at += v.numel()
            return out, at

        return build(self.params, 0)[0]

    def state_dict(self):
        """The optimizer's state as optax keeps it (its slots flat, in the
        leaves' order) and the lr, copies."""
        return {"state": {k: v.clone() for k, v in self.slots.items()},
                "lr": float(self.lr)}

    def laid_out(self, vec, params):
        """A slot ``vec`` (``flat``'s shape) laid out over the leaves of
        ``params`` (a tree shaped like the parameters) in that tree's key
        order, laid out again in this optimizer's: a checkpoint's slots
        follow its own parameters' order (the JAX package's
        ``ravel_pytree`` sorts the keys), which need not be this
        optimizer's."""
        at = 0

        def split(tree):
            nonlocal at
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = split(v)
                else:
                    n = v.numel() // max(1, vec[..., 0].numel())
                    out[k] = vec[..., at:at + n].reshape(v.shape)
                    at += n
            return out

        tree = split(params)
        if at != vec.shape[-1]:
            raise ValueError(f"a slot of {vec.shape[-1]} floats (a lane) "
                             f"for parameters of {at}")
        return self.flatten(tree)

    def _load_slots(self, st, params):
        for name, buf in self.slots.items():
            if tuple(st[name].shape) != tuple(buf.shape):
                raise ValueError(f"{name} is {tuple(st[name].shape)}, this "
                                 f"optimizer's {tuple(buf.shape)}")
            buf.copy_(st[name] if params is None
                      else self.laid_out(st[name], params))

    @torch.no_grad()
    def load_state_dict(self, state_dict, params=None):
        """A ``state_dict`` (e.g. restored from a checkpoint, on any
        device) copied into this optimizer's buffers, and ``params`` (a
        tree shaped like the parameters) into the leaves: the buffers keep
        their addresses, which the leaves' views and a captured CUDA graph
        hold, so nothing is rebound. With ``params`` the slots are read in
        its key order (``laid_out``); an lr of None leaves this
        optimizer's."""
        self._load_slots(state_dict["state"], params)
        if state_dict["lr"] is not None:
            self.set_lr(float(state_dict["lr"]))
        if params is not None:
            flat = self.flatten(params)
            if flat.shape != self.flat.shape:
                raise ValueError(f"the parameters hold {flat.numel()} "
                                 f"floats, this optimizer {self.flat.numel()}")
            self.flat.copy_(flat)


class FlatAdam(_FlatOptimizer):
    """Adam over one flat float32 vector: the JAX package's
    ``optax.flatten(optax.scale_by_adam(eps=1e-8))`` followed by ``p -= lr
    * u`` (b1 0.9, b2 0.999, bias-corrected, one global step count).
    ``flat``, ``mu`` and ``nu`` are views of ``state`` (see
    ``_FlatOptimizer``); a leaf the loss does not reach still has its
    moments and value move on with the count, as optax's do. ``count`` is
    a 0-d int32 tensor beside ``state``, which the divergence gate keeps
    too."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float):
        super().__init__(params, lr, ("mu", "nu"))
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.flat.device)

    @torch.no_grad()
    def step(self):
        """One update from ``grad``, in optax's order: the moments, the
        count, the bias-corrected update, then ``p -= lr * u``."""
        g = self.grad
        self.mu.mul_(self.B1).add_(g, alpha=1.0 - self.B1)
        self.nu.mul_(self.B2).addcmul_(g, g, value=1.0 - self.B2)
        self.count.add_(1)
        c = self.count.to(torch.float32)
        mu_hat = self.mu / (1.0 - self.B1 ** c)
        nu_hat = self.nu / (1.0 - self.B2 ** c)
        u = mu_hat.div_(nu_hat.sqrt_().add_(self.EPS))
        self.flat.sub_(u.mul_(self.lr))

    def state_dict(self):
        """The state of optax's ``ScaleByAdamState`` (count, mu, nu) and
        the lr, copies."""
        out = super().state_dict()
        out["state"] = {"count": self.count.clone(), **out["state"]}
        return out

    @torch.no_grad()
    def load_state_dict(self, state_dict, params=None):
        super().load_state_dict(state_dict, params)
        self.count.copy_(torch.as_tensor(state_dict["state"]["count"])
                         .reshape(()))


class FlatSGD(_FlatOptimizer):
    """SGD with momentum over one flat float32 vector: the JAX package's
    ``optax.flatten(optax.trace(decay=momentum))`` followed by ``p -= lr *
    u``, so ``trace = g + momentum * trace; p -= lr * trace`` (torch's
    ``SGD(momentum=...)`` without dampening). ``flat`` and ``trace`` are
    views of ``state`` (see ``_FlatOptimizer``). It keeps no step count:
    optax's trace has none, and the chunked loop's gate copies one only
    where the optimizer has it."""

    def __init__(self, params, lr: float, momentum: float = 0.9):
        super().__init__(params, lr, ("trace",))
        self.momentum = float(momentum)

    @torch.no_grad()
    def step(self):
        self.trace.mul_(self.momentum).add_(self.grad)
        self.flat.sub_(self.trace * self.lr)


class LaneAdam(FlatAdam):
    """``FlatAdam`` over K lanes of one model (the JAX package's vmapped
    Adam of ``parallel/multiseed.py``): ``params`` is a tree of ``(K,
    ...)`` leaves, lane k's parameters at index k of each. ``flat``,
    ``mu`` and ``nu`` are ``(K, P)`` views of ``state`` (lane k's
    parameters flat in row k, in the leaves' order) and ``grad`` is ``(K,
    P)``; each leaf stays the same tensor with its storage a view of its
    columns of ``flat`` and its ``.grad`` of ``grad``, so the lanes' trees
    are views too. ``lr`` is a ``(K,)`` float32 device vector, one lr a
    lane, as the JAX package's ``(K,)`` lr argument; the update is
    ``FlatAdam``'s, element for element, with lane k's row scaled by
    ``lr[k]``. Each lane keeps its own step count (``count`` is ``(K,)``,
    the JAX package's ``vmap(optimizer.init)``), so ``reset_lanes`` can
    restart a lane (a recycled trial of the evolving search) at count 0
    while the others step on."""

    def __init__(self, params, lrs):
        self.params = params
        ls = leaves(params)
        dev, K = ls[0].device, ls[0].shape[0]
        for leaf in ls:
            if (leaf.dtype != torch.float32 or leaf.device != dev
                    or leaf.dim() < 1 or leaf.shape[0] != K):
                raise ValueError(f"LaneAdam takes float32 leaves on one "
                                 f"device with {K} lanes in front, got "
                                 f"{leaf.dtype} {tuple(leaf.shape)} on "
                                 f"{leaf.device}")
        self.lanes = K
        n = sum(leaf[0].numel() for leaf in ls)
        self.state = torch.zeros((3, K, n), dtype=torch.float32, device=dev)
        self.flat, self.mu, self.nu = self.state.unbind(0)
        self.slots = {"mu": self.mu, "nu": self.nu}
        self.grad = torch.zeros((K, n), dtype=torch.float32, device=dev)
        self.lr = torch.as_tensor(lrs, dtype=torch.float32).reshape(-1).to(
            dev).expand(K).clone()
        self.count = torch.zeros(K, dtype=torch.int32, device=dev)
        at = 0
        with torch.no_grad():
            for leaf in ls:
                k = leaf[0].numel()
                self.flat[:, at:at + k].copy_(leaf.reshape(K, -1))
                leaf.data = self.flat[:, at:at + k].view(leaf.shape)
                leaf.requires_grad_(True)
                leaf.grad = self.grad[:, at:at + k].view(leaf.shape)
                at += k

    def set_lr(self, lr):
        """One lr for every lane, or a sequence of one a lane."""
        self.lr.copy_(torch.as_tensor(lr, dtype=torch.float32).expand(
            self.lanes))

    @torch.no_grad()
    def step(self):
        """``FlatAdam.step`` with lane k's row bias-corrected by its own
        count and scaled by ``lr[k]``."""
        g = self.grad
        self.mu.mul_(self.B1).add_(g, alpha=1.0 - self.B1)
        self.nu.mul_(self.B2).addcmul_(g, g, value=1.0 - self.B2)
        self.count.add_(1)
        c = self.count.to(torch.float32)[:, None]
        mu_hat = self.mu / (1.0 - self.B1 ** c)
        nu_hat = self.nu / (1.0 - self.B2 ** c)
        u = mu_hat.div_(nu_hat.sqrt_().add_(self.EPS))
        self.flat.sub_(u.mul_(self.lr[:, None]))

    @torch.no_grad()
    def reset_lanes(self, lanes):
        """Lanes ``lanes`` (a sequence or a device index tensor) back to a
        fresh Adam: their moments and counts zeroed in place, the other
        lanes untouched (the JAX package's ``opt.init`` of a recycled
        lane)."""
        idx = torch.as_tensor(lanes, dtype=torch.long).to(self.flat.device)
        for buf in (self.mu, self.nu, self.count):
            buf.index_fill_(0, idx, 0)

    def flatten(self, tree):
        """A tree of ``(J, ...)`` leaves shaped like ``params`` but for
        the lane count as one ``(J, P)`` matrix like ``flat``'s rows."""
        def walk(like, t):
            if isinstance(like, dict):
                return [x for k, v in like.items() for x in walk(v, t[k])]
            return [t.detach().reshape(t.shape[0], -1)]

        return torch.cat(walk(self.params, tree), dim=1).to(
            self.flat.device)

    def tree_of(self, mat):
        """A ``(J, P)`` matrix of rows like ``flat``'s as a tree shaped
        like ``params`` but for the lane count, each leaf a copy."""
        def build(tree, at):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k], at = build(v, at)
                else:
                    m = v[0].numel()
                    out[k] = mat[:, at:at + m].reshape(
                        (mat.shape[0], *v.shape[1:])).clone()
                    at += m
            return out, at

        return build(self.params, 0)[0]

    def state_dict(self):
        """Each lane's count (``(K,)``) and moments (``(K, P)``) and the
        lanes' lrs, copies."""
        return {"state": {"count": self.count.clone(),
                          **{k: v.clone() for k, v in self.slots.items()}},
                "lr": [float(v) for v in self.lr]}

    @torch.no_grad()
    def load_state_dict(self, state_dict, params=None):
        """``FlatAdam.load_state_dict`` with the lanes' lrs."""
        st = state_dict["state"]
        self._load_slots(st, params)
        # a snapshot from before the per-lane counts holds one for all
        self.count.copy_(torch.as_tensor(st["count"]).reshape(-1).expand(
            self.lanes))
        if state_dict["lr"] is not None:
            self.set_lr(state_dict["lr"])
        if params is not None:
            flat = self.flatten(params)
            if flat.shape != self.flat.shape:
                raise ValueError(f"the parameters are {tuple(flat.shape)}, "
                                 f"this optimizer's {tuple(self.flat.shape)}")
            self.flat.copy_(flat)


def make_optimizer(params, lr: float, name: str = "adam",
                   momentum: float = 0.9):
    """The flat optimizer ``name`` over ``params`` (``FlatAdam`` or
    ``FlatSGD`` with ``momentum``), starting at ``lr``; the scheduler
    changes its lr freely. An unknown name raises, as the JAX package's
    ``make_optimizer``."""
    if name == "adam":
        return FlatAdam(params, lr)
    if name == "sgd":
        return FlatSGD(params, lr, momentum)
    raise ValueError(f"unknown optimizer {name!r}")


def leaves(tree):
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


# ------------------------------------------------------- epoch machinery

# Epochs run between two reads of the chunked loop's records by the host,
# as the JAX package's; FACTORIZED_TPU_EPOCH_CHUNK overrides it
DEFAULT_EPOCH_CHUNK = 10


class TrainProgram:
    """The train step, epoch and evaluation for one (model, cfg):

    - ``step(params, optimizer, x, y, generator, lr=None)`` -> the batch's
      tracked loss (a 0-d tensor; the host does not wait for it);
    - ``epoch(params, optimizer, Xb, yb, generator, lr=None)`` -> the
      mean tracked loss over the nb batches ``Xb[i]``, ``yb[i]``;
    - ``train_epoch(...)`` -> ``epoch`` plus the optional remainder
      batch, a tensor; ``run_epoch(...)`` the same as a float;
    - ``evaluate(params, x, y, generator)`` -> the full-set validation
      loss of the variant.

    A step's phases are spans (``utils.profiling``): ``step.forward``
    (the loss), ``step.backward`` (with a data group's all-reduce of the
    gradient) and ``step.optimizer``; ``evaluate`` is ``epoch.eval``.

    ``optimizer`` is a ``FlatAdam`` or ``FlatSGD``; an ``lr`` given sets
    its lr first,
    else its lr tensor is read as it stands.

    ``data``: the data group of a data-parallel step
    (``parallel.sharding.Group``, ``DataParallel.program``), None for one
    process. Each rank's ``x``, ``y`` are its rows of the global batch;
    its loss is scaled by its share and computed under the group
    (``ops.rows``: the global batch's draws, the MMD of the whole batch),
    and between ``backward`` and the update the flat gradient is summed
    over the group in place, in one all-reduce (the tracked loss in a
    second, of a few floats), so every rank applies the update of the
    global batch. The step runs eagerly
    (``collective``: ``ChunkedLoop`` captures no graph of it).
    """

    def __init__(self, apply_fn, cfg, variant: str = "joint", stage: int = 0,
                 loss_fn=None, eval_fn=None, data=None):
        self.cfg = cfg
        self.loss_fn = loss_fn or make_loss_fn(apply_fn, cfg, variant, stage)
        self.eval_fn = eval_fn or make_eval_fn(apply_fn, cfg, variant)
        self.data = data
        self.collective = data is not None

    def step(self, params, optimizer, x, y, generator, lr=None):
        if lr is not None:
            optimizer.set_lr(lr)
        optimizer.zero_grad()
        data = self.data
        if data is None:
            with span("step.forward"):
                loss, tracked = self.loss_fn(params, x, y,
                                             generator=generator)
            with span("step.backward"):
                loss.backward()
        else:
            with data.rows():
                with span("step.forward"):
                    loss, tracked = self.loss_fn(params, x, y,
                                                 generator=generator)
                with span("step.backward"):
                    (loss * data.share).backward()
            with span("step.backward"):
                data.all_reduce_(optimizer.grad)
            tracked = data.all_reduce_(tracked.detach() * data.share)
        with span("step.optimizer"):
            optimizer.step()
        return tracked.detach()

    def epoch(self, params, optimizer, Xb, yb, generator, lr=None):
        if lr is not None:
            optimizer.set_lr(lr)
        acc = torch.zeros((), dtype=torch.float32, device=Xb.device)
        for x, y in zip(Xb, yb):
            acc = acc + self.step(params, optimizer, x, y, generator)
        return acc / Xb.shape[0]

    def evaluate(self, params, x, y, generator):
        with span("epoch.eval"), torch.no_grad():
            return self.eval_fn(params, x, y, generator=generator)

    def train_epoch(self, params, optimizer, Xb, yb, generator, lr=None,
                    remainder=None):
        """One epoch and the optional ragged remainder batch; the
        remainder's tracked loss is divided by nb like the full batches'
        (the reference sums nb + 1 batches and divides by nb)."""
        nb = Xb.shape[0]
        acc = self.epoch(params, optimizer, Xb, yb, generator, lr)
        if remainder is not None and remainder[0].shape[1] > 0:
            rx, ry = remainder
            acc = acc + self.step(params, optimizer, rx, ry, generator) / nb
        return acc

    def run_epoch(self, params, optimizer, Xb, yb, generator, lr=None,
                  remainder=None) -> float:
        return float(self.train_epoch(params, optimizer, Xb, yb, generator,
                                      lr, remainder))


@functools.lru_cache(maxsize=None)
def _driver():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphUpload.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cuGraphUpload.restype = ctypes.c_int
    return lib


def _cu(result, call):
    if result:
        raise RuntimeError(f"{call} failed: CUresult {result}")


def graph_nodes(graph) -> int:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` that still holds
    its graph (``keep_graph=True``): the driver's ``cuGraphGetNodes``.
    (Counting them by kind takes a driver call a node through ctypes:
    57-60 ms for the 37,903 nodes of ``best_acc_mosi_config``'s epoch on
    an H100 machine's host, 4% of the capture, so it is not done.)"""
    n = ctypes.c_size_t(0)
    _cu(_driver().cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                  None, ctypes.byref(n)), "cuGraphGetNodes")
    return n.value


def upload_graph(graph, stream):
    """Upload an instantiated ``torch.cuda.CUDAGraph`` to the device in
    ``stream`` (``cuGraphUpload``), so that its first replay launches as
    cheaply as every later one."""
    _cu(_driver().cuGraphUpload(ctypes.c_void_p(graph.raw_cuda_graph_exec()),
                                ctypes.c_void_p(stream.cuda_stream)),
        "cuGraphUpload")


class Graphed:
    """``fn()`` (no arguments, no result: it reads and writes tensors that
    live as long as this object) as one CUDA graph.

    The first call runs fn eagerly on the graph's stream (span
    ``graph.eager``, the host's time to queue it): the warm-up, in which
    the kernel library loads, cuBLAS makes its handle and each chain
    kernel's shared memory is allowed (``lstm_common.cuh::allow_smem``),
    none of which may happen under capture. The second call captures fn
    and replays it; every later call replays it (span ``graph.replay``,
    the host's launch). The capture (span ``graph.capture``) is three
    spans: ``capture.prepare`` (a collection, a synchronize and
    ``empty_cache``), ``capture.record`` (fn under ``torch.cuda.graph``)
    and ``capture.instantiate`` (the instantiation and its upload to the
    device, ``upload_graph``, which the first replay would do otherwise);
    between the last two the graph's nodes are counted (``nodes``,
    ``graph_nodes``), so the graph is made with ``keep_graph=True`` and
    instantiated apart. The ``generators`` fn draws from are registered
    with the graph, so each replay draws on from where the generator
    stands, the draws an eager call would make.
    A replay adds the launches the capture counted to the wrappers'
    counters (``ops.counts``). ``capture_ms`` (the ``graph.capture``
    span's host milliseconds), ``pool_bytes`` (the device memory the
    capture reserved, the graph's pool) and ``nodes`` are kept, the last
    two also as the capture span's attributes. A failed capture or
    replay raises: nothing runs fn eagerly in its place.
    ``capture_error_mode`` is ``torch.cuda.graph``'s: "global" fails the
    capture on another thread's unsafe CUDA call too, "thread_local" (a
    server's worker thread) only on this thread's."""

    def __init__(self, fn, generators=(), capture_error_mode="global"):
        self.fn = fn
        self.generators = tuple(generators)
        self.capture_error_mode = capture_error_mode
        self.stream = torch.cuda.Stream()
        self.graph = None
        self.warm = False
        self.launches = None
        self.capture_ms = None
        self.pool_bytes = None
        self.nodes = None

    def __call__(self):
        if self.graph is None:
            if not self.warm:
                with span("graph.eager"):
                    self.stream.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(self.stream):
                        self.fn()
                    torch.cuda.current_stream().wait_stream(self.stream)
                self.warm = True
                return
            self._capture()
        with span("graph.replay"):
            self.graph.replay()
        counts.add(self.launches)

    def _capture(self):
        with span("graph.capture") as cap:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            for generator in self.generators:
                graph.register_generator_state(generator)
            before = counts.snapshot()
            with span("capture.prepare"):
                # a dead graph left in a reference cycle (an earlier
                # program's loop) is freed here, not by a collection
                # during the capture, where freeing its pool breaks the
                # capture
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with span("capture.record"), torch.cuda.graph(
                        graph, stream=self.stream,
                        capture_error_mode=self.capture_error_mode):
                    self.fn()
            finally:
                if collecting:
                    gc.enable()
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            # the capture launched nothing: its counts are the replays'
            self.launches = counts.since(before)
            counts.restore(before)
            self.nodes = graph_nodes(graph)
            with span("capture.instantiate"):
                graph.instantiate()
                upload_graph(graph, torch.cuda.current_stream())
            cap.attrs.update(nodes=self.nodes, pool_bytes=self.pool_bytes)
        self.capture_ms = cap.seconds * 1e3
        self.graph = graph


class ChunkedLoop:
    """The JAX package's chunked training loop
    (``factorized_tpu/train.py::_compile_chunked_loop``) for one program,
    over device-resident batches, one flat optimizer and the device state of
    the scheduler (``utils.scheduler.plateau_step``) and the best-keeper
    (``utils.checkpoint.keeps``). One epoch (``body``):

    - a copy of the optimizer's state and count (Adam's; ``FlatSGD`` has
      none), the epoch's start;
    - the nb train steps on ``Xb[i]``, ``yb[i]``, read in place, and the
      optional remainder step, its tracked loss divided by nb;
    - the full-set eval;
    - ``ok = alive & isfinite(train) & isfinite(valid)``;
    - the divergence gate: once an epoch was not ok (``alive`` off), each
      later epoch is computed and thrown away, the parameters, moments
      and count coming back from the epoch's start: the state where the
      host loop's break leaves it, as ``lax.cond``'s ``hold``;
    - the best-keeper's select, one ``torch.where(take, flat,
      best_flat)``, and the plateau step, gated by ``ok``;
    - a row (tracked, valid, lr, saved, ok), float64, into ``records``;
      the lr is the float32 one the step read, as the JAX package's
      chunked loop records it.

    On a CUDA card the body is a ``Graphed``: the first epoch runs
    eagerly, then each epoch is one graph replay. On the CPU, and for a
    data-parallel program (its steps all-reduce), each epoch runs the
    body eagerly. ``load`` mirrors the host scheduler and keeper
    in, ``run(n)`` runs n epochs and reads their records once (spans
    ``loop.run``, with its ``epochs``, and ``loop.read``, the host
    waiting on the card), ``store``
    mirrors them back out. ``epoch_launches`` holds each epoch's kernel
    launches (``ops.counts.since``)."""

    def __init__(self, program, params, optimizer, Xb, yb, remainder, Xv, yv,
                 generator, *, epochs, mode="min", save_always=False,
                 sched_kw=()):
        dev = optimizer.flat.device
        self.program, self.params, self.opt = program, params, optimizer
        if remainder is not None and remainder[0].shape[1] == 0:
            remainder = None
        self.batches = (Xb, yb, remainder)
        self.valid_set = (Xv, yv)
        self.generator = generator
        self.mode, self.save_always = mode, save_always
        self.sched_kw = dict(sched_kw)

        def zero(dtype):
            return torch.zeros((), dtype=dtype, device=dev)

        self.sched = {"lr": optimizer.lr, "best": zero(torch.float32),
                      "bad": zero(torch.int32),
                      "cooldown": zero(torch.int32)}
        self.best = zero(torch.float32)
        self.best_flat = torch.zeros_like(optimizer.flat)
        self.alive = zero(torch.bool)
        self.start = torch.empty_like(optimizer.state)
        self.step_count = getattr(optimizer, "count", None)
        self.start_count = (None if self.step_count is None
                            else torch.empty_like(self.step_count))
        self.records = torch.zeros((epochs, 5), dtype=torch.float64,
                                   device=dev)
        self.slot = zero(torch.int64)
        self.epoch = (Graphed(self.body, (generator,))
                      if dev.type == "cuda" and not program.collective
                      else self.body)
        self.epoch_launches = []

    def load(self, scheduler, keeper):
        """The host scheduler's and keeper's state into the device state;
        the run is alive."""
        self.opt.set_lr(scheduler.lr)
        self.sched["best"].fill_(scheduler.best)
        self.sched["bad"].fill_(scheduler.num_bad_epochs)
        self.sched["cooldown"].fill_(scheduler.cooldown_counter)
        self.best.fill_(keeper.best)
        if keeper.best_params is None:
            self.best_flat.zero_()
        else:
            self.best_flat.copy_(self.opt.flatten(keeper.best_params))
        self.alive.fill_(True)

    def body(self):
        opt, (Xb, yb, rem), (Xv, yv) = self.opt, self.batches, self.valid_set
        self.start.copy_(opt.state)
        if self.step_count is not None:
            self.start_count.copy_(self.step_count)
        acc = self.program.train_epoch(self.params, opt, Xb, yb,
                                       self.generator, remainder=rem)
        valid = self.program.evaluate(self.params, Xv, yv, self.generator)
        with torch.no_grad():
            alive = self.alive
            ok = alive & torch.isfinite(acc) & torch.isfinite(valid)
            opt.state.copy_(torch.where(alive, opt.state, self.start))
            if self.step_count is not None:
                self.step_count.copy_(torch.where(alive, self.step_count,
                                                  self.start_count))
            take = keeps(valid, self.best, ok, self.mode, self.save_always)
            self.best.copy_(torch.where(take, valid, self.best))
            self.best_flat.copy_(torch.where(take, opt.flat, self.best_flat))
            new = plateau_step(self.sched, valid, **self.sched_kw)
            for k, v in new.items():
                self.sched[k].copy_(torch.where(ok, v, self.sched[k]))
            self.alive.copy_(ok)
            row = torch.stack([acc.double(), valid.double(),
                               self.sched["lr"].double(),
                               take.double(), ok.double()])
            self.records.index_copy_(0, self.slot.view(1), row.view(1, 5))
            self.slot.add_(1)

    def run(self, n: int):
        """n epochs, then one read of their records: a (n, 5) float64
        array of (tracked, valid, lr, saved, ok)."""
        with span("loop.run", epochs=n):
            self.slot.zero_()
            for _ in range(n):
                before = counts.snapshot()
                self.epoch()
                self.epoch_launches.append(counts.since(before))
            with span("loop.read"):
                return self.records[:n].cpu().numpy()

    def store(self, scheduler, keeper, saved: bool):
        """The device state back into the host scheduler and, where an
        epoch was saved, the keeper."""
        if saved:
            keeper.best = float(self.best)
            keeper.best_params = self.opt.tree_of(self.best_flat.cpu())
        scheduler.lr = float(self.sched["lr"])
        scheduler.best = float(self.sched["best"])
        scheduler.num_bad_epochs = int(self.sched["bad"])
        scheduler.cooldown_counter = int(self.sched["cooldown"])
