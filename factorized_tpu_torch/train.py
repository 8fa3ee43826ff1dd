"""Training core of the port (port of ``factorized_tpu/train.py``, the
``"joint"``, ``"beta_vae"``, ``"missing"``, ``"s2s"`` and ``"bm"``
variants).

A train step is the model's forward with dropout, the variant's loss
(for ``"joint"``: ``disc + gen + lda_mmd * mmd``, the L1 label loss, the
three weighted reconstruction MSEs and the MMD regulariser),
``backward`` through the hand-written backward kernels, and one Adam
update over the flat parameter vector (``FlatAdam``: the semantics of
``optax.flatten(optax.scale_by_adam(eps=1e-8))`` followed by ``p -= lr *
u``). Parameters are a nested dict of leaf tensors, views of that
vector, updated in place. An epoch is a Python loop over device-resident
batches (``TrainProgram``); ``ChunkedLoop`` is the JAX package's chunked
loop of whole epochs with the eval, the best-keeper's select, the
plateau scheduler and the divergence gate on the device, each epoch on
a CUDA card one replay of a CUDA graph (``Graphed``).
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import numpy as np
import torch

from factorized_tpu_torch.ops import counts
from factorized_tpu_torch.ops.losses import (cross_entropy_loss, l1_loss,
                                             l2_loss)
from factorized_tpu_torch.utils.checkpoint import keeps
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

class FlatAdam:
    """Adam over one flat float32 vector: the JAX package's
    ``optax.flatten(optax.scale_by_adam(eps=1e-8))`` followed by ``p -= lr
    * u`` (b1 0.9, b2 0.999, bias-corrected, one global step count).

    Building it moves the leaves of ``params`` into one buffer: each leaf
    stays the same tensor, of the same shape and ``(d_in, d_out)`` layout,
    requiring grad, with its storage a view of ``flat`` and its ``.grad``
    a view of ``grad``; so the models, ``convert.py`` and the checkpoints
    see the same nested dict. ``zero_grad`` zeroes ``grad`` (never to
    None) and backward adds into it in place, so a leaf the loss does not
    reach gets a zero gradient, as under ``jax.grad``, and its moments
    and value move on with the count, as optax's do. ``flat``, ``mu`` and
    ``nu`` are views of one buffer, ``state``, which the chunked loop's
    divergence gate copies whole. ``lr`` is a 0-d float32 tensor on the
    parameters' device that ``step`` reads, so a captured CUDA graph
    reads the lr of the moment, not the one of its capture; float32, as
    the JAX package's chunked loop keeps it (the product ``lr * u`` is
    float32 whatever the lr's type, so the update is the same)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float):
        self.params = params
        ls = leaves(params)
        dev = ls[0].device
        for leaf in ls:
            if leaf.dtype != torch.float32 or leaf.device != dev:
                raise ValueError(f"FlatAdam takes float32 leaves on one "
                                 f"device, got {leaf.dtype} on "
                                 f"{leaf.device}")
        n = sum(leaf.numel() for leaf in ls)
        self.state = torch.zeros(3 * n, dtype=torch.float32, device=dev)
        self.flat, self.mu, self.nu = self.state.split(n)
        self.grad = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
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
        """The state of optax's ``ScaleByAdamState`` (count, mu, nu; the
        moments flat, in the leaves' order) and the lr, copies."""
        return {"state": {"count": self.count.clone(), "mu": self.mu.clone(),
                          "nu": self.nu.clone()},
                "lr": float(self.lr)}

    @torch.no_grad()
    def load_state_dict(self, state_dict, params=None):
        """A ``state_dict`` (e.g. restored from a checkpoint, on any
        device) copied into this optimizer's buffers, and ``params`` (a
        tree shaped like the parameters) into the leaves: the buffers keep
        their addresses, which the leaves' views and a captured CUDA graph
        hold, so nothing is rebound."""
        st = state_dict["state"]
        for name, buf in (("mu", self.mu), ("nu", self.nu)):
            if tuple(st[name].shape) != tuple(buf.shape):
                raise ValueError(f"{name} is {tuple(st[name].shape)}, this "
                                 f"optimizer's {tuple(buf.shape)}")
            buf.copy_(st[name])
        self.count.copy_(torch.as_tensor(st["count"]).reshape(()))
        self.set_lr(float(state_dict["lr"]))
        if params is not None:
            flat = self.flatten(params)
            if flat.shape != self.flat.shape:
                raise ValueError(f"the parameters hold {flat.numel()} "
                                 f"floats, this optimizer {self.flat.numel()}")
            self.flat.copy_(flat)


def make_optimizer(params, lr: float) -> FlatAdam:
    """The flat Adam over ``params`` (see ``FlatAdam``), starting at
    ``lr``; the scheduler changes its lr freely."""
    return FlatAdam(params, lr)


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

    ``optimizer`` is a ``FlatAdam``; an ``lr`` given sets its lr first,
    else its lr tensor is read as it stands.
    """

    def __init__(self, apply_fn, cfg, variant: str = "joint", stage: int = 0,
                 loss_fn=None, eval_fn=None):
        self.cfg = cfg
        self.loss_fn = loss_fn or make_loss_fn(apply_fn, cfg, variant, stage)
        self.eval_fn = eval_fn or make_eval_fn(apply_fn, cfg, variant)

    def step(self, params, optimizer, x, y, generator, lr=None):
        if lr is not None:
            optimizer.set_lr(lr)
        optimizer.zero_grad()
        loss, tracked = self.loss_fn(params, x, y, generator=generator)
        loss.backward()
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
        with torch.no_grad():
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


class Graphed:
    """``fn()`` (no arguments, no result: it reads and writes tensors that
    live as long as this object) as one CUDA graph.

    The first call runs fn eagerly on the graph's stream: the warm-up, in
    which the kernel library loads, cuBLAS makes its handle and each chain
    kernel's shared memory is allowed (``lstm_common.cuh::allow_smem``),
    none of which may happen under capture. The second call captures fn
    and replays it; every later call replays it. The ``generators`` fn
    draws from are registered with the graph, so each replay draws on from
    where the generator stands, the draws an eager call would make. A
    replay adds the launches the capture counted to the wrappers' counters
    (``ops.counts``). ``capture_ms`` (host clock) and ``pool_bytes`` (the
    device memory the capture reserved, the graph's pool) are kept. A
    failed capture or replay raises: nothing runs fn eagerly in its
    place. ``capture_error_mode`` is ``torch.cuda.graph``'s: "global"
    fails the capture on another thread's unsafe CUDA call too,
    "thread_local" (a server's worker thread) only on this thread's."""

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

    def __call__(self):
        if self.graph is None:
            if not self.warm:
                self.stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self.stream):
                    self.fn()
                torch.cuda.current_stream().wait_stream(self.stream)
                self.warm = True
                return
            self._capture()
        self.graph.replay()
        counts.add(self.launches)

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = counts.snapshot()
        # a dead graph left in a reference cycle (an earlier program's
        # loop) is freed here, not by a collection during the capture,
        # where freeing its pool breaks the capture
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        collecting = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            with torch.cuda.graph(
                    graph, stream=self.stream,
                    capture_error_mode=self.capture_error_mode):
                self.fn()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        # the capture launched nothing: its counts are the replays'
        self.launches = counts.since(before)
        counts.restore(before)
        self.graph = graph


class ChunkedLoop:
    """The JAX package's chunked training loop
    (``factorized_tpu/train.py::_compile_chunked_loop``) for one program,
    over device-resident batches, one ``FlatAdam`` and the device state of
    the scheduler (``utils.scheduler.plateau_step``) and the best-keeper
    (``utils.checkpoint.keeps``). One epoch (``body``):

    - a copy of the optimizer's state and count, the epoch's start;
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
    eagerly, then each epoch is one graph replay. On the CPU each epoch
    runs the body eagerly. ``load`` mirrors the host scheduler and keeper
    in, ``run(n)`` runs n epochs and reads their records once, ``store``
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
        self.start_count = torch.empty_like(optimizer.count)
        self.records = torch.zeros((epochs, 5), dtype=torch.float64,
                                   device=dev)
        self.slot = zero(torch.int64)
        self.epoch = (Graphed(self.body, (generator,)) if dev.type == "cuda"
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
        self.start_count.copy_(opt.count)
        acc = self.program.train_epoch(self.params, opt, Xb, yb,
                                       self.generator, remainder=rem)
        valid = self.program.evaluate(self.params, Xv, yv, self.generator)
        with torch.no_grad():
            alive = self.alive
            ok = alive & torch.isfinite(acc) & torch.isfinite(valid)
            opt.state.copy_(torch.where(alive, opt.state, self.start))
            opt.count.copy_(torch.where(alive, opt.count, self.start_count))
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
        self.slot.zero_()
        for _ in range(n):
            before = counts.snapshot()
            self.epoch()
            self.epoch_launches.append(counts.since(before))
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
