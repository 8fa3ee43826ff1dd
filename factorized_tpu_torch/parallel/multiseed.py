"""Lanes of seeds: K models of one configuration trained at once on one
card (port of ``factorized_tpu/parallel/multiseed.py``, ``--seeds K``).

The reference's production workload is a random search of small models,
trained one at a time; at batch 32 one model leaves most of the card
idle. Here K seeds of one configuration train as K lanes of one program:
the model's train step runs under ``torch.func.vmap`` over the stacked
``(K, ...)`` parameters, and each recurrent kernel of the step
(``cuda_mfn``'s encode forward, reverse pass and weight gradients,
``cuda_lstm``'s decoder and encoder-cell chains, each way) runs all K
lanes in one launch, its lane axis the grid's z (the kernels' vmap rules:
``cuda_mfn.VmapEncode``, ``cuda_lstm.VmapDecoderLSTM`` and
``VmapMultiLSTM``); the glue around them is batched PyTorch. Each lane
keeps the semantics of ``trainers.train_mfm``: the same loss, Adam
(``train.LaneAdam``, one lr a lane), its own plateau scheduler
(``utils.scheduler.plateau_step`` on ``(K,)`` tensors, stepped as a
minimum whatever the valid metric, a quirk of the reference kept), its
own best-valid keeper (``>=`` on accuracy, ``<=`` on a loss) and its own
test score.

An epoch (``LaneLoop.body``) is the train steps over the batches, the
per-lane evaluation, the per-lane select of the best parameters and the
per-lane plateau step, all on the device; on a CUDA card the first epoch
runs eagerly and each later one is one CUDA-graph replay
(``train.Graphed``), and the host reads a chunk's records once. Every
random draw (the dropout masks, the MMD samples, the evaluation's draws)
comes from one ``torch.Generator`` under vmap's ``randomness=
"different"``'s layout: each lane and batch draws its own, lane k's
the k-th of one draw for all K lanes (``ops.rows.draw``, under
``randomness="same"`` with the lane's index handed in).
``LanePrograms.step`` takes the draws of each lane instead where they
are handed in (the apply functions' injection points with a lane
dimension in front).

Across ranks (``mesh=``, a ``parallel.sharding.Mesh``): over a 1-D
``"seed"`` (or ``"data"``) mesh of n ranks, rank r trains lanes ``[r K
/ n, (r + 1) K / n)``, lane k initialised from ``_run_seed(seed, k)``
and drawing the k-th of the K lanes' draws, so the lanes are those of
one process; no collective runs inside an epoch, which stays one graph
replay. Over a 2-D ``("seed", "batch")`` mesh each lane group also
trains data-parallel over its ``batch`` slice: its rows of every batch,
the global batch's draws and MMD, the gradient all-reduced each step
(eager). The records, results and parameters are gathered so every rank
returns what one process returns; rank 0 alone writes the logs and
snapshots (``LaneShard``).
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.models.registry import MODELS
from factorized_tpu_torch.ops import counts, rows
from factorized_tpu_torch.parallel import sharding
from factorized_tpu_torch.train import (DEFAULT_EPOCH_CHUNK, Graphed,
                                        LaneAdam, make_batches, make_eval_fn,
                                        make_loss_fn, shuffle_and_time_major)
from factorized_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.metrics import (score_classification,
                                                score_regression)
from factorized_tpu_torch.utils.profiling import note_trial, span, trial
from factorized_tpu_torch.utils.scheduler import plateau_step

# Types whose apply returns the standard (decoded, reg, missing) tuple
# trained with the single-stage joint loss, the only semantics the lane
# trainer implements; kl_ef (two stages), missing and zeros (their
# four-way losses), s2s and bm have their own trainers, and routing them
# here would change their training, so they are refused.
MULTISEED_TYPES = ("mfm", "kl", "m_a", "m_b", "m_c", "m_d")
# rows of a test predict at once (the JAX package's
# FACTORIZED_PREDICT_CHUNK default); the chunk changes no value
PREDICT_CHUNK = 1024


def _run_seed(*tags):
    """A generator seed from the run's seed and a place in it (the part of
    the JAX package's ``fold_in``), as the trainers derive theirs."""
    return int(np.random.SeedSequence(list(tags)).generate_state(1)[0])


def data_fingerprint(X_train, X_valid, X_test, device, y_train=None,
                     y_valid=None, y_test=None):
    """A cheap identity of the dataset arrays and of the device or mesh
    (the JAX package's ``data_fingerprint``): each array's shape and dtype
    with a hash of its first two rows, the labels hashed whole; a mesh
    (``sharding.Mesh``) by its world ranks and axis names."""
    import hashlib

    def sig(a, full=False):
        if a is None:
            return None
        a = np.asarray(a)
        sample = a if full else a[:2]
        probe = np.ascontiguousarray(sample).tobytes() if a.size else b""
        return (tuple(a.shape), str(a.dtype),
                hashlib.sha1(probe).hexdigest()[:16])

    where = (str(device) if not isinstance(device, sharding.Mesh) else
             (tuple(int(r) for r in device.devices.flat), device.axis_names))
    return (sig(X_train), sig(X_valid), sig(X_test), sig(y_train, True),
            sig(y_valid, True), sig(y_test, True), where)


def prepare_bucket_data(X_train, y_train, X_valid, y_valid, X_test, y_test,
                        rep, *, seed: int = 123, device=None, mesh=None):
    """The dataset on the device once for the lane programs: the training
    set shuffled once (``seed``) and cut into full batches of
    ``rep.batchsize`` (no remainder batch), the validation and test sets
    time-major, the labels int32 for classification and float32
    otherwise. Returns {"Xb", "yb", "Xv", "yv", "Xte"} on the device,
    "yte" on the host, and "seed", "batchsize", "task" and the arrays'
    ``data_fingerprint`` (of the mesh where there is one). On a mesh with
    a ``"batch"`` axis ``Xb`` and ``yb`` hold this rank's columns of
    each batch; the batch must divide the axis. Span: ``lanes.data``."""
    with span("lanes.data"):
        dev = resolve_device(device)
        arrays = (X_train, X_valid, X_test, y_train, y_valid, y_test)
        X_train, y_train = shuffle_and_time_major(X_train, y_train, seed)
        Xv = np.ascontiguousarray(np.asarray(X_valid).swapaxes(0, 1),
                                  np.float32)
        Xte = np.ascontiguousarray(np.asarray(X_test).swapaxes(0, 1),
                                   np.float32)
        dtype = np.int32 if rep.task == "classification" else np.float32
        yv = np.asarray(y_valid).astype(dtype)
        yte = np.asarray(y_test).astype(dtype)
        Xb, yb, _ = make_batches(X_train, np.asarray(y_train).astype(dtype),
                                 rep.batchsize, False)
        if mesh is not None and "batch" in mesh.axis_names:
            b_dev = mesh.shape["batch"]
            if rep.batchsize % b_dev:
                raise ValueError(
                    f"batchsize={rep.batchsize} must divide the mesh "
                    f"'batch' axis ({b_dev})")
            b, j = rep.batchsize // b_dev, mesh.coords["batch"]
            Xb, yb = Xb[:, :, j * b:(j + 1) * b], yb[:, j * b:(j + 1) * b]

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        Xb = on(Xb)
        return {"Xb": Xb, "yb": on(yb), "Xv": on(Xv), "yv": on(yv),
                "Xte": on(Xte), "yte": yte, "seed": seed,
                "batchsize": rep.batchsize, "task": rep.task,
                "fingerprint": data_fingerprint(
                    *arrays[:3], Xb.device if mesh is None else mesh,
                    *arrays[3:])}


def init_lanes(name: str, cfg, seed: int, n_seeds: int, device=None,
               lanes=None):
    """K initialisations of model ``name``, lane k's from a generator
    seeded from (``seed``, k), stacked into one tree of ``(K, ...)``
    leaves on the device; ``lanes``: those lanes alone (a rank's). Span:
    ``lanes.init``."""
    with span("lanes.init"):
        init, _ = get_model(name)
        trees = [init(torch.Generator().manual_seed(_run_seed(seed, k)), cfg)
                 for k in (range(n_seeds) if lanes is None else lanes)]
        dev = resolve_device(device)
        return pytree.tree_map(lambda *xs: torch.stack(xs).to(dev), *trees)


def stack_lanes(trees, device=None):
    """Trees of one model, one a lane, as one tree of ``(K, ...)``
    leaves."""
    dev = resolve_device(device)
    return pytree.tree_map(
        lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]).to(
            device=dev, dtype=torch.float32), *trees)


def take_lane(tree, k: int):
    """Lane ``k`` of a tree of ``(K, ...)`` leaves, copies on the CPU."""
    return pytree.tree_map(lambda a: a[k].detach().cpu().clone(), tree)


def take_lanes(tree, idxs):
    """Lanes ``idxs`` (a sequence or an index tensor) of a tree of ``(K,
    ...)`` leaves: a tree of ``(len(idxs), ...)`` leaves on the tree's
    device (the JAX package's ``_take_lanes``)."""
    def take(a):
        idx = torch.as_tensor(idxs, dtype=torch.long).to(a.device)
        return a.detach().index_select(0, idx)

    return pytree.tree_map(take, tree)


class LaneShard:
    """Which of ``K`` lanes this rank trains (``lanes``, ``[lo, hi)``) and
    the gathers that give every rank all K lanes' results. Without a mesh
    all K lanes and no collective. On a mesh's ``"seed"`` (else
    ``"data"``) axis of n ranks, the rank at i on it holds lanes ``[i K /
    n, (i + 1) K / n)``, ``group`` that axis's slice, and ``batch`` the
    data group of its ``"batch"`` slice (None where it is one rank). K
    must divide the axis (``must_divide``: the message's start, the JAX
    package's). A rank outside the mesh (``member`` False) trains nothing
    and gets rank 0's result (``share_result``); ``writer`` is world rank
    0, which alone writes."""

    def __init__(self, mesh, K: int, must_divide: str):
        self.K, self.mesh = K, mesh
        self.lo, self.hi = 0, K
        self.group = self.batch = None
        self.member = mesh is None or mesh.member
        self.writer = sharding.is_writer()
        if mesh is None:
            return
        ax = "seed" if "seed" in mesh.axis_names else "data"
        n = mesh.shape[ax]
        if K % n:
            raise ValueError(f"{must_divide} must divide the mesh {ax!r} "
                             f"axis ({n})")
        if not self.member:
            return
        i = mesh.coords[ax]
        self.lo, self.hi = i * K // n, (i + 1) * K // n
        self.group = mesh.group(ax)
        if "batch" in mesh.axis_names and mesh.shape["batch"] > 1:
            self.batch = mesh.group("batch")

    @property
    def lanes(self):
        return range(self.lo, self.hi)

    def mine(self, lanes):
        """The positions in ``lanes`` (global indices) of this rank's."""
        return [p for p, k in enumerate(lanes) if self.lo <= k < self.hi]

    def bind(self, programs):
        """``programs`` (``LanePrograms``) drawing as lanes ``lanes`` of K
        and stepping data-parallel over ``batch``."""
        programs.n_lanes = self.K
        programs.first_lane = self.lo
        programs.batch = self.batch
        programs.shard = self
        return programs

    def gather(self, t, dim=0):
        """The lanes' ``t`` (this rank's along ``dim``) of every rank, all
        K in lane order; a numpy array stays one."""
        if self.group is None:
            return t
        if isinstance(t, np.ndarray):
            return self.gather(torch.from_numpy(t), dim).numpy()
        return self.group.all_gather(t.contiguous(), dim)

    def gather_list(self, items):
        """This rank's per-lane list joined with every rank's, in lane
        order."""
        if self.group is None:
            return list(items)
        return [x for part in self.group.gather_objects(list(items))
                for x in part]

    def logger(self, logger):
        """``logger`` on the writer, a silent one elsewhere."""
        return logger if self.writer else RunLogger(echo=False)

    def share_result(self, out):
        """The ranks of the world outside the mesh get rank 0's ``out``
        (without its live ``state``); the others keep their own."""
        if self.mesh is None or not self.mesh.partial:
            return out
        box = [None if out is None else
               {k: v for k, v in out.items() if k != "state"}]
        torch.distributed.broadcast_object_list(box, src=0)
        return out if self.member else box[0]


def _dims(tree):
    """vmap's in_dims for a tree of per-lane tensors (None leaves
    unbatched)."""
    return pytree.tree_map(
        lambda v: 0 if isinstance(v, torch.Tensor) else None, tree)


class LanePrograms:
    """The K-lane programs of one (model, cfg), the JAX package's
    ``_init_lane_programs``: ``step`` (one train step of every lane),
    ``epoch``, ``evaluate`` (each lane's validation metric: its label
    loss, or with ``valid_metric="accuracy"`` its accuracy), ``predict``
    (each lane's y_hat in chunks of ``PREDICT_CHUNK`` rows) and
    ``select``. ``generator`` gives every draw (see the module's doc).
    ``step`` and ``epoch`` take an optional ``(K, n_hp)`` matrix of lane
    values, lane k's row handed to ``lane_loss`` under vmap (the
    config-bucketed search's ``multiconfig.ConfigBucketProgram``); the
    evaluation and the predict stay on ``cfg``. Spans, as
    ``train.TrainProgram``'s: ``step.forward``, ``step.backward``,
    ``step.optimizer`` a step, ``epoch.eval``; ``predict`` is
    ``trainer.score``."""

    def __init__(self, apply_fn, cfg, generator, valid_metric="loss"):
        if valid_metric not in ("loss", "accuracy"):
            raise ValueError(f"valid_metric must be 'loss' or 'accuracy', "
                             f"got {valid_metric!r}")
        self.cfg, self.apply_fn = cfg, apply_fn
        self.generator = generator
        self.valid_metric = valid_metric
        self.loss_fn = make_loss_fn(apply_fn, cfg, "joint")
        self.eval_fn = make_eval_fn(apply_fn, cfg, "joint")
        # lanes [first_lane, first_lane + K) of n_lanes (None: K), and the
        # data group of a step over a "batch" slice (LaneShard.bind)
        self.n_lanes, self.first_lane, self.batch = None, 0, None
        self.shard = None
        self._ids = {}

    @property
    def collective(self) -> bool:
        """Whether a step all-reduces (no graph may capture it)."""
        return self.batch is not None

    def _lane_ids(self, K, device):
        key = (K, self.first_lane, str(device))
        if key not in self._ids:
            self._ids[key] = torch.arange(self.first_lane,
                                          self.first_lane + K,
                                          device=device)
        return self._ids[key]

    def _vmap(self, fn, in_dims):
        """``fn`` vmapped over the lanes (the first argument's leading
        dimension), each lane's draws its own (``ops.rows.draw``)."""
        def call(*args):
            first = pytree.tree_leaves(args[0])[0]
            K = first.shape[0]
            n_lanes = self.n_lanes or K

            def lane(idx, *a):
                with rows.lane_index(n_lanes, idx):
                    return fn(*a)

            return torch.func.vmap(lane, in_dims=(0, *in_dims),
                                   randomness="same")(
                self._lane_ids(K, first.device), *args)

        return call

    def lane_loss(self, hp):
        """The loss of a lane whose values are ``hp`` (None: ``cfg``'s)."""
        return self.loss_fn

    def step(self, params, optimizer, x, y, draws=None, hps=None):
        """One Adam step of every lane on the shared batch (x, y): the
        lanes' losses summed, so each lane's gradient is its own loss's.
        ``draws``: the apply function's injected draws with a lane
        dimension in front (else drawn); ``hps``: the ``(K, n_hp)`` lane
        values (else every lane ``cfg``'s). Over a ``batch`` group (x, y)
        are this rank's rows and the step is ``train.TrainProgram``'s
        data-parallel one, per lane. Returns the (K,) tracked losses."""
        def lane(p, x, y, d, hp):
            return self.lane_loss(hp)(p, x, y, generator=self.generator,
                                      draws=d)

        optimizer.zero_grad()
        draws = draws or {}
        batch = self.batch
        with batch.rows() if batch else contextlib.nullcontext():
            with span("step.forward"):
                loss, tracked = self._vmap(
                    lane, (0, None, None, _dims(draws),
                           None if hps is None else 0))(
                    params, x, y, draws, hps)
                if batch:
                    loss, tracked = loss * batch.share, tracked * batch.share
            with span("step.backward"), warnings.catch_warnings():
                # each leaf's gradient is its lane-major view of the
                # optimizer's (K, P) buffer, added into in place as the
                # leaf's layout is
                warnings.filterwarnings("ignore", message="grad and param "
                                        "do not obey the gradient layout "
                                        "contract")
                loss.sum().backward()
        tracked = tracked.detach()
        if batch:
            with span("step.backward"):
                batch.all_reduce_(optimizer.grad)
            batch.all_reduce_(tracked)
        with span("step.optimizer"):
            optimizer.step()
        return tracked

    def epoch(self, params, optimizer, Xb, yb, hps=None):
        """The nb steps over ``Xb[i]``, ``yb[i]`` (``hps`` as ``step``'s):
        the (K,) mean tracked loss."""
        acc = torch.zeros(optimizer.lanes, dtype=torch.float32,
                          device=Xb.device)
        for x, y in zip(Xb, yb):
            acc = acc + self.step(params, optimizer, x, y, hps=hps)
        return acc / Xb.shape[0]

    def y_hat(self, params, x, generator=None):
        """Each lane's eval-mode y_hat over ``x`` (t, n, d): (K, n), or
        (K, n, out) where the output is not one regression column."""
        cfg = self.cfg

        def lane(p, x):
            out = self.apply_fn(p, x, cfg, train=False,
                                generator=generator or self.generator)
            y_hat = out[0][3]
            if cfg.task == "regression" and cfg.output_dim == 1:
                return torch.squeeze(y_hat, 1)
            return y_hat

        with torch.no_grad():
            return self._vmap(lane, (0, None))(params, x)

    def evaluate(self, params, Xv, yv):
        """Each lane's validation metric over the whole set: (K,)."""
        with span("epoch.eval"):
            if self.valid_metric == "accuracy":
                logits = self.y_hat(params, Xv)
                return (torch.argmax(logits, dim=2) == yv[None]).to(
                    torch.float32).mean(dim=1)

            def lane(p, x, y):
                return self.eval_fn(p, x, y, generator=self.generator)

            with torch.no_grad():
                return self._vmap(lane, (0, None, None))(params, Xv, yv)

    def predict(self, params, X):
        """Each lane's y_hat over the time-major ``X`` in chunks of
        ``PREDICT_CHUNK`` rows, draws from a generator seeded 0 (the JAX
        package's ``PRNGKey(0)``): a host array (K, N[, out]). Spans:
        ``trainer.score``, of it ``score.forward`` and ``score.read`` (the
        copy to the host)."""
        with span("trainer.score"):
            with span("score.forward"):
                gen = torch.Generator(device=X.device).manual_seed(0)
                parts = [self.y_hat(params, X[:, i:i + PREDICT_CHUNK], gen)
                         for i in range(0, X.shape[1], PREDICT_CHUNK)]
            with span("score.read"):
                return torch.cat(parts, dim=1).cpu().numpy()

    @staticmethod
    def select(mask, new, old):
        """Per lane, ``new`` where ``mask`` else ``old``: (K, P) flat
        parameters or (K,) values."""
        m = mask.reshape((mask.shape[0],) + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)


class LaneLoop:
    """The JAX package's chunk program (``_compile_run_epochs``) over K
    lanes. One epoch (``body``): the train epoch, the per-lane eval, the
    per-lane best select (``>=`` on accuracy, ``<=`` on a loss) into
    ``best_flat`` and ``best``, ``has_best``, and the per-lane plateau
    step (as a minimum, whatever the metric), its lr the optimizer's;
    then a row (tracked, valid, lr), float64 over the lanes, into
    ``records``. On a CUDA card the body is a ``Graphed``: the first
    epoch eager, each later one a replay (its spans ``graph.eager``,
    ``graph.capture``, ``graph.replay``); on the CPU, and where a step
    all-reduces (``programs.collective``), it runs eagerly. ``run`` is
    the span ``loop.run``, its host read ``loop.read``.
    ``epoch_launches`` holds each epoch's kernel launches. ``hps``: a
    ``(K, n_hp)`` device matrix of lane values that the steps read (the
    graph reads the buffer, so values written into it in place take
    effect at the next replay)."""

    def __init__(self, programs, params, optimizer, Xb, yb, Xv, yv, *,
                 epochs, valid_metric="loss", hps=None):
        dev = optimizer.flat.device
        K = optimizer.lanes
        self.programs, self.params, self.opt = programs, params, optimizer
        self.batches, self.valid_set = (Xb, yb), (Xv, yv)
        self.hps = hps
        self.acc_mode = valid_metric == "accuracy"
        inf = -math.inf if self.acc_mode else math.inf
        self.best = torch.full((K,), inf, dtype=torch.float32, device=dev)
        self.best_flat = torch.zeros_like(optimizer.flat)
        self.has_best = torch.zeros(K, dtype=torch.bool, device=dev)
        self.sched = {"lr": optimizer.lr,
                      "best": torch.full((K,), math.inf, dtype=torch.float32,
                                         device=dev),
                      "bad": torch.zeros(K, dtype=torch.int32, device=dev),
                      "cooldown": torch.zeros(K, dtype=torch.int32,
                                              device=dev)}
        self.records = torch.zeros((epochs, 3, K), dtype=torch.float64,
                                   device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.epoch = (Graphed(self.body, (programs.generator,))
                      if dev.type == "cuda" and not programs.collective
                      else self.body)
        self.epoch_launches = []

    def body(self):
        (Xb, yb), (Xv, yv) = self.batches, self.valid_set
        tracked = self.programs.epoch(self.params, self.opt, Xb, yb,
                                      self.hps)
        valids = self.programs.evaluate(self.params, Xv, yv)
        with torch.no_grad():
            better = (valids >= self.best if self.acc_mode
                      else valids <= self.best)
            self.best_flat.copy_(LanePrograms.select(better, self.opt.flat,
                                                     self.best_flat))
            self.best.copy_(torch.where(better, valids, self.best))
            self.has_best.logical_or_(better)
            for k, v in plateau_step(self.sched, valids).items():
                self.sched[k].copy_(v)
            row = torch.stack([tracked.double(), valids.double(),
                               self.sched["lr"].double()])
            self.records.index_copy_(0, self.slot.view(1), row[None])
            self.slot.add_(1)

    def run(self, n: int):
        """n epochs, then one read of their records: a (n, 3, K) float64
        array of (tracked, valid, lr). Spans: ``loop.run`` (its
        ``epochs``), of it ``loop.read``, the host waiting on the card."""
        with span("loop.run", epochs=n):
            self.slot.zero_()
            for _ in range(n):
                before = counts.snapshot()
                self.epoch()
                self.epoch_launches.append(counts.since(before))
            with span("loop.read"):
                return self.records[:n].cpu().numpy()

    def eval_flat(self):
        """Each lane's best parameters, a lane with no best yet its live
        ones: (K, P)."""
        return LanePrograms.select(self.has_best, self.best_flat,
                                   self.opt.flat)


def sched_to_dicts(sched):
    """The device plateau state as the snapshot's JSON: one {lr, best,
    bad, cooldown} dict a lane."""
    sc = {k: v.detach().cpu().numpy() for k, v in sched.items()}
    return [{"lr": float(sc["lr"][i]), "best": float(sc["best"][i]),
             "bad": int(sc["bad"][i]), "cooldown": int(sc["cooldown"][i])}
            for i in range(sc["lr"].shape[0])]


def sched_from_dicts(dicts, sched):
    """The inverse of ``sched_to_dicts``, copied into the tensors of
    ``sched``."""
    for k, dtype in (("lr", torch.float32), ("best", torch.float32),
                     ("bad", torch.int32), ("cooldown", torch.int32)):
        sched[k].copy_(torch.tensor([d[k] for d in dicts], dtype=dtype))


def lane_state(loop, shard=None):
    """The K-lane state of ``loop`` on the host, every rank's lanes
    gathered (``LaneShard.gather``): the live parameters (``flat``),
    Adam's state dict (``opt_state``), each lane's best parameters
    (``best_flat``, where ``has_best``), best validation number and
    scheduler."""
    opt = loop.opt

    def g(t):
        t = t.detach().cpu()
        return t if shard is None else shard.gather(t)

    return {"flat": g(opt.flat),
            "opt_state": {"state": {k: g(getattr(opt, k))
                                    for k in ("count", "mu", "nu")},
                          "lr": [float(v) for v in g(opt.lr)]},
            "best_flat": g(loop.best_flat), "has_best": g(loop.has_best),
            "best": g(loop.best),
            "sched": {k: g(v) for k, v in loop.sched.items()}}


def _multiseed_snapshot(path, cfg, loop, epoch, shard=None):
    """The whole K-seed state under ``path``: live and per-seed-best
    parameters, Adam's state, each lane's best validation number, lr and
    scheduler internals (``_ms_n_seeds``, ``_ms_best_valid``, ``_ms_lrs``,
    ``_ms_sched`` in the config, the JAX package's fields), so a killed
    run resumes exactly. A lane with no best yet stores its live
    slice. Sharded, every rank's lanes are gathered and the writer alone
    writes, in the layout of an unsharded run."""
    st = lane_state(loop, shard)
    if shard is not None and not shard.writer:
        return
    opt = loop.opt
    meta = cfg.to_dict()
    meta["_ms_n_seeds"] = int(st["flat"].shape[0])
    meta["_ms_best_valid"] = [float(b) for b in st["best"]]
    meta["_ms_lrs"] = st["opt_state"]["lr"]
    meta["_ms_sched"] = sched_to_dicts(st["sched"])
    eval_flat = LanePrograms.select(st["has_best"], st["best_flat"],
                                    st["flat"])
    state = {"live": opt.tree_of(st["flat"]), "best": opt.tree_of(eval_flat)}
    save_checkpoint(path, state, opt_state=st["opt_state"], step=epoch + 1,
                    config=meta)


def opt_state_lanes(opt_state, lanes):
    """Lanes ``lanes`` (a range) of a ``LaneAdam`` state dict (a count of
    one for all lanes stays one)."""
    sl = slice(lanes.start, lanes.stop)
    st = opt_state["state"]
    count = torch.as_tensor(st["count"])
    return {"state": {"count": count if count.dim() == 0 else count[sl],
                      "mu": torch.as_tensor(st["mu"])[sl],
                      "nu": torch.as_tensor(st["nu"])[sl]},
            "lr": (None if opt_state["lr"] is None
                   else list(opt_state["lr"])[sl])}


def _multiseed_resume(resume_from, loop, n_seeds, logger, lanes=None):
    """Restore a ``_multiseed_snapshot`` into ``loop`` (its parameters,
    Adam, best record and scheduler) and return the epoch it goes on
    from; refuses another seed count. ``lanes`` (a range): the loop holds
    those lanes of the snapshot's."""
    state, meta = restore_checkpoint(resume_from)
    mcfg = meta.get("config", {})
    ck_seeds = mcfg.get("_ms_n_seeds")
    if ck_seeds != n_seeds:
        raise ValueError(
            f"checkpoint at {resume_from} holds {ck_seeds} seeds but "
            f"--seeds {n_seeds} was requested; they must match")
    lanes = range(n_seeds) if lanes is None else lanes
    sl = slice(lanes.start, lanes.stop)
    opt = loop.opt
    opt_state = state["opt_state"]
    if len(lanes) != n_seeds:
        opt_state = opt_state_lanes(opt_state, lanes)
    opt.load_state_dict(opt_state,
                        params=take_lanes(state["params"]["live"], lanes))
    with torch.no_grad():
        loop.best_flat.copy_(opt.flatten(take_lanes(state["params"]["best"],
                                                    lanes)))
        loop.best.copy_(torch.tensor(mcfg["_ms_best_valid"][sl],
                                     dtype=torch.float32))
        # restored lanes without a recorded best hold their live slice
        # (the snapshot's fallback), so each lane has a best
        loop.has_best.fill_(True)
    sched_from_dicts(mcfg["_ms_sched"][sl], loop.sched)
    start_epoch = int(meta.get("step", 0))
    logger.text(f"resumed {n_seeds}-seed state from {resume_from} "
                f"at epoch {start_epoch}")
    return start_epoch


class _Null:
    def write(self, *a):
        pass

    def flush(self):
        pass


@trial
def train_mfm_multiseed(
        X_train, y_train, X_valid, y_valid, X_test, y_test, cfg, *,
        n_seeds: int = 8,
        lr: Optional[float] = None,
        logger: Optional[RunLogger] = None,
        seed: int = 123,
        binary_threshold: float = 0.0,
        threshold_mode: str = "ge",
        model_type: Optional[str] = None,
        valid_metric: str = "loss",
        resume_from: Optional[str] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0,
        params=None,
        device=None,
        mesh=None):
    """Train ``n_seeds`` models of one config as lanes of one program (the
    JAX package's ``train_mfm_multiseed``). Returns
    each seed's test metrics (``results``), the best seed by MAE, or by
    accuracy for classification (a seed with non-finite metrics never
    wins), its parameters (``best_params`` and ``params``, so
    ``--save-ckpt`` saves it) and best validation number, the ``step``
    and the per-epoch ``history``.

    ``lane_params`` holds every seed's scored parameters, a tree of ``(K,
    ...)`` leaves on the CPU, and each ``history`` entry the epoch's
    validation numbers and lrs, one a lane.

    ``valid_metric="accuracy"``: the accuracy-keeping trainer's semantics
    (keep on the best accuracy with ``>=``, the scheduler stepping on the
    same number). ``params``: a tree of ``(K, ...)`` leaves to start from
    (else ``init_lanes``). ``ckpt_dir`` and ``ckpt_every``: every N
    epochs overwrite ``ckpt_dir`` with the whole K-seed state;
    ``resume_from``: restore such a snapshot and go on, the generator
    seeded anew from (seed, start epoch).

    ``mesh``: a ``sharding.Mesh`` whose ``"seed"`` (or ``"data"``) axis
    shares out the lanes, with a ``"batch"`` axis each lane group's batch
    (see the module's doc); every rank returns the whole result."""
    logger = logger or RunLogger()
    name = model_type or cfg.model_type
    if name not in MODELS:
        name = "mfm"
    if name not in MULTISEED_TYPES:
        raise ValueError(
            f"multiseed training supports model types {MULTISEED_TYPES} "
            f"(single-stage joint loss); {name!r} has different training "
            "semantics - use its dedicated trainer with one seed")
    note_trial(model_type=name, lanes=n_seeds)
    shard = LaneShard(mesh, n_seeds, f"n_seeds={n_seeds}")
    if not shard.member:
        return shard.share_result(None)
    logger = shard.logger(logger)
    dev = resolve_device(device)
    prep = prepare_bucket_data(X_train, y_train, X_valid, y_valid, X_test,
                               y_test, cfg, seed=seed, device=dev, mesh=mesh)
    _, apply_fn = get_model(name)
    lr = 1e-3 if lr is None else lr
    params = (init_lanes(name, cfg, seed, n_seeds, dev, shard.lanes)
              if params is None
              else stack_lanes([take_lane(params, k)
                                for k in shard.lanes], dev))
    opt = LaneAdam(params, lr)
    generator = torch.Generator(device=dev).manual_seed(seed)
    programs = shard.bind(LanePrograms(apply_fn, cfg, generator,
                                       valid_metric))
    # chunk boundaries anchored at epoch 0 and aligned to ckpt_every, so a
    # resumed run re-enters on a boundary
    chunk = (ckpt_every if (ckpt_dir and ckpt_every)
             else min(cfg.num_epochs, DEFAULT_EPOCH_CHUNK)) or 1
    loop = LaneLoop(programs, params, opt, prep["Xb"], prep["yb"],
                    prep["Xv"], prep["yv"], epochs=chunk,
                    valid_metric=valid_metric)
    start_epoch = 0
    if resume_from:
        start_epoch = _multiseed_resume(resume_from, loop, n_seeds, logger,
                                        shard.lanes)
        generator.manual_seed(_run_seed(seed, start_epoch))
    history = []
    e = start_epoch
    while e < cfg.num_epochs:
        n = min(chunk - e % chunk, cfg.num_epochs - e)
        records = shard.gather(loop.run(n), dim=2).astype(np.float32)
        for j in range(n):
            tracked, valids = records[j, 0], records[j, 1]
            logger.text(e + j, tracked.round(4).tolist(),
                        valids.round(4).tolist())
            logger.record("epoch", epoch=e + j, train_loss=tracked.tolist(),
                          valid_loss=valids.tolist())
            history.append({"epoch": e + j, "valids": valids.tolist(),
                            "lrs": records[j, 2].tolist()})
        e += n
        if ckpt_dir and ckpt_every and e % ckpt_every == 0:
            _multiseed_snapshot(ckpt_dir, cfg, loop, e - 1, shard)

    # each seed's test score with its best parameters (a seed that never
    # improved, only possible with no epoch run, with its live ones)
    preds = shard.gather(programs.predict(opt.tree_of(loop.eval_flat()),
                                          prep["Xte"]))
    eval_stack = opt.tree_of(shard.gather(loop.eval_flat().cpu()))
    yte = prep["yte"]
    best = shard.gather(loop.best.cpu()).numpy()
    results = []
    for k in range(n_seeds):
        if cfg.task == "classification":
            m = score_classification(preds[k], yte, out=_Null())
        else:
            m = score_regression(preds[k], yte, binary_threshold,
                                 threshold_mode, out=_Null())
        results.append({"seed_index": k, "metrics": m,
                        "best_valid": float(best[k])})
    key_metric = "accuracy" if cfg.task == "classification" else "mae"
    maximize = cfg.task == "classification"

    def rank_val(k):
        # NaN-safe: a diverged seed never wins the pick
        v = results[k]["metrics"][key_metric]
        if not np.isfinite(v):
            return np.inf
        return -v if maximize else v

    pick = min(range(n_seeds), key=rank_val)
    logger.record("final", per_seed=[r["metrics"] for r in results],
                  best_seed=pick)
    pick_tree = take_lane(eval_stack, pick)
    return shard.share_result({
        "results": results, "best_seed": pick,
        "best_params": pick_tree, "params": pick_tree,
        "best_valid": float(best[pick]), "step": cfg.num_epochs,
        "history": history,
        "lane_params": pytree.tree_map(lambda a: a.cpu(), eval_stack)})
