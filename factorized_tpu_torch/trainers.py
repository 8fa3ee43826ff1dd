"""Experiment-level trainers of the port (port of ``train_mfm``,
``train_beta_vae``, ``train_mfm_missing``, ``train_mfm_test_zeros``,
``train_mfm_ablation``, ``train_seq2seq``, ``train_basic_missing``,
``train_mfm_acc``, ``train_mfm_multitrait`` and ``train_predictor`` of
``factorized_tpu/trainers.py``, with its loops:
``_loop`` runs
``_loop_chunked``, chunks of epochs on the device with one host read a
chunk, on a CUDA card one graph replay an epoch, unless
``FACTORIZED_TPU_HOST_LOOP=1`` picks ``_loop_host``, the per-epoch host
loop; ``FACTORIZED_TPU_EPOCH_CHUNK`` sets the epochs a chunk, 10 by
default).

Each takes numpy arrays shaped like the reference loaders emit
(batch-major ``(n, t, d)`` X, 1-D y) and an ``MFMConfig``; it trains on
the card unless ``device`` says otherwise and returns the results dict of
the JAX package's trainer: test metrics, the parameters it scored, the
optimizer state, the per-epoch history and the step count, plus the best
validation loss where the JAX trainer returns one. Every random draw
comes from one ``torch.Generator`` seeded from ``seed``. The test
scores read ``y_hat`` of the serving forward (``models.predict.YHat``,
the eval forward's label path); ``train_mfm_missing`` scores the eval
forward's four decodes, ``train_basic_missing`` its three heads,
``train_seq2seq`` its three cross-modal reconstructions and
``train_predictor`` the eval forward of ``eflstm`` and
``self_attention``.

Each trainer takes ``resume_from``, a checkpoint directory of this
package's format with the optimizer state (``--save-ckpt``, or the
auto-snapshot of ``cli.make_autosnapshot``): the run goes on from its
recorded step, the lr its ``_resume_lr`` (the patience counters
restart), the keeper's best its ``_resume_best_valid`` with the restored
parameters; the generator is seeded anew from (seed, start epoch), as
the JAX package folds the start epoch into its key, so a resumed run
draws other masks than the uninterrupted one. Epochs are numbered from
the start of the whole run (the beta-VAE's from its stage's).
``snapshot`` is called as
``snapshot(epoch, params, opt_state, lr, best_valid)`` at the end of
each epoch (the host loop) or each chunk (the chunked loop, whose chunks
end on the multiples of the snapshot's ``.every``, counted in whole-run
epochs, so a resumed run has the uninterrupted run's boundaries).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.models import baselines, get_model
from factorized_tpu_torch.models.common import split_modalities
from factorized_tpu_torch.models.mfm import MFM
from factorized_tpu_torch.models.predict import YHat
from factorized_tpu_torch.ops.losses import (cross_entropy_loss, l1_loss,
                                             l2_loss)
from factorized_tpu_torch.train import (DEFAULT_EPOCH_CHUNK, ChunkedLoop,
                                        TrainProgram, make_batches,
                                        make_optimizer,
                                        shuffle_and_time_major)
from factorized_tpu_torch.utils.checkpoint import (BestKeeper,
                                                   restore_checkpoint, to_cpu)
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.metrics import (score_classification,
                                                score_multitrait,
                                                score_regression)
from factorized_tpu_torch.utils.profiling import note_trial, span, trial
from factorized_tpu_torch.utils.scheduler import ReduceLROnPlateau


def _prep_data(X_train, y_train, X_valid, y_valid, X_test, y_test, seed):
    X_train, y_train = shuffle_and_time_major(X_train, y_train, seed)
    X_valid = np.ascontiguousarray(np.asarray(X_valid).swapaxes(0, 1),
                                   dtype=np.float32)
    X_test = np.ascontiguousarray(np.asarray(X_test).swapaxes(0, 1),
                                  dtype=np.float32)
    return (X_train, y_train, X_valid, np.asarray(y_valid), X_test,
            np.asarray(y_test))


def _labels(y, cfg):
    return (y.astype(np.int32) if cfg.task == "classification"
            else y.astype(np.float32))


def _predict_y(params, cfg, model_type, X, dev):
    """y_hat of ``params``' serving forward (``models.predict.YHat``) over
    the time-major (t, n, d) numpy array ``X`` on ``dev``: a host array,
    squeezed for one-dimensional regression. Spans: ``score.pack`` (the
    weights packed), ``score.forward``, ``score.read`` (the copy to the
    host)."""
    with span("score.pack"):
        forward = YHat(cfg, _to_device(params, dev), model_type, dev)
    with torch.no_grad():
        with span("score.forward"):
            y_hat = forward(torch.from_numpy(X).to(dev))
        with span("score.read"):
            return y_hat.cpu().numpy()


def _score(y_hat, y_test, cfg, binary_threshold, threshold_mode):
    if cfg.task == "classification":
        return score_classification(y_hat, y_test)
    return score_regression(y_hat, y_test, binary_threshold, threshold_mode)


def _loop(program, params, optimizer, Xb, yb, remainder, Xv, yv,
          num_epochs, scheduler, keeper, logger, generator,
          save_always=False, snapshot=None, first=0):
    """The trainer epoch loop: train epoch -> full-set eval -> plateau
    scheduler -> best-valid keeper, with a divergence break (a non-finite
    train or valid loss ends the run before the scheduler and the keeper
    see it). ``save_always`` keeps every healthy epoch's parameters (the
    beta-VAE trainer's unconditional save); ``first`` numbers the first
    epoch (a resumed run's start); ``snapshot`` see the module's doc.
    Chunks of epochs on the device (``_loop_chunked``) unless
    ``FACTORIZED_TPU_HOST_LOOP=1`` picks the per-epoch host loop
    (``_loop_host``), as does a snapshot with no cadence (``.every``);
    both give the same run (``tests/test_torch_chunked_loop.py``).
    Returns the history."""
    if num_epochs <= 0:
        return []
    host = (os.environ.get("FACTORIZED_TPU_HOST_LOOP", "") == "1"
            or (snapshot is not None and not getattr(snapshot, "every",
                                                     None)))
    loop = _loop_host if host else _loop_chunked
    return loop(program, params, optimizer, Xb, yb, remainder, Xv, yv,
                num_epochs, scheduler, keeper, logger, generator, save_always,
                snapshot, first)


def _loop_chunked(program, params, optimizer, Xb, yb, remainder, Xv, yv,
                  num_epochs, scheduler, keeper, logger, generator,
                  save_always=False, snapshot=None, first=0):
    """Chunked twin of ``_loop_host`` (the JAX package's
    ``_loop_chunked``): ``train.ChunkedLoop`` runs up to
    ``DEFAULT_EPOCH_CHUNK`` epochs (``FACTORIZED_TPU_EPOCH_CHUNK``, or the
    snapshot's ``.every``) with the scheduler, the keeper and the
    divergence gate on the device, then the host reads the chunk's
    records once, logs them, stops at the first diverged epoch and calls
    the snapshot. Chunk boundaries fall on the multiples of the chunk in
    whole-run epochs (the snapshot's ``.offset`` is where this loop
    starts). The host scheduler and keeper are mirrored into the device
    state before the first chunk and back after the last."""
    every = getattr(snapshot, "every", None) if snapshot else None
    offset = getattr(snapshot, "offset", 0) if snapshot else 0
    chunk = (int(every) if every else
             int(os.environ.get("FACTORIZED_TPU_EPOCH_CHUNK", 0))
             or min(num_epochs, DEFAULT_EPOCH_CHUNK))
    sched_kw = {"mode": scheduler.mode, "factor": scheduler.factor,
                "patience": scheduler.patience,
                "threshold": scheduler.threshold,
                "cooldown": scheduler.cooldown, "min_lr": scheduler.min_lr}
    loop = ChunkedLoop(program, params, optimizer, Xb, yb, remainder, Xv, yv,
                       generator, epochs=chunk, mode=keeper.mode,
                       save_always=save_always, sched_kw=sched_kw)
    loop.load(scheduler, keeper)
    history = []
    any_saved = keeper.best_params is not None
    diverged = False
    e = 0
    while e < num_epochs and not diverged:
        n = min(chunk - (offset + e) % chunk, num_epochs - e)
        for j, (tl, vl, lr, saved, ok) in enumerate(loop.run(n)):
            ep = first + e + j
            tl, vl, lr = float(tl), float(vl), float(lr)
            if not ok:
                logger.text(ep, tl, vl, "DIVERGED - aborting run")
                logger.record("diverged", epoch=ep, train_loss=tl,
                              valid_loss=vl)
                history.append({"epoch": ep, "train_loss": tl, "valid": vl,
                                "diverged": True})
                diverged = True
                break
            saved = bool(saved)
            if saved:
                any_saved = True
                keeper.best_epoch = ep
            logger.epoch(ep, tl, vl, saved, lr=lr)
            history.append({"epoch": ep, "train_loss": tl, "valid": vl,
                            "lr": lr})
        e += n
        if not diverged and snapshot is not None:
            snapshot(e - 1, params, optimizer.state_dict(),
                     float(optimizer.lr),
                     float(loop.best) if any_saved else keeper.best)
    loop.store(scheduler, keeper, any_saved)
    return history


def _loop_host(program, params, optimizer, Xb, yb, remainder, Xv, yv,
               num_epochs, scheduler, keeper, logger, generator,
               save_always=False, snapshot=None, first=0):
    """The per-epoch host loop: an eager epoch, the eval, and the host
    scheduler and keeper, the host waiting on
    the card every epoch; the snapshot called after every epoch."""
    history = []
    lr = scheduler.lr
    for e in range(num_epochs):
        epoch = first + e
        train_loss = program.run_epoch(params, optimizer, Xb, yb, generator,
                                       lr, remainder)
        valid = float(program.evaluate(params, Xv, yv, generator))
        if not (np.isfinite(train_loss) and np.isfinite(valid)):
            logger.text(epoch, train_loss, valid, "DIVERGED - aborting run")
            logger.record("diverged", epoch=epoch, train_loss=train_loss,
                          valid_loss=valid)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "valid": valid, "diverged": True})
            break
        lr = scheduler.step(valid)
        saved = keeper.update(valid, params, epoch)
        if save_always and not saved:
            keeper.best = valid
            keeper.best_params = to_cpu(params)
            keeper.best_epoch = epoch
            saved = True
        logger.epoch(epoch, train_loss, valid, saved, lr=lr)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "valid": valid, "lr": lr})
        if snapshot is not None:
            snapshot(e, params, optimizer.state_dict(), lr, keeper.best)
    return history


def _offset_snapshot(snapshot, start_epoch):
    """The snapshot with its epochs counted from the whole run's start
    (``start_epoch`` ahead of the loop's), its cadence (``.every``) kept
    and the offset recorded (``.offset``), by which the chunked loop
    aligns its chunks to whole-run epochs."""
    if snapshot is None or not start_epoch:
        return snapshot

    def shifted(e, *a):
        return snapshot(start_epoch + e, *a)

    shifted.every = getattr(snapshot, "every", None)
    shifted.offset = start_epoch
    return shifted


def _maybe_resume(resume_from, run, logger):
    """Restore a checkpoint with its optimizer state (this package's, or
    the JAX package's Orbax or msgpack one: ``restore_checkpoint``) into
    ``run``'s parameters and Adam (copied into their buffers) and seed
    ``run``'s generator anew from (seed, start epoch): (start epoch, the
    recorded lr, the recorded best validation loss). Epoch 0 and Nones
    without ``resume_from``."""
    if not resume_from:
        return 0, None, None
    state, meta = restore_checkpoint(resume_from)
    if "opt_state" not in state:
        raise ValueError(f"{resume_from} holds no optimizer state: resume "
                         f"needs a checkpoint saved with it (--save-ckpt or "
                         f"--ckpt-every)")
    run.optimizer.load_state_dict(state["opt_state"], params=state["params"])
    start_epoch = meta.get("step", 0)
    run.reseed(start_epoch)
    resume_lr = meta.get("config", {}).get("_resume_lr")
    resume_best = meta.get("config", {}).get("_resume_best_valid")
    logger.text(f"resumed from {resume_from} at epoch {start_epoch}"
                + (f" lr={resume_lr}" if resume_lr else ""))
    return start_epoch, resume_lr, resume_best


def _resume_keeper(keeper, resume_best, params):
    """The keeper of a resumed run: the recorded best, with the restored
    parameters as its best parameters."""
    if resume_best is not None:
        keeper.best = resume_best
        keeper.best_params = to_cpu(params)
    return keeper


def _run_seed(*tags):
    """A generator seed derived from the run's seed and where it starts
    (the part of the JAX package's ``fold_in``)."""
    return int(np.random.SeedSequence(list(tags)).generate_state(1)[0])


class _Setup:
    """What every trainer builds first: the shuffled, time-major data on
    the device, the model's parameters, its apply function, the generator,
    the flat optimizer (Adam unless ``optimizer`` says ``"sgd"``, with
    ``cfg.momentum``) and the plateau scheduler. The parameters are the
    registered model ``name``'s, seeded from ``seed``, unless ``params``
    (a tree, e.g. of a model the registry does not hold, whose
    ``apply_fn`` is then None) are given.

    Spans: ``trainer.setup``, of it ``setup.data`` (the shuffle, the
    batches, the copies to the card) and ``setup.init`` (the parameters,
    the optimizer); ``score`` is ``trainer.score``. The trial's
    ``model_type`` is ``name``."""

    def __init__(self, data, cfg, name, *, lr, seed, include_remainder,
                 device, labels=_labels, params=None, optimizer="adam"):
        with span("trainer.setup"):
            self.dev = dev = resolve_device(device)
            self.name, self.cfg = name, cfg
            note_trial(model_type=name, lanes=1)
            with span("setup.data"):
                Xtr, ytr, Xv, yv, self.Xte, yte = _prep_data(*data, seed)
                Xb, yb, rem = make_batches(Xtr, labels(ytr, cfg),
                                           cfg.batchsize, include_remainder)
                self.Xb, self.yb = self.on_device(Xb), self.on_device(yb)
                self.rem = (None if rem is None else
                            (self.on_device(rem[0]), self.on_device(rem[1])))
                self.Xv, self.yv = (self.on_device(Xv),
                                    self.on_device(labels(yv, cfg)))
                self.yte = labels(yte, cfg)
            with span("setup.init"):
                if params is None:
                    _, self.apply_fn = get_model(name)
                    params = MFM(cfg, seed=seed, device=dev,
                                 model_type=name).tree()
                else:
                    self.apply_fn = None
                    params = _to_device(params, dev)
                self.params = params
                self.seed = seed
                self.generator = torch.Generator(device=dev).manual_seed(seed)
                self.lr = lr = 1e-3 if lr is None else lr
                self.optimizer = make_optimizer(self.params, lr, optimizer,
                                                cfg.momentum)
                self.scheduler = ReduceLROnPlateau(lr)

    def on_device(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def reseed(self, *where):
        """The generator seeded anew from (seed, *where): a resumed run's
        start (the beta-VAE's stage and epochs done in it)."""
        self.generator.manual_seed(_run_seed(self.seed, *where))

    def resume(self, resume_from, logger):
        """``_maybe_resume`` into this run, the scheduler then starting at
        the recorded lr (or the given one): (start epoch, recorded
        best)."""
        start, resume_lr, resume_best = _maybe_resume(resume_from, self,
                                                      logger)
        if resume_from:
            self.scheduler = ReduceLROnPlateau(resume_lr or self.lr)
        return start, resume_best

    def single_stage(self, program, cfg, logger, resume_from, snapshot,
                     mode="min"):
        """A one-stage trainer's run: resumed where ``resume_from`` says,
        then the loop over the epochs left with the best-keeper of
        ``mode``: (start epoch, keeper, history)."""
        start, resume_best = self.resume(resume_from, logger)
        keeper = _resume_keeper(BestKeeper(mode), resume_best, self.params)
        history = self.loop(program, keeper, max(cfg.num_epochs - start, 0),
                            logger, snapshot=snapshot, first=start)
        return start, keeper, history

    def loop(self, program, keeper, num_epochs, logger, save_always=False,
             snapshot=None, first=0, offset=None):
        """``_loop`` over this run, its epochs numbered from ``first`` and
        the snapshot's from ``offset`` (``first`` unless given)."""
        return _loop(program, self.params, self.optimizer, self.Xb, self.yb,
                     self.rem, self.Xv, self.yv, num_epochs, self.scheduler,
                     keeper, logger, self.generator, save_always,
                     _offset_snapshot(snapshot, first if offset is None
                                      else offset), first)

    def eval_apply(self, params, X):
        """The eval forward of ``params`` over the time-major numpy array
        ``X`` on the card, its MMD samples drawn from a generator seeded
        0 (the JAX package's ``PRNGKey(0)`` at test time)."""
        with torch.no_grad():
            return self.apply_fn(
                _to_device(params, self.dev), self.on_device(X), self.cfg,
                generator=torch.Generator(device=self.dev).manual_seed(0),
                train=False)

    def score(self, params, cfg, logger, binary_threshold, threshold_mode,
              tag="y_hat", X=None):
        """The test metrics of ``params``' y_hat on the test set, or on
        ``X`` (time-major, e.g. the test set with a modality zeroed)."""
        with span("trainer.score"):
            y_hat = _predict_y(params, cfg, self.name,
                               self.Xte if X is None else X, self.dev)
            logger.text(f"scoring {tag}")
            return _score(y_hat, self.yte, cfg, binary_threshold,
                          threshold_mode)


def _steps(history):
    return sum(1 for e in history if not e.get("diverged"))


# the model types train_mfm takes, with the standard (decoded, reg,
# missing) return, as the JAX package's
STANDARD = ("mfm", "kl", "kl_ef", "m_a", "m_b", "m_c", "m_d")


@trial
def train_mfm(X_train, y_train, X_valid, y_valid, X_test, y_test, cfg, *,
              lr: Optional[float] = None,
              logger: Optional[RunLogger] = None,
              seed: int = 123,
              binary_threshold: float = 0.0,
              threshold_mode: str = "ge",
              include_remainder: bool = False,
              model_type: Optional[str] = None,
              resume_from: Optional[str] = None,
              snapshot=None,
              device=None):
    """Joint single-stage training of MFM (or any of ``STANDARD``) under
    Adam (the torch default lr 1e-3 unless ``lr``) with ReduceLROnPlateau
    on the validation label loss, keeping the best epoch's parameters for
    the test score."""
    logger = logger or RunLogger()
    name = model_type or cfg.model_type
    if name not in STANDARD:
        raise ValueError(
            f"train_mfm cannot train model type {name!r}; expected one "
            f"of {STANDARD} (use the dedicated trainer otherwise)")
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 name, lr=lr, seed=seed,
                 include_remainder=include_remainder, device=device)
    start, keeper, history = run.single_stage(
        TrainProgram(run.apply_fn, cfg, "joint"), cfg, logger, resume_from,
        snapshot)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    metrics = run.score(best_params, cfg, logger, binary_threshold,
                        threshold_mode)
    logger.record("final", **metrics)
    return {"metrics": metrics, "params": best_params,
            "opt_state": run.optimizer.state_dict(), "history": history,
            "best_valid": keeper.best, "step": start + _steps(history)}


@trial
def train_beta_vae(X_train, y_train, X_valid, y_valid, X_test, y_test, cfg,
                   *, lr: Optional[float] = None,
                   logger: Optional[RunLogger] = None,
                   seed: int = 123,
                   binary_threshold: float = 0.0,
                   threshold_mode: str = "ge",
                   include_remainder: bool = False,
                   resume_from: Optional[str] = None,
                   snapshot=None,
                   device=None):
    """The two-stage schedule of MFM_KL_EF (``kl_ef``): stage 1 trains
    ``gen + lda_mmd * kld`` for ``num_epochs``, stage 2 ``disc + lda_mmd *
    kld`` for ``num_epochs``. One Adam and one ReduceLROnPlateau span both
    stages (lr decays carry from stage 1 into stage 2); each stage has its
    own best-keeper, which keeps every epoch (the reference saves
    unconditionally). The last parameters are the ones scored and
    returned. A checkpoint's step counts the epochs of both stages (stage
    2's are [num_epochs, 2 num_epochs)), as do the snapshots; the history
    numbers each stage's epochs from its start; a resumed run seeds its
    generator anew at each stage from (seed, stage, epochs done in it)."""
    logger = logger or RunLogger()
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "kl_ef", lr=lr, seed=seed,
                 include_remainder=include_remainder, device=device)
    start, _ = run.resume(resume_from, logger)
    history = []
    for stage in (1, 2):
        done = min(max(start - (stage - 1) * cfg.num_epochs, 0),
                   cfg.num_epochs)
        if cfg.num_epochs - done <= 0:
            continue
        if start:
            run.reseed(stage, done)
        program = TrainProgram(run.apply_fn, cfg, "beta_vae", stage=stage)
        h = run.loop(program, BestKeeper("min"), cfg.num_epochs - done,
                     logger, save_always=True, snapshot=snapshot, first=done,
                     offset=(stage - 1) * cfg.num_epochs + done)
        history.extend({**e, "stage": stage} for e in h)
        if h and h[-1].get("diverged"):
            break
    metrics = run.score(run.params, cfg, logger, binary_threshold,
                        threshold_mode)
    logger.record("final", **metrics)
    return {"metrics": metrics, "params": run.params,
            "opt_state": run.optimizer.state_dict(), "history": history,
            "step": start + _steps(history)}


@trial
def train_mfm_missing(X_train, y_train, X_valid, y_valid, X_test, y_test,
                      cfg, *, lr: Optional[float] = None,
                      logger: Optional[RunLogger] = None,
                      seed: int = 123,
                      binary_threshold: float = 0.0,
                      threshold_mode: str = "ge",
                      resume_from: Optional[str] = None,
                      snapshot=None,
                      device=None):
    """MFM_missing (``missing``) under its composite loss, no remainder
    batch, keeping the best epoch. At test time it logs the reconstruction
    MSEs of the four decodes (all present, then l, a and v missing) and
    scores the y_hat of each: ``metrics`` is keyed ``y_hat_nol``,
    ``y_hat_noa``, ``y_hat_nov`` and ``y_hat``."""
    logger = logger or RunLogger()
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "missing", lr=lr, seed=seed, include_remainder=False,
                 device=device)
    start, keeper, history = run.single_stage(
        TrainProgram(run.apply_fn, cfg, "missing"), cfg, logger, resume_from,
        snapshot)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)

    decoded, nol, noa, nov, _, _ = run.eval_apply(best_params, run.Xte)
    x_l, x_a, x_v = split_modalities(run.on_device(run.Xte), cfg.input_dims)
    for tag, dec in (("all present", decoded), ("l missing", nol),
                     ("a missing", noa), ("v missing", nov)):
        logger.text(tag, float(l2_loss(dec[0], x_l)),
                    float(l2_loss(dec[1], x_a)), float(l2_loss(dec[2], x_v)))

    results = {}
    for tag, dec in (("y_hat_nol", nol), ("y_hat_noa", noa),
                     ("y_hat_nov", nov), ("y_hat", decoded)):
        logger.text(f"scoring {tag}")
        y = dec[3].cpu().numpy()
        results[tag] = _score(y[:, 0] if cfg.task == "regression" else y,
                              run.yte, cfg, binary_threshold, threshold_mode)
    logger.record("final", **results)
    return {"metrics": results, "params": best_params, "history": history,
            "opt_state": run.optimizer.state_dict(),
            "best_valid": keeper.best, "step": start + _steps(history)}


@trial
def train_mfm_test_zeros(X_train, y_train, X_valid, y_valid, X_test,
                         y_test, cfg, *, lr: Optional[float] = None,
                         logger: Optional[RunLogger] = None,
                         seed: int = 123,
                         binary_threshold: float = 0.0,
                         threshold_mode: str = "ge",
                         resume_from: Optional[str] = None,
                         snapshot=None,
                         device=None):
    """Plain MFM trained as ``train_mfm`` does, without the remainder
    batch; at test time each modality's input slice is zeroed in turn and
    the best parameters' y_hat scored: ``metrics`` is keyed
    ``y_hat_nol``, ``y_hat_noa`` and ``y_hat_nov``."""
    logger = logger or RunLogger()
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "mfm", lr=lr, seed=seed, include_remainder=False,
                 device=device)
    start, keeper, history = run.single_stage(
        TrainProgram(run.apply_fn, cfg, "joint"), cfg, logger, resume_from,
        snapshot)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    d_l, d_a, _ = cfg.input_dims
    results = {}
    for tag, (lo, hi) in (("y_hat_nol", (0, d_l)),
                          ("y_hat_noa", (d_l, d_l + d_a)),
                          ("y_hat_nov", (d_l + d_a, cfg.d_total))):
        X = run.Xte.copy()
        X[..., lo:hi] = 0.0
        results[tag] = run.score(best_params, cfg, logger, binary_threshold,
                                 threshold_mode, tag, X)
    logger.record("final", **results)
    return {"metrics": results, "params": best_params, "history": history,
            "opt_state": run.optimizer.state_dict(),
            "best_valid": keeper.best, "step": start + _steps(history)}


@trial
def train_mfm_ablation(X_train, y_train, X_valid, y_valid, X_test, y_test,
                       cfg, **kw):
    """The ablations ``m_a``..``m_d``: ``train_mfm``'s joint loss and loop
    on ``cfg.model_type``."""
    if cfg.model_type not in ("m_a", "m_b", "m_c", "m_d"):
        raise ValueError(f"train_mfm_ablation trains m_a..m_d, got "
                         f"{cfg.model_type!r}")
    return train_mfm(X_train, y_train, X_valid, y_valid, X_test, y_test,
                     cfg, model_type=cfg.model_type, **kw)


@trial
def train_seq2seq(X_train, y_train, X_valid, y_valid, X_test, y_test, cfg,
                  *, lr: Optional[float] = None,
                  logger: Optional[RunLogger] = None,
                  seed: int = 123,
                  resume_from: Optional[str] = None,
                  snapshot=None,
                  device=None):
    """The cross-modal translation baseline (``s2s``) under its
    reconstruction loss, float32 labels (unread), no remainder batch,
    keeping the best epoch. ``metrics`` are the three test MSEs of each
    modality reconstructed from the other two: ``x_l_nol_mse``,
    ``x_a_noa_mse`` and ``x_v_nov_mse``."""
    logger = logger or RunLogger()
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "s2s", lr=lr, seed=seed, include_remainder=False,
                 device=device, labels=lambda y, _: y.astype(np.float32))
    start, keeper, history = run.single_stage(
        TrainProgram(run.apply_fn, cfg, "s2s"), cfg, logger, resume_from,
        snapshot)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    nol, noa, nov, _ = run.eval_apply(best_params, run.Xte)
    x_l, x_a, x_v = split_modalities(run.on_device(run.Xte), cfg.input_dims)
    mses = {"x_l_nol_mse": float(l2_loss(nol[0], x_l)),
            "x_a_noa_mse": float(l2_loss(noa[0], x_a)),
            "x_v_nov_mse": float(l2_loss(nov[0], x_v))}
    logger.text(mses["x_l_nol_mse"], mses["x_a_noa_mse"], mses["x_v_nov_mse"])
    logger.record("final", **mses)
    return {"metrics": mses, "params": best_params, "history": history,
            "opt_state": run.optimizer.state_dict(),
            "best_valid": keeper.best, "step": start + _steps(history)}


@trial
def train_basic_missing(X_train, y_train, X_valid, y_valid, X_test, y_test,
                        cfg, *, lr: Optional[float] = None,
                        logger: Optional[RunLogger] = None,
                        seed: int = 123,
                        binary_threshold: float = 0.0,
                        threshold_mode: str = "ge",
                        resume_from: Optional[str] = None,
                        snapshot=None,
                        device=None):
    """The two-modality baseline (``bm``) under the three heads' label
    loss, no remainder batch, keeping the best epoch by the l-missing
    head's validation loss. At test time the eval forward's three heads
    are scored, squeezed for regression: ``metrics`` is keyed
    ``y_hat_nol``, ``y_hat_noa`` and ``y_hat_nov``."""
    logger = logger or RunLogger()
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "bm", lr=lr, seed=seed, include_remainder=False,
                 device=device)
    start, keeper, history = run.single_stage(
        TrainProgram(run.apply_fn, cfg, "bm"), cfg, logger, resume_from,
        snapshot)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    y_hats = run.eval_apply(best_params, run.Xte)[:3]
    results = {}
    for tag, y_hat in zip(("y_hat_nol", "y_hat_noa", "y_hat_nov"), y_hats):
        logger.text(f"scoring {tag}")
        y = y_hat.cpu().numpy()
        results[tag] = _score(y[:, 0] if cfg.task == "regression" else y,
                              run.yte, cfg, binary_threshold, threshold_mode)
    logger.record("final", **results)
    return {"metrics": results, "params": best_params, "history": history,
            "opt_state": run.optimizer.state_dict(),
            "best_valid": keeper.best, "step": start + _steps(history)}


def _accuracy_device(apply_fn, cfg):
    """The validation accuracy of both loops, on the device: the eval
    forward's y_hat argmax (the first index of a tie, as ``np.argmax``)
    against the labels, a float32 mean."""
    def eval_fn(params, x, y, *, generator=None):
        decoded = apply_fn(params, x, cfg, generator=generator,
                           train=False)[0]
        return (torch.argmax(decoded[3], dim=1) == y).to(
            torch.float32).mean()

    return eval_fn


@trial
def train_mfm_acc(X_train, y_train, X_valid, y_valid, X_test, y_test, cfg,
                  *, lr: Optional[float] = None,
                  logger: Optional[RunLogger] = None,
                  seed: int = 123,
                  resume_from: Optional[str] = None,
                  snapshot=None,
                  device=None):
    """MOSI's accuracy variant (``mfm_mosi_acc.py:396-503``): MFM as a
    two-class classifier of labels binarized upstream (``y >= 0``), the
    joint loss with the cross-entropy label term, no remainder batch, and
    the validation accuracy kept at its maximum (``BestKeeper("max")``,
    ``>=``), the plateau scheduler stepping on the same number as a
    minimum, as the reference does. ``metrics`` is the classification
    score of the kept parameters' y_hat."""
    logger = logger or RunLogger()
    cfg = cfg.replace(task="classification", output_dim=2)
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "mfm", lr=lr, seed=seed, include_remainder=False,
                 device=device)
    program = TrainProgram(run.apply_fn, cfg, "joint",
                           eval_fn=_accuracy_device(run.apply_fn, cfg))
    start, keeper, history = run.single_stage(
        program, cfg, logger, resume_from, snapshot, mode="max")
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    metrics = score_classification(
        _predict_y(best_params, cfg, "mfm", run.Xte, run.dev), run.yte)
    logger.record("final", **metrics)
    return {"metrics": metrics, "params": best_params, "history": history,
            "opt_state": run.optimizer.state_dict(),
            "best_valid": keeper.best, "step": start + _steps(history)}


@trial
def train_mfm_multitrait(X_train, y_train, X_valid, y_valid, X_test, y_test,
                         cfg, *, lr: Optional[float] = None,
                         logger: Optional[RunLogger] = None,
                         seed: int = 123,
                         resume_from: Optional[str] = None,
                         snapshot=None,
                         device=None):
    """Multi-trait regression (the reference's POM/IEMOCAP-style
    experiments, which exist there only as ``check.py``'s aggregation
    modes): one MFM (``kl`` where ``cfg.model_type`` says so) with
    ``output_dim`` the number of traits, the joint loss with the L1 label
    term over the trait vector, float32 label vectors, no remainder
    batch, Adam (lr 1e-3 unless ``lr``) and the best epoch kept; the test
    y_hat, one column a trait, scored by ``score_multitrait`` (the
    bracketed ``mae: [..]`` lines ``check.py`` parses)."""
    logger = logger or RunLogger()
    n_traits = np.asarray(y_train).shape[1]
    cfg = cfg.replace(task="regression", output_dim=n_traits)
    name = cfg.model_type if cfg.model_type in ("mfm", "kl") else "mfm"
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 name, lr=lr, seed=seed, include_remainder=False,
                 device=device, labels=lambda y, _: y.astype(np.float32))
    start, keeper, history = run.single_stage(
        TrainProgram(run.apply_fn, cfg, "joint"), cfg, logger, resume_from,
        snapshot)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    y_hat = _predict_y(best_params, cfg, name, run.Xte, run.dev)
    logger.text("scoring y_hat")
    metrics = score_multitrait(y_hat, run.yte)
    logger.record("final", **metrics)
    return {"metrics": metrics, "params": best_params,
            "opt_state": run.optimizer.state_dict(), "history": history,
            "best_valid": keeper.best, "step": start + _steps(history)}


def _predictor(kind, cfg, d, h, t, drop, seed):
    """(initial parameters on the CPU, forward) of the predictor ``kind``:
    ``forward(params, x, train, generator=None, draws=None)`` over the
    time-major x, its logits squeezed for regression. ``mfn`` is the
    registered model's, seeded as ``MFM`` seeds one; ``eflstm`` and
    ``self_attention`` are drawn from a generator seeded ``seed`` (at
    width ``h``, dropout ``drop``; ``self_attention`` turns the batch
    batch-major inside its forward, as the JAX trainer does)."""
    init_gen = torch.Generator().manual_seed(seed)
    if kind == "mfn":
        params = MFM(cfg, seed=seed, device="cpu", model_type="mfn").tree()

        def logits(params, x, train, generator, draws):
            return baselines.mfn_predictor_apply(
                params, x, cfg, generator=generator, train=train, **draws)
    elif kind == "eflstm":
        params = baselines.eflstm_init(init_gen, d, h, cfg.output_dim)

        def logits(params, x, train, generator, draws):
            return baselines.eflstm_apply(params, x, drop,
                                          generator=generator, train=train,
                                          **draws)
    elif kind == "self_attention":
        params = baselines.self_attention_init(init_gen, d, h, t,
                                               cfg.output_dim)

        def logits(params, x, train, generator, draws):
            return baselines.self_attention_apply(
                params, x.transpose(0, 1), drop, generator=generator,
                train=train, **draws)
    else:
        raise ValueError(f"unknown predictor kind {kind!r}")

    def forward(params, x, train, generator=None, draws=None):
        out = logits(params, x, train, generator, draws or {})
        return out.squeeze(1) if cfg.task == "regression" else out

    return params, forward


@trial
def train_predictor(X_train, y_train, X_valid, y_valid, X_test, y_test, kind,
                    cfg, *, h: int = 128,
                    drop: float = 0.5,
                    lr: float = 0.01,
                    optimizer: str = "adam",
                    logger: Optional[RunLogger] = None,
                    seed: int = 123,
                    binary_threshold: float = 0.0,
                    threshold_mode: str = "ge",
                    resume_from: Optional[str] = None,
                    snapshot=None,
                    device=None):
    """The discriminative baselines under the task loss alone (L1 for
    regression, cross-entropy for classification), through the flat
    ``optimizer`` (``"adam"``, or ``"sgd"`` with ``cfg.momentum``, the
    reference's ``test_mosi_acc.py:285``) at ``lr`` with the plateau
    scheduler, no remainder batch, keeping the best epoch: ``kind`` the
    standalone MFN (``"mfn"``, at ``cfg``'s widths), the early-fusion
    LSTM (``"eflstm"``) or the Gram-matrix attention ablation
    (``"self_attention"``), both of width ``h`` with dropout ``drop``.
    The test score reads the kept parameters' eval forward (for ``mfn``
    the serving forward, ``models.predict.YHat``)."""
    logger = logger or RunLogger()
    _, t, d = np.shape(X_train)
    params, forward = _predictor(kind, cfg, d, h, t, drop, seed)
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 kind, lr=lr, seed=seed, include_remainder=False,
                 device=device, params=params, optimizer=optimizer)

    def task_loss(pred, y):
        if cfg.task == "classification":
            return cross_entropy_loss(pred, y)
        return l1_loss(pred, y)

    def loss_fn(params, x, y, *, generator=None, draws=None):
        loss = task_loss(forward(params, x, True, generator, draws), y)
        return loss, loss

    def eval_fn(params, x, y, *, generator=None):
        return task_loss(forward(params, x, False), y)

    start, keeper, history = run.single_stage(
        TrainProgram(None, cfg, loss_fn=loss_fn, eval_fn=eval_fn), cfg,
        logger, resume_from, snapshot)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    if kind == "mfn":
        y_hat = _predict_y(best_params, cfg, kind, run.Xte, run.dev)
    else:
        with torch.no_grad():
            y_hat = forward(_to_device(best_params, run.dev),
                            run.on_device(run.Xte), False).cpu().numpy()
    metrics = _score(y_hat, run.yte, cfg, binary_threshold, threshold_mode)
    logger.record("final", **metrics)
    return {"metrics": metrics, "params": best_params, "history": history,
            "opt_state": run.optimizer.state_dict(),
            "best_valid": keeper.best, "step": start + _steps(history)}


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev)
