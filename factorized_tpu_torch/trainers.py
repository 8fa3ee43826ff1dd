"""Experiment-level trainers of the port (port of ``train_mfm``,
``train_beta_vae``, ``train_mfm_missing``, ``train_mfm_test_zeros`` and
``train_mfm_ablation`` of ``factorized_tpu/trainers.py``, with its
loops: ``_loop`` runs
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
forward's four decodes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.models.common import split_modalities
from factorized_tpu_torch.models.mfm import MFM
from factorized_tpu_torch.models.predict import YHat
from factorized_tpu_torch.ops.losses import l2_loss
from factorized_tpu_torch.train import (DEFAULT_EPOCH_CHUNK, ChunkedLoop,
                                        TrainProgram, make_batches,
                                        make_optimizer,
                                        shuffle_and_time_major)
from factorized_tpu_torch.utils.checkpoint import BestKeeper, to_cpu
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.metrics import (score_classification,
                                                score_regression)
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
    squeezed for one-dimensional regression."""
    forward = YHat(cfg, _to_device(params, dev), model_type, dev)
    with torch.no_grad():
        return forward(torch.from_numpy(X).to(dev)).cpu().numpy()


def _score(y_hat, y_test, cfg, binary_threshold, threshold_mode):
    if cfg.task == "classification":
        return score_classification(y_hat, y_test)
    return score_regression(y_hat, y_test, binary_threshold, threshold_mode)


def _loop(program, params, optimizer, Xb, yb, remainder, Xv, yv,
          num_epochs, scheduler, keeper, logger, generator,
          save_always=False):
    """The trainer epoch loop: train epoch -> full-set eval -> plateau
    scheduler -> best-valid keeper, with a divergence break (a non-finite
    train or valid loss ends the run before the scheduler and the keeper
    see it). ``save_always`` keeps every healthy epoch's parameters (the
    beta-VAE trainer's unconditional save). Chunks of epochs on the device
    (``_loop_chunked``) unless ``FACTORIZED_TPU_HOST_LOOP=1`` picks the
    per-epoch host loop (``_loop_host``); both give the same run
    (``tests/test_torch_chunked_loop.py``). Returns the history."""
    if num_epochs <= 0:
        return []
    loop = (_loop_host if os.environ.get("FACTORIZED_TPU_HOST_LOOP", "") == "1"
            else _loop_chunked)
    return loop(program, params, optimizer, Xb, yb, remainder, Xv, yv,
                num_epochs, scheduler, keeper, logger, generator, save_always)


def _loop_chunked(program, params, optimizer, Xb, yb, remainder, Xv, yv,
                  num_epochs, scheduler, keeper, logger, generator,
                  save_always=False):
    """Chunked twin of ``_loop_host`` (the JAX package's
    ``_loop_chunked``): ``train.ChunkedLoop`` runs up to
    ``DEFAULT_EPOCH_CHUNK`` epochs (``FACTORIZED_TPU_EPOCH_CHUNK``) with
    the scheduler, the keeper and the divergence gate on the device, then
    the host reads the chunk's records once, logs them and stops at the
    first diverged epoch. The host scheduler and keeper are mirrored into
    the device state before the first chunk and back after the last."""
    chunk = (int(os.environ.get("FACTORIZED_TPU_EPOCH_CHUNK", 0))
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
        n = min(chunk, num_epochs - e)
        for j, (tl, vl, lr, saved, ok) in enumerate(loop.run(n)):
            ep = e + j
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
    loop.store(scheduler, keeper, any_saved)
    return history


def _loop_host(program, params, optimizer, Xb, yb, remainder, Xv, yv,
               num_epochs, scheduler, keeper, logger, generator,
               save_always=False):
    """The per-epoch host loop: an eager epoch, the eval, and the host
    scheduler and keeper, the host waiting on the card every epoch."""
    history = []
    lr = scheduler.lr
    for epoch in range(num_epochs):
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
    return history


class _Setup:
    """What every trainer builds first: the shuffled, time-major data on
    the device, the model's parameters, its apply function, the generator,
    Adam and the plateau scheduler."""

    def __init__(self, data, cfg, name, *, lr, seed, include_remainder,
                 device):
        self.dev = dev = resolve_device(device)
        self.name = name
        Xtr, ytr, Xv, yv, self.Xte, yte = _prep_data(*data, seed)
        _, self.apply_fn = get_model(name)
        self.params = MFM(cfg, seed=seed, device=dev, model_type=name).tree()
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        lr = 1e-3 if lr is None else lr
        self.optimizer = make_optimizer(self.params, lr)
        self.scheduler = ReduceLROnPlateau(lr)
        Xb, yb, rem = make_batches(Xtr, _labels(ytr, cfg), cfg.batchsize,
                                   include_remainder)
        self.Xb, self.yb = self.on_device(Xb), self.on_device(yb)
        self.rem = (None if rem is None
                    else (self.on_device(rem[0]), self.on_device(rem[1])))
        self.Xv, self.yv = self.on_device(Xv), self.on_device(_labels(yv, cfg))
        self.yte = _labels(yte, cfg)

    def on_device(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def loop(self, program, keeper, num_epochs, logger, save_always=False):
        return _loop(program, self.params, self.optimizer, self.Xb, self.yb,
                     self.rem, self.Xv, self.yv, num_epochs, self.scheduler,
                     keeper, logger, self.generator, save_always)

    def score(self, params, cfg, logger, binary_threshold, threshold_mode,
              tag="y_hat", X=None):
        """The test metrics of ``params``' y_hat on the test set, or on
        ``X`` (time-major, e.g. the test set with a modality zeroed)."""
        y_hat = _predict_y(params, cfg, self.name,
                           self.Xte if X is None else X, self.dev)
        logger.text(f"scoring {tag}")
        return _score(y_hat, self.yte, cfg, binary_threshold, threshold_mode)


def _steps(history):
    return sum(1 for e in history if not e.get("diverged"))


# the model types train_mfm takes, with the standard (decoded, reg,
# missing) return, as the JAX package's
STANDARD = ("mfm", "kl", "kl_ef", "m_a", "m_b", "m_c", "m_d")


def train_mfm(X_train, y_train, X_valid, y_valid, X_test, y_test, cfg, *,
              lr: Optional[float] = None,
              logger: Optional[RunLogger] = None,
              seed: int = 123,
              binary_threshold: float = 0.0,
              threshold_mode: str = "ge",
              include_remainder: bool = False,
              model_type: Optional[str] = None,
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
    keeper = BestKeeper("min")
    history = run.loop(TrainProgram(run.apply_fn, cfg, "joint"), keeper,
                       cfg.num_epochs, logger)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)
    metrics = run.score(best_params, cfg, logger, binary_threshold,
                        threshold_mode)
    logger.record("final", **metrics)
    return {"metrics": metrics, "params": best_params,
            "opt_state": run.optimizer.state_dict(), "history": history,
            "best_valid": keeper.best, "step": _steps(history)}


def train_beta_vae(X_train, y_train, X_valid, y_valid, X_test, y_test, cfg,
                   *, lr: Optional[float] = None,
                   logger: Optional[RunLogger] = None,
                   seed: int = 123,
                   binary_threshold: float = 0.0,
                   threshold_mode: str = "ge",
                   include_remainder: bool = False,
                   device=None):
    """The two-stage schedule of MFM_KL_EF (``kl_ef``): stage 1 trains
    ``gen + lda_mmd * kld`` for ``num_epochs``, stage 2 ``disc + lda_mmd *
    kld`` for ``num_epochs``. One Adam and one ReduceLROnPlateau span both
    stages (lr decays carry from stage 1 into stage 2); each stage has its
    own best-keeper, which keeps every epoch (the reference saves
    unconditionally). The last parameters are the ones scored and
    returned."""
    logger = logger or RunLogger()
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "kl_ef", lr=lr, seed=seed,
                 include_remainder=include_remainder, device=device)
    history = []
    for stage in (1, 2):
        program = TrainProgram(run.apply_fn, cfg, "beta_vae", stage=stage)
        h = run.loop(program, BestKeeper("min"), cfg.num_epochs, logger,
                     save_always=True)
        history.extend({**e, "stage": stage} for e in h)
        if h and h[-1].get("diverged"):
            break
    metrics = run.score(run.params, cfg, logger, binary_threshold,
                        threshold_mode)
    logger.record("final", **metrics)
    return {"metrics": metrics, "params": run.params,
            "opt_state": run.optimizer.state_dict(), "history": history,
            "step": _steps(history)}


def train_mfm_missing(X_train, y_train, X_valid, y_valid, X_test, y_test,
                      cfg, *, lr: Optional[float] = None,
                      logger: Optional[RunLogger] = None,
                      seed: int = 123,
                      binary_threshold: float = 0.0,
                      threshold_mode: str = "ge",
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
    keeper = BestKeeper("min")
    history = run.loop(TrainProgram(run.apply_fn, cfg, "missing"), keeper,
                       cfg.num_epochs, logger)
    best_params = (keeper.best_params if keeper.best_params is not None
                   else run.params)

    Xte = run.on_device(run.Xte)
    with torch.no_grad():
        decoded, nol, noa, nov, _, _ = run.apply_fn(
            _to_device(best_params, run.dev), Xte, cfg,
            generator=torch.Generator(device=run.dev).manual_seed(0),
            train=False)
    x_l, x_a, x_v = split_modalities(Xte, cfg.input_dims)
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
            "best_valid": keeper.best, "step": _steps(history)}


def train_mfm_test_zeros(X_train, y_train, X_valid, y_valid, X_test,
                         y_test, cfg, *, lr: Optional[float] = None,
                         logger: Optional[RunLogger] = None,
                         seed: int = 123,
                         binary_threshold: float = 0.0,
                         threshold_mode: str = "ge",
                         device=None):
    """Plain MFM trained as ``train_mfm`` does, without the remainder
    batch; at test time each modality's input slice is zeroed in turn and
    the best parameters' y_hat scored: ``metrics`` is keyed
    ``y_hat_nol``, ``y_hat_noa`` and ``y_hat_nov``."""
    logger = logger or RunLogger()
    run = _Setup((X_train, y_train, X_valid, y_valid, X_test, y_test), cfg,
                 "mfm", lr=lr, seed=seed, include_remainder=False,
                 device=device)
    keeper = BestKeeper("min")
    history = run.loop(TrainProgram(run.apply_fn, cfg, "joint"), keeper,
                       cfg.num_epochs, logger)
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
            "best_valid": keeper.best, "step": _steps(history)}


def train_mfm_ablation(X_train, y_train, X_valid, y_valid, X_test, y_test,
                       cfg, **kw):
    """The ablations ``m_a``..``m_d``: ``train_mfm``'s joint loss and loop
    on ``cfg.model_type``."""
    if cfg.model_type not in ("m_a", "m_b", "m_c", "m_d"):
        raise ValueError(f"train_mfm_ablation trains m_a..m_d, got "
                         f"{cfg.model_type!r}")
    return train_mfm(X_train, y_train, X_valid, y_valid, X_test, y_test,
                     cfg, model_type=cfg.model_type, **kw)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev)
