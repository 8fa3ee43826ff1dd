"""Experiment-level trainers of the port (port of ``train_mfm`` of
``factorized_tpu/trainers.py``, with the semantics of its host loop
``_loop_host``).

``train_mfm`` takes numpy arrays shaped like the reference loaders emit
(batch-major ``(n, t, d)`` X, 1-D y) and an ``MFMConfig``; it trains on
the card unless ``device`` says otherwise and returns the results dict of
the JAX package's trainer: test metrics, the best parameters, the
optimizer state, the per-epoch history, the best validation loss and the
step count. Every random draw comes from one ``torch.Generator`` seeded
from ``seed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.models.mfm import MFM
from factorized_tpu_torch.train import (TrainProgram, make_batches,
                                        make_optimizer,
                                        shuffle_and_time_major)
from factorized_tpu_torch.utils.checkpoint import BestKeeper
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.metrics import score_regression
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


def _std_predict(apply_fn, cfg):
    """``predict(params, x, generator)``: y_hat of the eval forward,
    squeezed for one-dimensional regression."""
    squeeze = cfg.task == "regression" and cfg.output_dim == 1

    def predict(params, x, generator):
        with torch.no_grad():
            decoded, _, _ = apply_fn(params, x, cfg, generator=generator,
                                     train=False)
        y_hat = decoded[3]
        return torch.squeeze(y_hat, 1) if squeeze else y_hat

    return predict


def _score(y_hat, y_test, cfg, binary_threshold, threshold_mode):
    if cfg.task == "classification":
        raise NotImplementedError(
            "classification scoring is not yet ported")
    return score_regression(y_hat, y_test, binary_threshold, threshold_mode)


def _loop_host(program, params, optimizer, Xb, yb, remainder, Xv, yv,
               num_epochs, scheduler, keeper, logger, generator):
    """The per-epoch loop: train epoch -> full-set eval -> ReduceLROnPlateau
    -> best-valid keeper, with a divergence break (a non-finite train or
    valid loss ends the run before the scheduler and the keeper see it).
    Returns the history."""
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
        logger.epoch(epoch, train_loss, valid, saved, lr=lr)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "valid": valid, "lr": lr})
    return history


def train_mfm(X_train, y_train, X_valid, y_valid, X_test, y_test, cfg, *,
              lr: Optional[float] = None,
              logger: Optional[RunLogger] = None,
              seed: int = 123,
              binary_threshold: float = 0.0,
              threshold_mode: str = "ge",
              include_remainder: bool = False,
              model_type: Optional[str] = None,
              device=None):
    """Joint single-stage training of MFM under Adam (the torch default
    lr 1e-3 unless ``lr``) with ReduceLROnPlateau on the validation label
    loss, keeping the best epoch's parameters for the test score."""
    dev = resolve_device(device)
    logger = logger or RunLogger()
    Xtr, ytr, Xv, yv, Xte, yte = _prep_data(
        X_train, y_train, X_valid, y_valid, X_test, y_test, seed)
    name = model_type or cfg.model_type
    if name != "mfm":
        raise NotImplementedError(
            f"training model type {name!r} is not yet ported; only 'mfm'")
    _, apply_fn = get_model(name)
    model = MFM(cfg, seed=seed, device=dev)
    params = model.tree()
    generator = torch.Generator(device=dev).manual_seed(seed)
    lr = 1e-3 if lr is None else lr
    optimizer = make_optimizer(params, lr)

    program = TrainProgram(apply_fn, cfg, "joint")
    Xb, yb, rem = make_batches(Xtr, _labels(ytr, cfg), cfg.batchsize,
                               include_remainder)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Xb, yb = on_device(Xb), on_device(yb)
    if rem is not None:
        rem = (on_device(rem[0]), on_device(rem[1]))
    Xv, yv_t = on_device(Xv), on_device(_labels(yv, cfg))

    scheduler = ReduceLROnPlateau(lr)
    keeper = BestKeeper("min")
    history = _loop_host(program, params, optimizer, Xb, yb, rem, Xv, yv_t,
                         cfg.num_epochs, scheduler, keeper, logger,
                         generator)

    best_params = (keeper.best_params if keeper.best_params is not None
                   else params)
    predict = _std_predict(apply_fn, cfg)
    y_hat = predict(_to_device(best_params, dev), on_device(Xte),
                    torch.Generator(device=dev).manual_seed(0))
    logger.text("scoring y_hat")
    metrics = _score(y_hat.cpu().numpy(), _labels(yte, cfg), cfg,
                     binary_threshold, threshold_mode)
    logger.record("final", **metrics)
    step = sum(1 for e in history if not e.get("diverged"))
    return {"metrics": metrics, "params": best_params,
            "opt_state": optimizer.state_dict(), "history": history,
            "best_valid": keeper.best, "step": step}


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev)
