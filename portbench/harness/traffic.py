"""The one generator of traffic: a closed loop of whole trials, run back
to back, read from a traffic file.

A traffic file gives ``lanes`` (K: 1 is one trial at a time through the
configuration's own trainer; more is a bucket of K seeds through
``parallel.multiseed.train_mfm_multiseed``) and the epochs of the
set-up's warm-up trial; the dataset's split is the configuration's. Each trial (or bucket) gets a seed drawn
from the run's seed; a trial starts from fresh weights, as a user's
does.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np


def trial_seed(seed: int, i: int, warmup: bool = False) -> int:
    """The seed of trial ``i`` of a run seeded ``seed``, or of its
    warm-up trial (under 2**32)."""
    return int(np.random.SeedSequence([int(seed), 2 if warmup else 1,
                                       int(i)]).generate_state(1)[0])


class _Sink(io.TextIOBase):
    def write(self, s):
        return len(s)


def run_trial(cfg, config, traffic, data, seed, device):
    """One trial (or bucket) through the program's own entry point:
    {"seed", "lanes": [one dict a lane: "valids", "lrs" (each epoch's),
    "best_valid", "mae", "params", "epochs"]}. The program's printed
    scores go nowhere."""
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.parallel import multiseed
    from factorized_tpu_torch.utils.logging import RunLogger

    K = int(traffic["lanes"])
    kw = dict(lr=cfg.lr, seed=seed, logger=RunLogger(echo=False),
              device=device)
    with contextlib.redirect_stdout(_Sink()):
        if K == 1:
            out = getattr(trainers, config["trainer"])(*data, cfg, **kw)
        else:
            out = multiseed.train_mfm_multiseed(
                *data, cfg, n_seeds=K, model_type=cfg.model_type, **kw)
    return {"seed": seed, "lanes": lane_results(out, K)}


def lane_results(out, K):
    """A trainer's result as one dict a lane."""
    if K == 1:
        hist = [e for e in out["history"] if not e.get("diverged")]
        return [{"valids": [e["valid"] for e in hist],
                 "lrs": [e["lr"] for e in hist],
                 "best_valid": out["best_valid"],
                 "mae": out["metrics"]["mae"], "params": out["params"],
                 "epochs": out["step"],
                 "diverged": len(hist) < len(out["history"])}]
    lanes = []
    for k, r in enumerate(out["results"]):
        lanes.append({"valids": [e["valids"][k] for e in out["history"]],
                      "lrs": [e["lrs"][k] for e in out["history"]],
                      "best_valid": r["best_valid"],
                      "mae": r["metrics"]["mae"],
                      "params": _lane(out["lane_params"], k),
                      "epochs": out["step"],
                      "diverged": not np.isfinite(r["metrics"]["mae"])})
    return lanes


def _lane(tree, k):
    return {n: (_lane(v, k) if isinstance(v, dict) else v[k])
            for n, v in tree.items()}
