"""Whether two reverse steps per iteration of the encode backward save
anything on a training epoch: the port of
``scripts/twostep_bwd_probe.py``, on the port's kernels.

The two-step kernel (``cuda_mfn`` variant ``"two_step"``) takes the
reverse steps in pairs (s, s - 1), fetching both steps' loaded operands
at the pair's head, as the TPU kernel takes two steps per grid
iteration; the carries and the arithmetic are the one-step kernel's. ``measure`` trains ``mfm`` at
``best_acc_mosi_config`` (default) through the port's
``TrainProgram.epoch`` with Adam at lr 1e-3 on NB = 39 batches of 32 at
T = 20 (random normal inputs and labels from a seed), once with the
training path's backward (``"stream"``) and once with the two-step one,
chosen by the ``bwd_variant`` argument of ``mfm_apply``. Each
measurement is one warm epoch, then the best of ``--groups`` groups of
``--epochs`` epochs, by the host clock up to the epoch's tracked loss
read back. The epoch is paced by the host, whose speed drifts within a
run, so the two are measured in turns (one-step, two-step, two-step,
one-step) and each keeps its better run.

Run from the repository root: ``python -m
factorized_tpu_torch.probes.twostep_bwd_probe`` on the card,
``--device cpu`` on the CPU. It ends with one JSON line: ``onestep`` and
``twostep`` in steps/s (``runs``: all four in order), and
``tracked_loss_match``, whether the first epoch's tracked losses agree
within 1e-4.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.config import best_acc_mosi_config
from factorized_tpu_torch.models import mfm
from factorized_tpu_torch.train import TrainProgram, make_optimizer

NB = 39


def measure(label, variant, cfg=None, nb=NB, *, device, groups=4,
            epochs=5):
    """Steps/s of ``mfm`` training at ``cfg`` (batch ``cfg.batchsize``,
    t ``cfg.seqlength``) over ``nb`` batches with the encode backward
    ``variant``, and the first epoch's tracked loss."""
    cfg = cfg or best_acc_mosi_config()
    t, n = cfg.seqlength, cfg.batchsize
    dev = resolve_device(device)
    tree = mfm.MFM(cfg, seed=123, device=dev).tree()
    opt = make_optimizer(tree, 1e-3)
    program = TrainProgram(
        functools.partial(mfm.mfm_apply, bwd_variant=variant), cfg, "joint")
    rng = np.random.default_rng(0)
    Xb = torch.from_numpy(rng.normal(size=(nb, t, n, cfg.d_total))
                          .astype(np.float32)).to(dev)
    yb = torch.from_numpy(rng.normal(size=(nb, n)).astype(np.float32)).to(dev)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    first = float(program.epoch(tree, opt, Xb, yb, generator(2), 1e-3))
    times = []
    for g in range(groups):
        t0 = time.perf_counter()
        for i in range(epochs):
            acc = program.epoch(tree, opt, Xb, yb,
                                generator(3000 + epochs * g + i), 1e-3)
            float(acc)
        times.append((time.perf_counter() - t0) / epochs)
    dt = min(times)
    print(f"{label}: best {dt * 1e3:.1f} ms/epoch = {nb / dt:.1f} steps/s "
          f"(first tracked {first:.5f})", file=sys.stderr)
    return nb / dt, first


def main(argv=None, cfg=None, nb=NB):
    """Runs the probe at ``cfg`` (default ``best_acc_mosi_config``, whose
    t must be even), prints its JSON line and returns the results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5,
                    help="epochs per timed group")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(cfg=cfg, nb=nb, device=dev, groups=args.groups,
              epochs=args.epochs)
    results = {"device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "nb": nb, "unit": "steps/s"}
    runs = [measure(label, variant, **kw) for label, variant in (
        ("onestep (training path)", "stream"), ("twostep", "two_step"),
        ("twostep", "two_step"), ("onestep (training path)", "stream"))]
    results["onestep"] = max(runs[0][0], runs[3][0])
    results["twostep"] = max(runs[1][0], runs[2][0])
    results["runs"] = [r[0] for r in runs]
    results["first_tracked"] = [r[1] for r in runs]
    results["tracked_loss_match"] = bool(
        max(results["first_tracked"]) - min(results["first_tracked"]) < 1e-4)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
