"""Command line of the port: ``python -m factorized_tpu_torch mosi``,
``... test_mosi`` and ``... serve``.

Ported subcommands: ``mosi`` (``factorized_tpu/cli.py``'s ``run_dataset``
for MOSI, modes ``best`` and ``single``, on the synthetic MOSI set) with
``--type mfm``, ``kl``, ``kl_ef``, the ablations ``m_a``..``m_d``,
``--missing 1`` and ``--zeros 1``;
``test_mosi`` (``run_test_mosi``: score a checkpoint on the MOSI test
set, then the latency probe and the on-device latency); and ``serve``
(``run_serve``, from a checkpoint of this package or an exported
artifact, with ``--autotune`` and ``--export``). Each runs on the CUDA
card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json

# MOSI's task and binary threshold (factorized_tpu/cli.py DATASETS)
MOSI = dict(task="regression", threshold=0.0, mode="ge",
            input_dims=[300, 5, 20], output_dim=1)


# the trainers of the JAX package's dispatch that the port has
PORTED_TRAINERS = ("train_mfm", "train_beta_vae", "train_mfm_missing",
                   "train_mfm_test_zeros", "train_mfm_ablation")


def trainer_name(cfg):
    """The trainer the JAX package's ``dispatch_trainer`` picks for
    ``cfg``, by the same if-chain. One the port does not have exits with
    "not yet ported"."""
    kind = cfg.model_type
    if cfg.missing == 1 and kind in ("bm", "mfm", "s2s"):
        name = {"bm": "train_basic_missing", "mfm": "train_mfm_missing",
                "s2s": "train_seq2seq"}[kind]
    elif cfg.zeros == 1 and kind == "mfm":
        name = "train_mfm_test_zeros"
    elif kind in ("mfm", "kl"):
        name = "train_mfm"
    elif kind == "kl_ef":
        name = "train_beta_vae"
    elif kind in ("m_a", "m_b", "m_c", "m_d"):
        name = "train_mfm_ablation"
    else:
        raise SystemExit(f"no trainer for type={kind!r} "
                         f"missing={cfg.missing} zeros={cfg.zeros}")
    if name not in PORTED_TRAINERS:
        raise SystemExit(
            f"--type {kind} --missing {cfg.missing} --zeros {cfg.zeros} "
            f"({name}) is not yet ported; the port trains --type mfm, "
            f"kl, kl_ef and m_a..m_d, --missing 1 and --zeros 1 (with "
            f"--type mfm)")
    return name


def mosi_config(args):
    """The configuration of a ``mosi`` run: ``best_acc_mosi_config`` in
    ``--mode best``, the ``MFMConfig`` defaults in ``--mode single``,
    with ``--type``, ``--missing``, ``--zeros``, ``--epochs`` and
    ``--batchsize`` applied."""
    from factorized_tpu_torch.config import MFMConfig, best_acc_mosi_config

    pick = dict(model_type=args.type, missing=args.missing, zeros=args.zeros)
    if args.mode == "best":
        cfg = best_acc_mosi_config(**pick)
        cfg = cfg.replace(input_dims=MOSI["input_dims"])
    else:
        cfg = MFMConfig(seqlength=20).replace(
            **pick, input_dims=MOSI["input_dims"],
            output_dim=MOSI["output_dim"], task=MOSI["task"])
    trainer_name(cfg)
    if args.epochs:
        cfg = cfg.replace(num_epochs=args.epochs)
    if args.batchsize:
        cfg = cfg.replace(batchsize=args.batchsize)
    return cfg


def load_mosi(seqlength):
    from factorized_tpu_torch.data import mosi

    return mosi.get_data(seqlength)


def run_mosi(args):
    from factorized_tpu_torch import resolve_device, trainers
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint
    from factorized_tpu_torch.utils.logging import RunLogger

    cfg = mosi_config(args)
    device = resolve_device(args.device)
    data = load_mosi(cfg.seqlength)
    logger = RunLogger(args.out, run_id="mosi_0")
    logger.text(json.dumps(cfg.to_legacy(), default=str))
    logger.record("config", **cfg.to_dict())
    try:
        train = getattr(trainers, trainer_name(cfg))
        res = train(*data, cfg, lr=args.lr, logger=logger, seed=args.seed,
                    binary_threshold=MOSI["threshold"],
                    threshold_mode=MOSI["mode"], device=device)
        if args.save_ckpt:
            path = f"{args.out}/ckpt_mosi_0"
            # what a resume reads back: the last epoch's lr and the best
            # validation loss so far, as the JAX package writes them
            meta_cfg = cfg.to_dict()
            if res.get("history"):
                meta_cfg["_resume_lr"] = res["history"][-1].get("lr")
            if "best_valid" in res:
                meta_cfg["_resume_best_valid"] = res["best_valid"]
            save_checkpoint(path, res["params"], opt_state=res["opt_state"],
                            step=res["step"], config=meta_cfg)
            logger.text(f"checkpoint saved to {path}")
    finally:
        logger.close()
    return 0


def run_test_mosi(args):
    """Score a checkpoint on the MOSI test set (synthetic when the real
    files are absent, as ``mosi``): regression, or classification of the
    binarized sentiment ``y >= 0``; then the latency probe and the
    on-device latency, one JSON line each."""
    import numpy as np

    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.utils.metrics import (score_classification,
                                                    score_regression)

    predictor = Predictor.from_checkpoint(args.checkpoint, device=args.device)
    _, _, _, _, X_test, y_test = load_mosi(predictor.cfg.seqlength)
    if args.autotune:
        tuned = predictor.autotune(X_test)
        print("autotuned batch sizes:", json.dumps(tuned),
              "-> using", predictor.batch_size)
    y_hat = predictor.predict(X_test)
    if predictor.cfg.task == "regression":
        score_regression(y_hat, y_test)
    else:
        score_classification(y_hat, (y_test >= 0).astype(np.int64))
    probe = predictor.probe(X_test)
    print("inference probe:", json.dumps(probe))
    dev = predictor.device_latency(X_test)
    print("on-device latency:", json.dumps(dev))
    return 0


def run_serve(args):
    import numpy as np

    from factorized_tpu_torch.serve import Predictor, serve_http

    if args.exported:
        if args.export:
            raise SystemExit(
                "--export only applies when loading from --checkpoint "
                "(the artifact is already exported)")
        predictor = Predictor.from_exported(args.exported, device=args.device)
        if args.autotune and not predictor._symbolic:
            raise SystemExit(
                "this artifact has a fixed batch shape "
                "(symbolic_batch=False at export time): --autotune "
                "needs a symbolic-batch artifact or --checkpoint")
    else:
        predictor = Predictor.from_checkpoint(args.checkpoint,
                                              device=args.device)
    if args.autotune:
        # tune on synthetic traffic shaped like the model's input
        d = sum(predictor.cfg.input_dims)
        X = np.random.default_rng(0).normal(
            size=(1024, predictor.cfg.seqlength, d)).astype(np.float32)
        tuned = predictor.autotune(X)
        print("autotuned batch sizes:", json.dumps(tuned),
              "-> using", predictor.batch_size)
    if args.export:
        out = predictor.export(args.export)
        print(f"exported artifact to {out}")
        return 0
    serve_http(predictor, args.host, args.port,
               micro_batch=not args.no_microbatch,
               max_wait_ms=args.max_wait_ms)
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="factorized_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("mosi", help="train MFM on (synthetic) CMU-MOSI")
    sp.add_argument("--type", default="mfm",
                    help="model type; mfm, kl, kl_ef and m_a..m_d are "
                         "ported")
    sp.add_argument("--mode", default="single", choices=["best", "single"],
                    help="best: best_acc_mosi_config; single: the "
                         "MFMConfig defaults")
    sp.add_argument("--missing", type=int, default=0,
                    help="1: train MFM_missing (with --type mfm)")
    sp.add_argument("--zeros", type=int, default=0,
                    help="1: score with each modality zeroed in turn "
                         "(with --type mfm)")
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--batchsize", type=int, default=None)
    sp.add_argument("--lr", type=float, default=None,
                    help="Adam lr (default 1e-3, torch's)")
    sp.add_argument("--seed", type=int, default=123)
    sp.add_argument("--out", default="runs",
                    help="directory of the JSONL log and the checkpoint")
    sp.add_argument("--save-ckpt", action="store_true",
                    help="save the trained parameters and the optimizer "
                         "state under <out>/ckpt_mosi_0")
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")
    sp.set_defaults(func=run_mosi)

    sp = sub.add_parser("test_mosi",
                        help="score a checkpoint on the MOSI test set")
    sp.add_argument("--checkpoint", required=True,
                    help="directory written by utils.checkpoint."
                         "save_checkpoint")
    sp.add_argument("--autotune", action="store_true",
                    help="pick the serving batch size by throughput")
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")
    sp.set_defaults(func=run_test_mosi)

    sp = sub.add_parser("serve", help="JSON-over-HTTP inference endpoint")
    group = sp.add_mutually_exclusive_group(required=True)
    group.add_argument("--checkpoint",
                       help="directory written by utils.checkpoint."
                            "save_checkpoint")
    group.add_argument("--exported",
                       help="serve from a Predictor.export artifact (no "
                            "model code or checkpoint needed)")
    sp.add_argument("--export", default=None, metavar="DIR",
                    help="write the forward (weights inside) to DIR by "
                         "torch.export, then exit; with --autotune the "
                         "tuned batch size goes into the artifact")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8787)
    sp.add_argument("--autotune", action="store_true",
                    help="pick the serving batch size by throughput "
                         "before accepting traffic")
    sp.add_argument("--no-microbatch", action="store_true",
                    help="disable dynamic request coalescing (serialize "
                         "requests behind a device lock instead)")
    sp.add_argument("--max-wait-ms", type=float, default=3.0,
                    help="micro-batch window after the first queued "
                         "request")
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")
    sp.set_defaults(func=run_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
