"""Command line of the port: ``python -m factorized_tpu_torch mosi``,
``... test_mosi`` and ``... serve``.

Ported subcommands: ``mosi`` (``factorized_tpu/cli.py``'s ``run_dataset``
for MOSI: modes ``single`` (``--config`` or the defaults), ``best`` and
``search`` with ``--trials``; the real files under ``--data-root`` with
``--feature-selection`` and ``--normalize-covarep``, else the synthetic
set; ``--resume``, ``--ckpt-every`` and ``--save-ckpt``) with ``--type
mfm``, ``kl``, ``kl_ef``, the ablations ``m_a``..``m_d``, ``--missing 1``
and ``--zeros 1``;
``test_mosi`` (``run_test_mosi``: score a checkpoint on the MOSI test
set, then the latency probe and the on-device latency); and ``serve``
(``run_serve``, from a checkpoint of this package or an exported
artifact, with ``--autotune`` and ``--export``). Each runs on the CUDA
card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import random

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


def base_config(args):
    """``--config``'s ``MFMConfig`` (the legacy schema accepted), else the
    defaults at seqlength 20: ``--mode single``'s base, and in every mode
    the seqlength the data is cut to."""
    from factorized_tpu_torch.config import MFMConfig

    return (MFMConfig.from_json(args.config) if args.config
            else MFMConfig(seqlength=20))


def mosi_config(args, base=None, info=None, rng=None):
    """The configuration of a ``mosi`` trial: a ``sample_search_config``
    draw from ``rng`` in ``--mode search``, ``best_acc_mosi_config`` in
    ``--mode best`` and ``base`` (``base_config``) in ``--mode single``,
    with ``--type``, ``--missing`` and ``--zeros``, the data's input dims
    (``info``, ``dataset_info``; MOSI's by default) and ``--epochs`` and
    ``--batchsize`` applied."""
    from factorized_tpu_torch.config import (best_acc_mosi_config,
                                             sample_search_config)

    info = info or MOSI
    pick = dict(model_type=args.type, missing=args.missing, zeros=args.zeros)
    if args.mode == "search":
        cfg = sample_search_config("mosi", rng, **pick).replace(
            input_dims=info["input_dims"])
    elif args.mode == "best":
        cfg = best_acc_mosi_config(**pick).replace(
            input_dims=info["input_dims"])
    else:
        cfg = (base or base_config(args)).replace(
            **pick, input_dims=info["input_dims"],
            output_dim=info["output_dim"], task=info["task"])
    trainer_name(cfg)
    if args.epochs:
        cfg = cfg.replace(num_epochs=args.epochs)
    if args.batchsize:
        cfg = cfg.replace(batchsize=args.batchsize)
    return cfg


def load_mosi(seqlength, data_root=None, feature_selection=True,
              normalize_covarep=False):
    from factorized_tpu_torch.data import mosi

    return mosi.get_data(seqlength, feature_selection=feature_selection,
                         data_root=data_root,
                         normalize_covarep=normalize_covarep)


def dataset_info(data, args):
    """MOSI's entry with the input dims of the loaded data: on the raw
    path (``--feature-selection 0``) text 300, covarep 34 and the rest
    the files' facet (``mfm_mosi.py:60-73``)."""
    if getattr(args, "feature_selection", 1):
        return MOSI
    return dict(MOSI, input_dims=[300, 34, int(data[0].shape[2]) - 334])


def make_autosnapshot(out, tag, cfg, every):
    """``--ckpt-every N``: every N epochs overwrite
    ``<out>/ckpt_auto_<tag>`` with the current parameters, Adam state,
    whole-run step, lr and best validation loss, from which ``--resume``
    goes on. Its cadence (``.every``) aligns the chunked loop's chunks to
    it. None for N = 0."""
    if not every:
        return None
    import math

    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    def snap(epoch, params, opt_state, lr, best_valid):
        if (epoch + 1) % every:
            return
        meta = cfg.to_dict()
        meta["_resume_lr"] = lr
        if best_valid is not None and math.isfinite(best_valid):
            meta["_resume_best_valid"] = best_valid
        save_checkpoint(f"{out}/ckpt_auto_{tag}", params,
                        opt_state=opt_state, step=epoch + 1, config=meta)

    snap.every = every
    return snap


def run_mosi(args):
    """The JAX package's ``run_dataset`` for MOSI: one trial in ``--mode
    single`` and ``best``, ``--trials`` of them in ``--mode search`` (0:
    until stopped), each a run id ``mosi_<trial>`` with seed ``--seed`` +
    trial, the draws from one ``random.Random(--seed)``. ``--resume``
    applies to every trial. mosi's Adam lr is ``--lr`` (1e-3 by default),
    never the drawn ``cfg.lr``. ``--save-ckpt`` writes the best
    parameters with the last Adam state and step under
    ``<out>/ckpt_mosi_<trial>``, as the JAX package does."""
    from factorized_tpu_torch import resolve_device, trainers
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint
    from factorized_tpu_torch.utils.logging import RunLogger

    base = base_config(args)
    if args.mode == "single":
        mosi_config(args, base)  # a config no ported trainer takes exits
    device = resolve_device(args.device)
    data = load_mosi(base.seqlength, data_root=args.data_root,
                     feature_selection=bool(args.feature_selection),
                     normalize_covarep=args.normalize_covarep)
    info = dataset_info(data, args)
    rng = random.Random(args.seed)
    trial = 0
    while True:
        cfg = mosi_config(args, base, info, rng)
        tag = f"mosi_{trial}"
        logger = RunLogger(args.out, run_id=tag)
        logger.text(json.dumps(cfg.to_legacy(), default=str))
        logger.record("config", **cfg.to_dict())
        try:
            train = getattr(trainers, trainer_name(cfg))
            res = train(*data, cfg, lr=args.lr, logger=logger,
                        seed=args.seed + trial,
                        binary_threshold=info["threshold"],
                        threshold_mode=info["mode"],
                        resume_from=args.resume,
                        snapshot=make_autosnapshot(args.out, tag, cfg,
                                                   args.ckpt_every),
                        device=device)
            if args.save_ckpt:
                path = f"{args.out}/ckpt_{tag}"
                # what a resume reads back: the last epoch's lr and the
                # best validation loss so far, as the JAX package writes
                meta_cfg = cfg.to_dict()
                if res.get("history"):
                    meta_cfg["_resume_lr"] = res["history"][-1].get("lr")
                if "best_valid" in res:
                    meta_cfg["_resume_best_valid"] = res["best_valid"]
                save_checkpoint(path, res["params"],
                                opt_state=res["opt_state"],
                                step=res["step"], config=meta_cfg)
                logger.text(f"checkpoint saved to {path}")
        finally:
            logger.close()
        trial += 1
        if args.mode != "search" or (args.trials and trial >= args.trials):
            break
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
    sp = sub.add_parser("mosi", help="train MFM on CMU-MOSI (the real "
                                     "files under --data-root, else a "
                                     "synthetic set)")
    sp.add_argument("--config", default=None,
                    help="JSON config (legacy schema accepted): --mode "
                         "single's configuration; in every mode its "
                         "seqlength")
    sp.add_argument("--type", default="mfm",
                    help="model type; mfm, kl, kl_ef and m_a..m_d are "
                         "ported")
    sp.add_argument("--mode", default="single",
                    choices=["single", "best", "search"],
                    help="single: --config or the MFMConfig defaults; "
                         "best: best_acc_mosi_config; search: random "
                         "draws of the reference's search space")
    sp.add_argument("--trials", type=int, default=1,
                    help="search trials (0 = run until stopped)")
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
    sp.add_argument("--data-root", default=None,
                    help="the CMU-MOSI files' directory (the reference's "
                         "layout); the synthetic set where it is not one")
    sp.add_argument("--feature-selection", type=int, choices=(0, 1),
                    default=1, metavar="{0,1}",
                    help="1: the fs mask's covarep and facet columns "
                         "(default); 0: raw covarep columns 1:35 and the "
                         "whole facet (mfm_mosi.py:37,60-73)")
    sp.add_argument("--normalize-covarep", action="store_true",
                    help="max-abs normalise covarep by train statistics, "
                         "as the reference's get_data_missing")
    sp.add_argument("--out", default="runs",
                    help="directory of the JSONL logs and the checkpoints")
    sp.add_argument("--save-ckpt", action="store_true",
                    help="save each trial's best parameters with the last "
                         "optimizer state under <out>/ckpt_mosi_<trial>")
    sp.add_argument("--resume", default=None,
                    help="checkpoint directory to resume each trial from")
    sp.add_argument("--ckpt-every", type=int, default=0,
                    help="every N epochs overwrite <out>/ckpt_auto_mosi_"
                         "<trial> with the current parameters, optimizer "
                         "state and step")
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
