"""Command line of the port: ``python -m factorized_tpu_torch mosi``,
``... moud``, ``... you``, ``... mmmo``, ``... mosi_acc``, ``...
test_mosi`` and ``... serve``.

Ported subcommands: the datasets ``mosi``, ``moud``, ``you`` and ``mmmo``
(``factorized_tpu/cli.py``'s ``run_dataset`` over its ``DATASETS``
table: modes ``single`` (``--config`` or the defaults), ``best`` and
``search`` with ``--trials``; the real files under ``--data-root``, for
MOSI with ``--feature-selection`` and ``--normalize-covarep``, else each
dataset's synthetic set; ``--resume``, ``--ckpt-every`` and
``--save-ckpt``) with ``--type mfm``, ``kl``, ``kl_ef``, the ablations
``m_a``..``m_d``, ``--missing 1`` (with ``--type mfm``, ``s2s`` or
``bm``) and ``--zeros 1``; ``mosi_acc`` (``run_mosi_acc``: MOSI's labels
binarized ``y >= 0``, the accuracy-keeping trainer); ``test_mosi``
(``run_test_mosi``: score a checkpoint on the MOSI test set, then the
latency probe and the on-device latency); and ``serve`` (``run_serve``,
from a checkpoint of this package or an exported artifact, with
``--autotune`` and ``--export``). Each runs on the CUDA card unless
``--device`` says otherwise. ``mosi_sdk``, ``mosei_sdk``, ``--seeds``
above 1, ``--bucket`` and ``--evolve`` exit with "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import random

# each dataset's task, binary threshold and its mode, input dims, output
# dim and whether the trainers take the ragged remainder batch
# (factorized_tpu/cli.py DATASETS)
DATASETS = {
    "mosi": dict(task="regression", threshold=0.0, mode="ge",
                 input_dims=[300, 5, 20], output_dim=1),
    "moud": dict(task="classification", threshold=None, mode="ge",
                 input_dims=[300, 74, 36], output_dim=2,
                 include_remainder=True),
    "you": dict(task="classification", threshold=None, mode="ge",
                input_dims=[300, 74, 36], output_dim=3,
                include_remainder=True),
    "mmmo": dict(task="regression", threshold=3.5, mode="gt",
                 input_dims=[300, 74, 36], output_dim=1),
}
# the JAX package's dataset subcommands that the port does not have yet
NOT_YET_PORTED = ("mosi_sdk", "mosei_sdk")


# the trainers of the JAX package's dispatch that the port has
PORTED_TRAINERS = ("train_mfm", "train_beta_vae", "train_mfm_missing",
                   "train_mfm_test_zeros", "train_mfm_ablation",
                   "train_seq2seq", "train_basic_missing", "train_mfm_acc")


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
            f"({name}) is not yet ported")
    return name


def refuse_unported(args):
    """Exit with "not yet ported" where ``args`` ask for a search strategy
    or lanes of seeds the port does not have, before any data loads."""
    for flag, on in (("--seeds", args.seeds > 1), ("--bucket", args.bucket),
                     ("--evolve", args.evolve)):
        if on:
            raise SystemExit(f"{flag} is not yet ported (the JAX package's "
                             f"parallel/multiseed.py and multiconfig.py)")


def run_not_ported(args):
    raise SystemExit(f"{args.dataset} is not yet ported: its reader of the "
                     f"CMU-MultimodalSDK .csd files is the JAX package's "
                     f"data/mmsdk.py")


def base_config(args):
    """``--config``'s ``MFMConfig`` (the legacy schema accepted), else the
    defaults at seqlength 20: ``--mode single``'s base, and in every mode
    the seqlength the data is cut to."""
    from factorized_tpu_torch.config import MFMConfig

    return (MFMConfig.from_json(args.config) if args.config
            else MFMConfig(seqlength=20))


def trial_config(args, base=None, info=None, rng=None):
    """The configuration of a trial of ``args.dataset``: a
    ``sample_search_config`` draw of the dataset's space from ``rng`` in
    ``--mode search`` (the data's input dims), ``best_acc_mosi_config``
    in ``--mode best`` and ``base`` (``base_config``) in ``--mode
    single`` (each with the dataset's input dims, output dim and task),
    with ``--type``, ``--missing`` and ``--zeros``, then ``--epochs`` and
    ``--batchsize`` applied. ``info`` is ``dataset_info``'s entry (by
    default the table's)."""
    from factorized_tpu_torch.config import (best_acc_mosi_config,
                                             sample_search_config)

    info = info or DATASETS[args.dataset]
    pick = dict(model_type=args.type, missing=args.missing, zeros=args.zeros)
    if args.mode == "search":
        cfg = sample_search_config(args.dataset, rng, **pick).replace(
            input_dims=info["input_dims"])
    else:
        cfg = (best_acc_mosi_config(**pick) if args.mode == "best"
               else (base or base_config(args)).replace(**pick))
        cfg = cfg.replace(input_dims=info["input_dims"],
                          output_dim=info["output_dim"], task=info["task"])
    trainer_name(cfg)
    return overridden(args, cfg)


def overridden(args, cfg):
    """``cfg`` with ``--epochs`` and ``--batchsize`` applied."""
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


def load_dataset(name, seqlength, args):
    """The six arrays of dataset ``name``: its real files under
    ``--data-root``, else its synthetic set. ``--feature-selection 0``
    and ``--normalize-covarep`` apply to MOSI alone
    (``mfm_mosi.py:37,60-73``)."""
    feature_selection = bool(args.feature_selection)
    if name == "mosi":
        return load_mosi(seqlength, data_root=args.data_root,
                         feature_selection=feature_selection,
                         normalize_covarep=args.normalize_covarep)
    if not feature_selection or args.normalize_covarep:
        flag = ("--feature-selection 0" if not feature_selection
                else "--normalize-covarep")
        raise SystemExit(
            f"{flag} only applies to the mosi dataset (reference "
            f"mfm_mosi.py:37,60-73); got dataset={name!r}")
    from factorized_tpu_torch.data import mmmo, moud, youtube

    reader = {"moud": moud, "you": youtube, "mmmo": mmmo}[name]
    return reader.get_data(seqlength, data_root=args.data_root)


def dataset_info(name, data, args):
    """The ``DATASETS`` entry of ``name``; on MOSI's raw path
    (``--feature-selection 0``) with the loaded data's input dims: text
    300, covarep 34 and the rest the files' facet (``mfm_mosi.py:60-73``)."""
    info = DATASETS[name]
    if name != "mosi" or args.feature_selection:
        return info
    return dict(info, input_dims=[300, 34, int(data[0].shape[2]) - 334])


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


def dispatch_trainer(data, cfg, info, **kw):
    """The trainer of ``cfg`` (``trainer_name``) on ``data``, with the
    dataset's binary threshold where it has one (not for ``s2s``, which
    scores no label) and its remainder batch for ``train_mfm`` and
    ``train_beta_vae``, as the JAX package's ``dispatch_trainer``."""
    from factorized_tpu_torch import trainers

    name = trainer_name(cfg)
    if info["threshold"] is not None and name != "train_seq2seq":
        kw.update(binary_threshold=info["threshold"],
                  threshold_mode=info["mode"])
    if name in ("train_mfm", "train_beta_vae"):
        kw["include_remainder"] = info.get("include_remainder", False)
    return getattr(trainers, name)(*data, cfg, **kw)


def save_run(out, tag, cfg, res, logger):
    """``--save-ckpt``: a trial's best parameters with the last Adam state
    and step under ``<out>/ckpt_<tag>``, and what a resume reads back
    (the last epoch's lr, the best validation number), as the JAX package
    writes them."""
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    path = f"{out}/ckpt_{tag}"
    meta_cfg = cfg.to_dict()
    if res.get("history"):
        meta_cfg["_resume_lr"] = res["history"][-1].get("lr")
    if "best_valid" in res:
        meta_cfg["_resume_best_valid"] = res["best_valid"]
    save_checkpoint(path, res["params"], opt_state=res["opt_state"],
                    step=res["step"], config=meta_cfg)
    logger.text(f"checkpoint saved to {path}")


def run_trials(args, prefix, config_of, train, legacy_line=True):
    """The JAX package's trial loop of ``run_dataset`` and
    ``run_mosi_acc``: one trial in ``--mode single`` and ``best``,
    ``--trials`` of them in ``--mode search`` (0: until stopped), each a
    run id ``<prefix>_<trial>`` with seed ``--seed`` + trial, its config
    ``config_of(rng)`` from one ``random.Random(--seed)``, logged (with
    ``legacy_line`` also as the legacy JSON text) and trained by
    ``train(cfg, logger=, seed=, resume_from=, snapshot=)``.
    ``--resume``, ``--ckpt-every`` and ``--save-ckpt`` apply to every
    trial."""
    from factorized_tpu_torch.utils.logging import RunLogger

    rng = random.Random(args.seed)
    trial = 0
    while True:
        cfg = config_of(rng)
        tag = f"{prefix}_{trial}"
        logger = RunLogger(args.out, run_id=tag)
        if legacy_line:
            logger.text(json.dumps(cfg.to_legacy(), default=str))
        logger.record("config", **cfg.to_dict())
        try:
            res = train(cfg, logger=logger, seed=args.seed + trial,
                        resume_from=args.resume,
                        snapshot=make_autosnapshot(args.out, tag, cfg,
                                                   args.ckpt_every))
            if args.save_ckpt:
                save_run(args.out, tag, cfg, res, logger)
        finally:
            logger.close()
        trial += 1
        if args.mode != "search" or (args.trials and trial >= args.trials):
            break
    return 0


def run_dataset(args):
    """The JAX package's ``run_dataset``: ``run_trials`` of
    ``trial_config`` with run ids ``<dataset>_<trial>``, each through
    ``dispatch_trainer``. Adam's lr is the config's ``lr`` for the
    classification sets (``moud``, ``you``: ``mfm_moud.py:466``) and
    ``--lr`` (1e-3 by default) for ``mosi`` and ``mmmo``
    (``mfm_mosi.py:403``)."""
    from factorized_tpu_torch import resolve_device

    refuse_unported(args)
    base = base_config(args)
    if args.mode == "single":
        trial_config(args, base)  # a config no ported trainer takes exits
    device = resolve_device(args.device)
    data = load_dataset(args.dataset, base.seqlength, args)
    info = dataset_info(args.dataset, data, args)

    def train(cfg, **kw):
        lr = cfg.lr if info["task"] == "classification" else args.lr
        return dispatch_trainer(data, cfg, info, lr=lr, device=device, **kw)

    return run_trials(args, args.dataset,
                      lambda rng: trial_config(args, base, info, rng), train)


def run_mosi_acc(args):
    """The JAX package's ``run_mosi_acc``: MOSI (seqlength 20) with its
    labels binarized ``y >= 0`` (``mfm_mosi_acc.py:505-508``), trained by
    ``train_mfm_acc`` in ``run_trials`` with run ids ``mosi_acc_<trial>``:
    a ``sample_search_config("mosi")`` draw in ``--mode search``,
    ``best_acc_mosi_config`` in ``--mode best``, ``--config`` (else
    ``best_acc_mosi_config``) in ``--mode single``, each with MOSI's input
    dims; ``--type``, ``--missing`` and ``--zeros`` are not read. The
    logged and saved config is the one handed to the trainer, which
    trains it as a two-class classifier, as the JAX package records it."""
    import numpy as np

    from factorized_tpu_torch import resolve_device, trainers
    from factorized_tpu_torch.config import (MFMConfig,
                                             best_acc_mosi_config,
                                             sample_search_config)

    refuse_unported(args)
    base = (MFMConfig.from_json(args.config) if args.config
            else best_acc_mosi_config())
    device = resolve_device(args.device)
    data = list(load_dataset("mosi", 20, args))
    for i in (1, 3, 5):
        data[i] = (data[i] >= 0).astype(np.int64)
    dims = dataset_info("mosi", data, args)["input_dims"]

    def config_of(rng):
        if args.mode == "search":
            cfg = sample_search_config("mosi", rng)
        else:
            cfg = best_acc_mosi_config() if args.mode == "best" else base
        return overridden(args, cfg.replace(input_dims=dims))

    return run_trials(
        args, "mosi_acc", config_of,
        lambda cfg, **kw: trainers.train_mfm_acc(*data, cfg, device=device,
                                                 **kw),
        legacy_line=False)


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


def add_training_args(sp):
    """The arguments of the dataset subcommands and ``mosi_acc``."""
    sp.add_argument("--config", default=None,
                    help="JSON config (legacy schema accepted): --mode "
                         "single's configuration; in every mode its "
                         "seqlength")
    sp.add_argument("--type", default="mfm",
                    help="model type: mfm, kl, kl_ef, m_a..m_d, and s2s "
                         "and bm with --missing 1")
    sp.add_argument("--mode", default="single",
                    choices=["single", "best", "search"],
                    help="single: --config or the MFMConfig defaults; "
                         "best: best_acc_mosi_config; search: random "
                         "draws of the reference's search space")
    sp.add_argument("--trials", type=int, default=1,
                    help="search trials (0 = run until stopped)")
    sp.add_argument("--missing", type=int, default=0,
                    help="1: train the missing-modality model of --type "
                         "(mfm: MFM_missing; s2s; bm)")
    sp.add_argument("--zeros", type=int, default=0,
                    help="1: score with each modality zeroed in turn "
                         "(with --type mfm)")
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--batchsize", type=int, default=None)
    sp.add_argument("--lr", type=float, default=None,
                    help="Adam lr of mosi and mmmo (default 1e-3, "
                         "torch's); moud and you take the config's")
    sp.add_argument("--seed", type=int, default=123)
    sp.add_argument("--data-root", default=None,
                    help="the dataset's files (the reference's layout); "
                         "the synthetic set where it is not a directory")
    sp.add_argument("--feature-selection", type=int, choices=(0, 1),
                    default=1, metavar="{0,1}",
                    help="mosi only: 1 the fs mask's covarep and facet "
                         "columns (default); 0 raw covarep columns 1:35 "
                         "and the whole facet (mfm_mosi.py:37,60-73)")
    sp.add_argument("--normalize-covarep", action="store_true",
                    help="mosi only: max-abs normalise covarep by train "
                         "statistics, as the reference's get_data_missing")
    sp.add_argument("--out", default="runs",
                    help="directory of the JSONL logs and the checkpoints")
    sp.add_argument("--save-ckpt", action="store_true",
                    help="save each trial's best parameters with the last "
                         "optimizer state under <out>/ckpt_<run id>")
    sp.add_argument("--resume", default=None,
                    help="checkpoint directory to resume each trial from")
    sp.add_argument("--ckpt-every", type=int, default=0,
                    help="every N epochs overwrite <out>/ckpt_auto_<run "
                         "id> with the current parameters, optimizer "
                         "state and step")
    sp.add_argument("--seeds", type=int, default=1,
                    help="lanes of seeds: not yet ported (above 1 exits)")
    sp.add_argument("--bucket", action="store_true",
                    help="shape-bucketed search: not yet ported (exits)")
    sp.add_argument("--evolve", type=int, default=0, metavar="RUNGS",
                    help="successive-halving search: not yet ported "
                         "(above 0 exits)")
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")


def build_parser():
    p = argparse.ArgumentParser(prog="factorized_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    for name in (*DATASETS, *NOT_YET_PORTED):
        sp = sub.add_parser(name, help=(
            f"train on {name} (its files under --data-root, else a "
            f"synthetic set)" if name in DATASETS else
            f"{name}: not yet ported (exits)"))
        add_training_args(sp)
        sp.set_defaults(func=run_dataset if name in DATASETS
                        else run_not_ported, dataset=name)
    sp = sub.add_parser("mosi_acc", help="MOSI's binary-accuracy variant "
                                         "(labels y >= 0)")
    add_training_args(sp)
    sp.set_defaults(func=run_mosi_acc, dataset="mosi")

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
