"""Command line of the port: ``python -m factorized_tpu_torch mosi``,
``... moud``, ``... you``, ``... mmmo``, ``... mosi_sdk``, ``...
mosei_sdk``, ``... mosi_acc``, ``... predictor``, ``... test_attention``,
``... multitrait``, ``... check``, ``... test_mosi``, ``... serve`` and
``... warmup``.

The subcommands: the datasets ``mosi``, ``moud``, ``you``, ``mmmo``,
``mosi_sdk`` and ``mosei_sdk`` (``factorized_tpu/cli.py``'s
``run_dataset`` over its ``DATASETS`` table: modes ``single``
(``--config`` or the defaults), ``best`` and ``search`` with
``--trials``; the real files under ``--data-root``, for MOSI with
``--feature-selection`` and ``--normalize-covarep``, else each dataset's
synthetic set; the ``*_sdk`` sets only from their CMU-MultimodalSDK
``.csd`` files under ``--data-root`` (``data/mmsdk.py``, read through
h5py), split by video with ``--split N_TRAIN,N_VALID``, their input dims
those of the files; ``--resume``, ``--ckpt-every`` and ``--save-ckpt``)
with ``--type mfm``, ``kl``, ``kl_ef``, the ablations ``m_a``..``m_d``,
``--missing 1`` (with ``--type mfm``, ``s2s`` or ``bm``) and ``--zeros
1``; ``mosi_acc`` (``run_mosi_acc``: MOSI's labels binarized ``y >= 0``,
the accuracy-keeping trainer); ``predictor`` (``run_predictor``: the
baselines ``--kind eflstm``, ``mfn`` and ``self_attention`` through
``train_predictor`` on ``--dataset``, ``--optimizer adam|sgd``, ``--best
mae|acc``); ``test_attention`` (``run_test_attention``); ``multitrait``
(``run_multitrait``: ``--style pom|iemocap``, and from the ``.csd``
files ``mosei_sdk`` (7 columns) and ``pom_sdk`` (17), a vector output
MFM); ``test_mosi`` (``run_test_mosi``: score a checkpoint on the MOSI
test set, then the latency probe and the on-device latency); ``serve``
(``run_serve``, from a checkpoint of this package or of the JAX package
(Orbax or msgpack, read without either) or an exported artifact, with ``--autotune`` and ``--export``); ``check`` (``run_check``:
the best metrics of every run log under ``--dir``, the port's copy of the
JAX package's ``check.py``); and ``warmup`` (``warmup.run_warmup``: the
kernels' library built and the main programs run once). ``--seeds K``
above 1 trains K seeds as lanes of one program on the dataset
subcommands and ``mosi_acc`` (``parallel.multiseed.train_mfm_multiseed``).
``--mode search --bucket`` (``run_bucket_search``) and ``--mode search
--evolve RUNGS`` with ``--cull-frac`` (``run_evolve_search``,
``run_multitrait_evolve``) train the search's draws as lanes of one
program, ``--seeds`` lanes a config (``parallel.multiconfig``), on the
dataset subcommands and ``multitrait``. ``--seed-parallel`` shares
those lanes out over the world's ranks (``seed_parallel_mesh``) and
``--multihost`` joins the world first (``parallel.sharding.
init_distributed``: torchrun's or the JAX package's variables); rank 0
alone writes the logs and checkpoints. ``--profile DIR`` wraps the whole
command in ``utils.profiling.trace``. Each runs on the CUDA card unless
``--device`` says otherwise; ``predictor`` and ``test_attention`` refuse
``--seeds`` above 1, ``--bucket`` and ``--evolve`` (each trains one
model).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

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
    # MOSI and MOSEI from the CMU-MultimodalSDK .csd files (MOSEI's label
    # column 0, the sentiment); their input dims are the files'
    # (dataset_info)
    "mosi_sdk": dict(task="regression", threshold=0.0, mode="ge",
                     input_dims=[300, 74, 47], output_dim=1),
    "mosei_sdk": dict(task="regression", threshold=0.0, mode="ge",
                      input_dims=[300, 74, 35], output_dim=1),
}
# the multi-trait styles: synthetic or CSV sets, and the .csd files' (MOSEI
# with its 7 label columns, POM with its 17)
MULTITRAIT_STYLES = ("pom", "iemocap", "mosei_sdk", "pom_sdk")


def trainer_name(cfg):
    """The trainer the JAX package's ``dispatch_trainer`` picks for
    ``cfg``, by the same if-chain; a type it has none for exits."""
    kind = cfg.model_type
    if cfg.missing == 1 and kind in ("bm", "mfm", "s2s"):
        return {"bm": "train_basic_missing", "mfm": "train_mfm_missing",
                "s2s": "train_seq2seq"}[kind]
    if cfg.zeros == 1 and kind == "mfm":
        return "train_mfm_test_zeros"
    if kind in ("mfm", "kl"):
        return "train_mfm"
    if kind == "kl_ef":
        return "train_beta_vae"
    if kind in ("m_a", "m_b", "m_c", "m_d"):
        return "train_mfm_ablation"
    raise SystemExit(f"no trainer for type={kind!r} "
                     f"missing={cfg.missing} zeros={cfg.zeros}")


def seed_parallel_mesh(n_lanes, device=None):
    """The mesh of ``--seed-parallel`` (the JAX package's
    ``_seed_parallel_mesh``) over the world's ranks: 1-D over the lanes,
    or 2-D ``("seed", "batch")`` where the world exceeds and divides the
    lanes (each lane group then trains data-parallel over the spare
    ranks); where the lanes do not divide the world, the largest slice of
    it that divides them."""
    from factorized_tpu_torch.parallel.sharding import make_mesh, world_size

    n_dev = world_size()
    if n_dev > n_lanes and n_dev % n_lanes == 0:
        return make_mesh(n_dev, axes=("seed", "batch"),
                         shape=(n_lanes, n_dev // n_lanes), device=device)
    if n_lanes % n_dev:
        d = max(k for k in range(1, min(n_lanes, n_dev) + 1)
                if n_lanes % k == 0)
        print(f"--seed-parallel: {n_lanes} lanes do not divide "
              f"{n_dev} devices; using {d} device(s) for this program",
              file=sys.stderr)
        return make_mesh(d, device=device)
    return make_mesh(device=device)


def run_logger(args, run_id):
    """The run's logger: its JSONL under ``--out`` and its lines on rank 0
    of the world, nothing on the other ranks."""
    from factorized_tpu_torch.parallel.sharding import is_writer
    from factorized_tpu_torch.utils.logging import RunLogger

    if is_writer():
        return RunLogger(args.out, run_id=run_id)
    return RunLogger(run_id=run_id, echo=False)


def refuse_lane_flags(args):
    """Exit, before any data loads, where ``args`` ask ``predictor`` or
    ``test_attention`` for lanes (``--seeds`` above 1, ``--bucket``,
    ``--evolve``): the command trains one model, and the JAX package's
    reads none of the three."""
    for flag, on in (("--seeds", args.seeds > 1), ("--bucket", args.bucket),
                     ("--evolve", args.evolve)):
        if on:
            raise SystemExit(f"{flag} does not apply to {args.command}: "
                             f"the command trains one model (drop {flag})")


def refuse_off_search(args):
    """The JAX package's refusal of ``--bucket``/``--evolve`` outside
    ``--mode search``, which would never run them."""
    if args.mode != "search" and (args.evolve or args.bucket):
        flag = "--evolve" if args.evolve else "--bucket"
        raise SystemExit(
            f"{flag} only applies to --mode search (got --mode "
            f"{args.mode}); add --mode search or drop {flag}")


def parse_split(arg):
    """``--split "52,10"`` -> (52, 10): the train and valid video counts
    of the SDK sets, the rest test; None without the flag."""
    if arg is None:
        return None
    try:
        n_tr, n_va = (int(p) for p in arg.split(","))
    except ValueError:
        raise SystemExit(
            f"--split must be N_TRAIN,N_VALID video counts, got {arg!r}")
    return (n_tr, n_va)


def check_data_args(name, args):
    """Exit before any data loads where ``--split`` is malformed, or where
    ``name``, a set read from the .csd files (``*_sdk``), has no
    ``--data-root`` directory."""
    parse_split(getattr(args, "split", None))
    if name.endswith("_sdk") and not (args.data_root
                                      and os.path.isdir(args.data_root)):
        raise SystemExit(
            f"{name} needs --data-root pointing at a directory of "
            f"CMU-MultimodalSDK .csd files (read through h5py), got "
            f"{args.data_root!r}")


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
    ``--data-root``, else its synthetic set; the ``*_sdk`` sets from their
    .csd files alone (``mmsdk.get_data``, MOSEI's file names for
    ``mosei_sdk``), split by ``--split``. ``--feature-selection 0`` and
    ``--normalize-covarep`` apply to MOSI alone
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
    if name.endswith("_sdk"):
        from factorized_tpu_torch.data import mmsdk

        files = mmsdk.MOSEI_FILES if name == "mosei_sdk" else None
        return mmsdk.get_data(seqlength, data_root=args.data_root,
                              files=files,
                              split=parse_split(getattr(args, "split",
                                                        None)))
    from factorized_tpu_torch.data import mmmo, moud, youtube

    reader = {"moud": moud, "you": youtube, "mmmo": mmmo}[name]
    return reader.get_data(seqlength, data_root=args.data_root)


def dataset_info(name, data, args):
    """The ``DATASETS`` entry of ``name`` with the loaded data's input
    dims where the reader gives them (``mmsdk.SdkSplits.input_dims``), or
    on MOSI's raw path (``--feature-selection 0``): text 300, covarep 34
    and the rest the files' facet (``mfm_mosi.py:60-73``)."""
    info = DATASETS[name]
    dims = getattr(data, "input_dims", None)
    if dims:
        return dict(info, input_dims=list(dims))
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

    from factorized_tpu_torch.parallel.sharding import is_writer
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    def snap(epoch, params, opt_state, lr, best_valid):
        if (epoch + 1) % every or not is_writer():
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


def save_run(out, tag, cfg, res, logger,
             resume=("_resume_lr", "_resume_best_valid")):
    """``--save-ckpt``: a trial's best parameters with the last optimizer
    state and step under ``<out>/ckpt_<tag>``, and of what a resume reads
    back those the JAX package writes for the command (``resume``: the
    last epoch's lr, the best validation number)."""
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    path = f"{out}/ckpt_{tag}"
    meta_cfg = cfg.to_dict()
    if res.get("history") and "_resume_lr" in resume:
        meta_cfg["_resume_lr"] = res["history"][-1].get("lr")
    if "best_valid" in res and "_resume_best_valid" in resume:
        meta_cfg["_resume_best_valid"] = res["best_valid"]
    save_checkpoint(path, res["params"], opt_state=res.get("opt_state"),
                    step=res["step"], config=meta_cfg)
    logger.text(f"checkpoint saved to {path}")


def run_trials(args, prefix, config_of, train, legacy_line=True,
               record=None, save=save_run):
    """The JAX package's trial loop of ``run_dataset``, ``run_mosi_acc``,
    ``run_predictor`` and ``run_multitrait``: one trial in ``--mode
    single`` and ``best``, ``--trials`` of them in ``--mode search`` (0:
    until stopped), each a run id ``<prefix>_<trial>`` with seed
    ``--seed`` + trial, its config ``config_of(rng)`` from one
    ``random.Random(--seed)``, logged (with ``legacy_line`` also as the
    legacy JSON text; ``record``'s fields ahead of the config's) and
    trained by ``train(cfg, logger=, seed=, resume_from=, snapshot=)``.
    ``--resume``, ``--ckpt-every`` and ``--save-ckpt`` (``save(out, tag,
    cfg, res, logger)``) apply to every trial, on rank 0 alone."""
    from factorized_tpu_torch.parallel.sharding import is_writer

    rng = random.Random(args.seed)
    trial = 0
    while True:
        cfg = config_of(rng)
        tag = f"{prefix}_{trial}"
        logger = run_logger(args, tag)
        if legacy_line:
            logger.text(json.dumps(cfg.to_legacy(), default=str))
        logger.record("config", **(record or {}), **cfg.to_dict())
        try:
            res = train(cfg, logger=logger, seed=args.seed + trial,
                        resume_from=args.resume,
                        snapshot=make_autosnapshot(args.out, tag, cfg,
                                                   args.ckpt_every))
            if args.save_ckpt and is_writer():
                save(args.out, tag, cfg, res, logger)
        finally:
            logger.close()
        trial += 1
        if args.mode != "search" or (args.trials and trial >= args.trials):
            break
    return 0


def train_lanes(args, data, cfg, prefix, *, logger, seed, resume_from,
                snapshot, **kw):
    """``--seeds K``: ``train_mfm_multiseed`` of ``cfg`` over K lanes in
    place of the trial's trainer, its snapshot every ``--ckpt-every``
    epochs into ``<out>/ckpt_auto_<prefix>_<trial>`` (the trial from
    ``seed`` = ``--seed`` + trial), as the JAX package's command runs it;
    ``kw`` goes to the trainer (lr, threshold, valid metric, device);
    ``--seed-parallel`` shares the lanes out over the world's ranks."""
    from factorized_tpu_torch.parallel.multiseed import train_mfm_multiseed

    kw.update(logger=logger, seed=seed, n_seeds=args.seeds,
              resume_from=resume_from, ckpt_every=args.ckpt_every)
    if args.seed_parallel:
        kw["mesh"] = seed_parallel_mesh(args.seeds, kw.get("device"))
    if args.ckpt_every:
        kw["ckpt_dir"] = f"{args.out}/ckpt_auto_{prefix}_{seed - args.seed}"
    return train_mfm_multiseed(*data, cfg, **kw)


def refuse_lanes(args, cfg):
    """The JAX package's refusal of ``--seeds`` for a type the lane
    trainer does not train (its semantics would change) or with
    ``--missing``/``--zeros``."""
    from factorized_tpu_torch.parallel.multiseed import MULTISEED_TYPES

    if cfg.model_type not in MULTISEED_TYPES or cfg.missing or cfg.zeros:
        raise SystemExit(
            f"--seeds {args.seeds} is only supported for model "
            f"types {'/'.join(MULTISEED_TYPES)} without "
            f"--missing/--zeros; type {cfg.model_type!r} "
            f"(missing={cfg.missing}, zeros={cfg.zeros}) would "
            "otherwise silently train a single seed - drop "
            "--seeds or switch types")


def run_dataset(args):
    """The JAX package's ``run_dataset``: ``run_trials`` of
    ``trial_config`` (the input dims ``dataset_info``'s, those of the
    .csd files for the ``*_sdk`` sets) with run ids
    ``<dataset>_<trial>``, each through
    ``dispatch_trainer``, or with ``--seeds`` above 1 through
    ``train_lanes`` (``refuse_lanes`` first). Adam's lr is the config's
    ``lr`` for the classification sets (``moud``, ``you``:
    ``mfm_moud.py:466``) and ``--lr`` (1e-3 by default) for ``mosi`` and
    ``mmmo`` (``mfm_mosi.py:403``)."""
    from factorized_tpu_torch import resolve_device

    refuse_off_search(args)
    check_data_args(args.dataset, args)
    base = base_config(args)
    if args.mode == "single" and args.seeds <= 1:
        trial_config(args, base)  # a config no ported trainer takes exits
    device = resolve_device(args.device)
    data = load_dataset(args.dataset, base.seqlength, args)
    info = dataset_info(args.dataset, data, args)
    rng = random.Random(args.seed)
    if args.mode == "search" and args.evolve:
        return run_evolve_search(args, data, info, rng, device)
    if args.mode == "search" and args.bucket:
        return run_bucket_search(args, data, info, rng, device)

    def train(cfg, **kw):
        lr = cfg.lr if info["task"] == "classification" else args.lr
        if args.seeds > 1:
            refuse_lanes(args, cfg)
            if info["threshold"] is not None:
                kw.update(binary_threshold=info["threshold"],
                          threshold_mode=info["mode"])
            return train_lanes(args, data, cfg, args.dataset, lr=lr,
                               device=device, **kw)
        return dispatch_trainer(data, cfg, info, lr=lr, device=device, **kw)

    return run_trials(args, args.dataset,
                      lambda rng: trial_config(args, base, info, rng), train)


def run_bucket_search(args, data, info, rng, device, sample_fn=None,
                      prefix=None, record=None):
    """``--mode search --bucket``, the JAX package's ``run_bucket_search``:
    each round draws ``--trials`` configs (0: endless rounds of 16),
    groups them by shape (``multiconfig.bucket_configs``) and trains each
    group as one program of configs x ``--seeds`` lanes
    (``train_config_bucket``), run ids ``<prefix>_r<round>b<bucket>``, one
    ``config`` record a trial. ``moud``/``you`` take each config's lr,
    the others ``--lr``. ``sample_fn``/``prefix``: another surface's draw
    and run ids (``multitrait``); ``record``: fields ahead of each
    config's in its record (the .csd styles' trait names)."""
    from factorized_tpu_torch.config import sample_search_config
    from factorized_tpu_torch.parallel.multiconfig import (
        bucket_configs, train_config_bucket)

    prefix = prefix or args.dataset
    if sample_fn is None:
        def sample_fn():
            cfg = sample_search_config(args.dataset, rng,
                                       model_type=args.type,
                                       missing=args.missing,
                                       zeros=args.zeros)
            return cfg.replace(input_dims=info["input_dims"])

    n = args.trials or 16
    round_i = 0
    while True:
        cfgs = [overridden(args, sample_fn()) for _ in range(n)]
        buckets = bucket_configs(cfgs)
        print(f"bucket search round {round_i}: {len(cfgs)} configs -> "
              f"{len(buckets)} shape buckets "
              f"(sizes {[len(b) for b in buckets]})")
        for bi, idxs in enumerate(buckets):
            bucket = [cfgs[i] for i in idxs]
            logger = run_logger(args, f"{prefix}_r{round_i}b{bi}")
            for c in bucket:
                logger.record("config", **(record or {}), **c.to_dict())
            kw = dict(logger=logger, seed=args.seed + round_i,
                      seeds_per_config=max(args.seeds, 1), device=device)
            if info["task"] == "classification":
                kw["use_config_lr"] = True
            else:
                kw["lr"] = args.lr
            if info["threshold"] is not None:
                kw.update(binary_threshold=info["threshold"],
                          threshold_mode=info["mode"])
            if args.seed_parallel:
                kw["mesh"] = seed_parallel_mesh(
                    len(bucket) * max(args.seeds, 1), device)
            try:
                train_config_bucket(*data, bucket, **kw)
            finally:
                logger.close()
        round_i += 1
        if args.trials:
            break
    return 0


def _evolve_rounds(args, data, dataset, rng, make_template, prefix,
                   best_str, device, extra_kw=None, meta_extra=None):
    """The round loop of every ``--evolve`` surface, the JAX package's
    ``_evolve_rounds``: each round draws a template (``--epochs`` and
    ``--batchsize`` applied) and runs ``--evolve`` rungs over ``--trials``
    configs (0: endless rounds of 16) x ``--seeds`` lanes
    (``train_evolving_search``), run id ``<prefix>_evolve<round>``, its
    log opening with a ``search_meta`` record; ``--ckpt-every`` snapshots
    at every rung boundary into ``<out>/ckpt_auto_<prefix>_evolve<round>``
    and ``--resume`` restores round 0."""
    from factorized_tpu_torch.parallel.multiconfig import (
        train_evolving_search)

    n = args.trials or 16
    round_i = 0
    while True:
        template = overridden(args, make_template())
        logger = run_logger(args, f"{prefix}_evolve{round_i}")
        # "search_meta", not "config": check counts "config" records as
        # trials, and the search logs one per explored config
        logger.record("search_meta", evolve_rungs=args.evolve,
                      cull_frac=args.cull_frac, n_configs=n,
                      template=template.to_dict(), **(meta_extra or {}))
        kw = dict(n_configs=n, rungs=args.evolve, cull_frac=args.cull_frac,
                  rng=rng, logger=logger, seed=args.seed + round_i,
                  seeds_per_config=max(args.seeds, 1), device=device)
        if args.ckpt_every:
            # a rung boundary is the only point where the state holds
            kw["ckpt_dir"] = f"{args.out}/ckpt_auto_{prefix}_evolve{round_i}"
        if args.resume and round_i == 0:
            kw["resume_from"] = args.resume
        if args.seed_parallel:
            kw["mesh"] = seed_parallel_mesh(n * max(args.seeds, 1), device)
        kw.update(extra_kw or {})
        try:
            res = train_evolving_search(*data, template, dataset, **kw)
        finally:
            logger.close()
        print(f"{prefix} evolve round {round_i}: explored "
              f"{res['explored_configs']} configs over {args.evolve} "
              f"rungs; best {best_str(res)} (rung {res['best']['rung']})")
        round_i += 1
        if args.trials:
            break
    return 0


def run_evolve_search(args, data, info, rng, device):
    """``--mode search --evolve RUNGS`` on a dataset subcommand, the JAX
    package's ``run_evolve_search``: the template a draw of the dataset's
    space, ``moud``/``you`` each config's lr and the others ``--lr``, the
    dataset's threshold."""
    from factorized_tpu_torch.config import sample_search_config

    def make_template():
        t = sample_search_config(args.dataset, rng, model_type=args.type,
                                 missing=args.missing, zeros=args.zeros)
        return t.replace(input_dims=info["input_dims"])

    extra = ({"use_config_lr": True} if info["task"] == "classification"
             else {"lr": args.lr})
    if info["threshold"] is not None:
        extra.update(binary_threshold=info["threshold"],
                     threshold_mode=info["mode"])
    return _evolve_rounds(args, data, args.dataset, rng, make_template,
                          args.dataset,
                          lambda res: str(res["best"]["metrics"]), device,
                          extra_kw=extra)


def run_multitrait_evolve(args, data, input_dims, rng, device, meta):
    """``multitrait --mode search --evolve RUNGS``, the JAX package's
    ``run_multitrait_evolve``: draws of the ``mmmo`` space with a vector
    head of the set's traits, ranked by the mean test MAE over the
    traits, at ``--lr``; ``meta``: the ``search_meta`` record's fields
    (the style, and the .csd styles' traits)."""
    import numpy as np

    from factorized_tpu_torch.config import sample_search_config

    n_traits = int(np.asarray(data[1]).shape[1])

    def make_template():
        return sample_search_config("mmmo", rng, model_type=args.type).replace(
            input_dims=list(input_dims), task="regression",
            output_dim=n_traits)

    return _evolve_rounds(
        args, data, "mmmo", rng, make_template, args.style,
        lambda res: f"mean-MAE {res['best']['metrics']['mae_mean']:.4f}",
        device, extra_kw={"lr": args.lr}, meta_extra=meta)


def run_mosi_acc(args):
    """The JAX package's ``run_mosi_acc``: MOSI (seqlength 20) with its
    labels binarized ``y >= 0`` (``mfm_mosi_acc.py:505-508``), trained by
    ``train_mfm_acc`` in ``run_trials`` with run ids ``mosi_acc_<trial>``:
    a ``sample_search_config("mosi")`` draw in ``--mode search``,
    ``best_acc_mosi_config`` in ``--mode best``, ``--config`` (else
    ``best_acc_mosi_config``) in ``--mode single``, each with MOSI's input
    dims; ``--type``, ``--missing`` and ``--zeros`` are not read. The
    logged and saved config is the one handed to the trainer, which
    trains it as a two-class classifier, as the JAX package records it.
    ``--seeds K`` trains K lanes with the accuracy kept (``train_lanes``,
    lr 1e-3) and, as the JAX command, saves no checkpoint."""
    import numpy as np

    from factorized_tpu_torch import resolve_device, trainers
    from factorized_tpu_torch.config import (MFMConfig,
                                             best_acc_mosi_config,
                                             sample_search_config)

    if args.evolve or args.bucket:
        flag = "--evolve" if args.evolve else "--bucket"
        raise SystemExit(
            f"{flag} is not wired to the mosi_acc surface; use the "
            "dataset subcommands (e.g. `mosi --mode search "
            f"{flag} ...`) or scripts/release_best.py --evolve for the "
            "classification search")
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

    def train(cfg, **kw):
        if args.seeds > 1:
            return train_lanes(
                args, data, cfg.replace(task="classification",
                                        output_dim=2), "mosi_acc",
                valid_metric="accuracy", device=device, **kw)
        return trainers.train_mfm_acc(*data, cfg, device=device, **kw)

    def save(*a):
        if args.seeds <= 1:  # the JAX command saves no lanes' run
            save_run(*a)

    return run_trials(args, "mosi_acc", config_of, train, legacy_line=False,
                      save=save)


def run_predictor(args):
    """The JAX package's ``run_predictor``: the discriminative baselines
    (``--kind eflstm|mfn|self_attention``) on ``--dataset`` (a ``*_sdk``
    set split by ``--split``, which the JAX command does not read) through
    ``trainers.train_predictor`` in ``run_trials``, run ids
    ``<kind>_<trial>``: a ``sample_search_config`` draw in ``--mode
    search``, ``best_mfn_mosi_config(--best)`` for ``--mode best --kind
    mfn``, else ``best_acc_mosi_config``, each with the dataset's input
    dims, output dim and task, then ``--epochs`` and ``--batchsize``; the
    lr ``--lr or cfg.lr or 0.01``. ``--save-ckpt`` is refused for a kind
    other than ``mfn`` before any data loads; for ``mfn`` it writes
    ``<out>/ckpt_mfn_<trial>`` with ``model_type`` "mfn", which
    ``test_mosi`` and ``serve`` read."""
    from factorized_tpu_torch import resolve_device, trainers
    from factorized_tpu_torch.config import (best_acc_mosi_config,
                                             best_mfn_mosi_config,
                                             sample_search_config)

    refuse_lane_flags(args)
    check_data_args(args.dataset, args)
    if args.save_ckpt and args.kind != "mfn":
        raise SystemExit(
            "--save-ckpt is only supported for --kind mfn (the "
            "eflstm/self_attention param shapes are not derivable "
            "from a config alone); drop the flag")
    device = resolve_device(args.device)
    data = load_dataset(args.dataset, 20, args)
    info = dataset_info(args.dataset, data, args)

    def config_of(rng):
        if args.mode == "search":
            cfg = sample_search_config(args.dataset, rng)
        elif args.mode == "best" and args.kind == "mfn":
            cfg = best_mfn_mosi_config(args.best)
        else:
            cfg = best_acc_mosi_config()
        return overridden(args, cfg.replace(
            input_dims=info["input_dims"], output_dim=info["output_dim"],
            task=info["task"]))

    def train(cfg, **kw):
        return trainers.train_predictor(
            *data, args.kind, cfg, h=args.hidden, drop=args.drop,
            lr=args.lr or cfg.lr or 0.01, optimizer=args.optimizer,
            binary_threshold=info["threshold"] or 0.0,
            threshold_mode=info["mode"], device=device, **kw)

    def save(out, tag, cfg, res, logger):
        save_run(out, tag, cfg.replace(model_type="mfn"), res, logger,
                 resume=("_resume_lr",))

    return run_trials(args, args.kind, config_of, train, legacy_line=False,
                      record={"predictor_kind": args.kind}, save=save)


def run_test_attention(args):
    """The JAX package's ``run_test_attention``: ``self_attention`` on MOSI
    through ``trainers.train_predictor`` at a default ``MFMConfig`` of
    MOSI's input dims, batch ``--batchsize`` (128) and ``--epochs`` (100),
    width ``--hidden``, dropout 0.5 and lr ``--lr`` (0.01), under the run
    id ``self_attention``; ``--seeds`` above 1, ``--bucket`` and
    ``--evolve`` are refused before any load (one model)."""
    from factorized_tpu_torch import resolve_device, trainers
    from factorized_tpu_torch.config import MFMConfig

    refuse_lane_flags(args)
    device = resolve_device(args.device)
    data = load_dataset("mosi", 20, args)
    cfg = MFMConfig(input_dims=dataset_info("mosi", data, args)["input_dims"],
                    batchsize=args.batchsize or 128,
                    num_epochs=args.epochs or 100)
    logger = run_logger(args, "self_attention")
    try:
        trainers.train_predictor(*data, "self_attention", cfg,
                                 h=args.hidden, drop=0.5,
                                 lr=args.lr or 0.01, logger=logger,
                                 seed=args.seed, device=device)
    finally:
        logger.close()
    return 0


def run_multitrait(args):
    """The JAX package's ``run_multitrait`` for the POM- and IEMOCAP-style
    sets (``--style pom|iemocap``, ``data/multitrait.py``): in
    ``run_trials`` with run ids ``<style>_<trial>``, a
    ``sample_search_config("mmmo")`` draw in ``--mode search``,
    ``best_acc_mosi_config`` in ``--mode best``, ``--config`` (else the
    defaults at seqlength 20) in ``--mode single``, each of ``--type``
    with the set's input dims, then ``--epochs`` and ``--batchsize``;
    trained by ``trainers.train_mfm_multitrait`` at ``--lr`` (1e-3 by
    default). ``--mode search --evolve RUNGS`` runs
    ``run_multitrait_evolve`` and ``--mode search --bucket``
    ``run_bucket_search`` over draws of the ``mmmo`` space with a vector
    head (``--seeds`` lanes a config). Refused before any load, with the
    JAX package's words: ``--feature-selection 0`` and
    ``--normalize-covarep``, ``--bucket``/``--evolve`` outside ``--mode
    search`` and ``--seeds`` above 1 without them; a malformed
    ``--split`` and a ``*_sdk`` style without a ``--data-root`` directory.
    The styles ``mosei_sdk`` and ``pom_sdk`` read the SDK's .csd files
    (``mmsdk.get_data`` with ``label_mode="vector"`` and ``--split``), the
    input dims the files', and record their trait names in each config
    record (``traits``; in the ``--evolve`` log's ``search_meta``).
    ``--save-ckpt`` writes ``<out>/ckpt_<style>_<trial>`` with
    the output dim the run trained (the number of traits), so ``serve``
    replies one column a trait."""
    import numpy as np

    from factorized_tpu_torch import resolve_device, trainers
    from factorized_tpu_torch.config import (best_acc_mosi_config,
                                             sample_search_config)
    from factorized_tpu_torch.data import multitrait

    if not args.feature_selection or args.normalize_covarep:
        raise SystemExit(
            "--feature-selection 0/--normalize-covarep only apply to "
            "the mosi dataset (reference mfm_mosi.py:37,60-73); the "
            "multitrait surface has no raw-feature path")
    refuse_off_search(args)
    if args.seeds > 1 and not (args.mode == "search"
                               and (args.bucket or args.evolve)):
        raise SystemExit(
            f"--seeds {args.seeds} on the multitrait surface only "
            "applies to --mode search with --bucket or --evolve "
            "(those lanes run seeds_per_config); other modes train "
            "one seed - drop --seeds or add --bucket/--evolve")
    check_data_args(args.style, args)
    base = base_config(args)
    device = resolve_device(args.device)
    record = {"style": args.style}
    if args.style.endswith("_sdk"):
        from factorized_tpu_torch.data import mmsdk

        sdk = args.style == "mosei_sdk"
        data = mmsdk.get_data(base.seqlength, data_root=args.data_root,
                              files=mmsdk.MOSEI_FILES if sdk
                              else mmsdk.POM_FILES,
                              label_mode="vector",
                              split=parse_split(args.split))
        input_dims = list(data.input_dims)
        # the per-trait metric lists are positional: name the columns
        record["traits"] = mmsdk.MOSEI_TRAITS if sdk else multitrait.POM_TRAITS
    else:
        data = multitrait.get_data(base.seqlength, data_root=args.data_root,
                                   style=args.style)
        input_dims = list(multitrait.INPUT_DIMS)
    n_traits = int(np.asarray(data[1]).shape[1])
    rng = random.Random(args.seed)
    if args.mode == "search" and args.evolve:
        return run_multitrait_evolve(args, data, input_dims, rng, device,
                                     record)
    if args.mode == "search" and args.bucket:
        info = dict(task="regression", threshold=None, mode="ge",
                    input_dims=input_dims, output_dim=n_traits)

        def sample_mt():
            return sample_search_config("mmmo", rng,
                                        model_type=args.type).replace(
                input_dims=input_dims, task="regression",
                output_dim=n_traits)

        return run_bucket_search(
            args, data, info, rng, device, sample_fn=sample_mt,
            prefix=args.style,
            record={k: v for k, v in record.items() if k == "traits"})

    def config_of(rng):
        if args.mode == "search":
            cfg = sample_search_config("mmmo", rng, model_type=args.type)
        elif args.mode == "best":
            cfg = best_acc_mosi_config(model_type=args.type)
        else:
            cfg = base.replace(model_type=args.type)
        return overridden(args, cfg.replace(input_dims=input_dims,
                                            task="regression"))

    def train(cfg, **kw):
        return trainers.train_mfm_multitrait(*data, cfg, lr=args.lr,
                                             device=device, **kw)

    def save(out, tag, cfg, res, logger):
        save_run(out, tag, cfg.replace(output_dim=n_traits), res, logger,
                 resume=())

    return run_trials(args, args.style, config_of, train, legacy_line=False,
                      record=record, save=save)


def run_test_mosi(args):
    """Score a checkpoint on the MOSI test set, loaded as ``mosi`` loads it
    (``load_dataset``: the files under ``--data-root`` with
    ``--feature-selection`` and ``--normalize-covarep``, else the
    synthetic set) at t = 20, as the JAX package's ``run_test_mosi``; a
    checkpoint trained at another seqlength is scored at its own (the JAX
    command would feed it 20 steps): regression, or classification of
    the binarized sentiment ``y >= 0``; then the latency probe and the
    on-device latency, one JSON line each."""
    import numpy as np

    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.utils.metrics import (score_classification,
                                                    score_regression)

    predictor = Predictor.from_checkpoint(args.checkpoint, device=args.device)
    _, _, _, _, X_test, y_test = load_dataset("mosi", predictor.cfg.seqlength,
                                              args)
    if X_test.shape[2] != sum(predictor.cfg.input_dims):
        # a checkpoint of another set (the .csd sets' widths): serve it
        raise SystemExit(
            f"the checkpoint takes {sum(predictor.cfg.input_dims)} floats a "
            f"step (input dims {predictor.cfg.input_dims}) and the MOSI test "
            f"set {X_test.shape[2]}: test_mosi scores MOSI checkpoints")
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


def run_check(args):
    """The JAX package's ``check``: the best metrics of every run log
    under ``--dir`` (``check.check_dir``, ``--condition`` one missing
    modality's section), or with ``--multitrait`` per trait
    (``check.best_multitrait``, ``--style pom|ie2``)."""
    from factorized_tpu_torch.check import best_multitrait, check_dir

    if args.multitrait:
        best_multitrait(args.dir, style=args.style)
    else:
        check_dir(args.dir, condition=args.condition)
    return 0


def add_data_args(sp):
    """``--data-root``, ``--feature-selection`` and
    ``--normalize-covarep``: how ``load_dataset`` reads the data; and
    ``--profile``, ``--seed-parallel`` and ``--multihost``."""
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
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the whole command with torch.profiler into "
                         "DIR (a Chrome trace; TensorBoard or "
                         "chrome://tracing opens it)")
    add_parallel_args(sp)


def add_parallel_args(sp):
    """``--seed-parallel`` and ``--multihost``, on every command whose JAX
    parser has them."""
    sp.add_argument("--seed-parallel", action="store_true",
                    help="with --seeds > 1, --bucket or --evolve: share "
                         "the lanes out over the world's ranks (one a "
                         "device; 2-D seed x batch where the ranks "
                         "outnumber and divide the lanes)")
    sp.add_argument("--multihost", action="store_true",
                    help="join the world of ranks (torch.distributed) "
                         "before anything runs: the coordinator, world "
                         "size and rank from torchrun's MASTER_ADDR/"
                         "MASTER_PORT/WORLD_SIZE/RANK or the JAX "
                         "package's JAX_COORDINATOR_ADDRESS/"
                         "JAX_NUM_PROCESSES/JAX_PROCESS_ID; each rank on "
                         "cuda:LOCAL_RANK (gloo with --device cpu)")


def add_training_args(sp):
    """The arguments of the dataset subcommands, ``mosi_acc``,
    ``predictor``, ``test_attention`` and ``multitrait``."""
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
                    help="lr of mosi, mmmo and multitrait (default 1e-3, "
                         "torch's Adam); moud and you take the config's; "
                         "predictor this, else the config's, else 0.01; "
                         "test_attention this, else 0.01")
    sp.add_argument("--seed", type=int, default=123)
    add_data_args(sp)
    sp.add_argument("--out", default="runs",
                    help="directory of the JSONL logs and the checkpoints")
    sp.add_argument("--save-ckpt", action="store_true",
                    help="save each trial's best parameters with the last "
                         "optimizer state under <out>/ckpt_<run id>")
    sp.add_argument("--resume", default=None,
                    help="checkpoint directory to resume each trial "
                         "from (this package's or the JAX package's)")
    sp.add_argument("--ckpt-every", type=int, default=0,
                    help="every N epochs overwrite <out>/ckpt_auto_<run "
                         "id> with the current parameters, optimizer "
                         "state and step")
    sp.add_argument("--split", default=None, metavar="N_TRAIN,N_VALID",
                    help="the *_sdk sets' video split (default: 52,10 on "
                         "MOSI's 93 videos, the same shares on any other "
                         "count); the rest is test")
    sp.add_argument("--seeds", type=int, default=1,
                    help="train K seeds of each trial's config as lanes "
                         "of one program (the dataset subcommands and "
                         "mosi_acc); with --bucket/--evolve the lanes of "
                         "each config (multitrait too); predictor and "
                         "test_attention refuse it")
    sp.add_argument("--bucket", action="store_true",
                    help="with --mode search: group the --trials draws by "
                         "shape and train each group as one program of "
                         "configs x --seeds lanes, each lane its own "
                         "dropouts, loss weights and lr (the dataset "
                         "subcommands and multitrait)")
    sp.add_argument("--evolve", type=int, default=0, metavar="RUNGS",
                    help="with --mode search: successive halving over one "
                         "drawn shape, --trials configs x --seeds lanes, "
                         "RUNGS rungs of --epochs, the worst --cull-frac "
                         "of the configs re-drawn in place each rung (the "
                         "dataset subcommands and multitrait)")
    sp.add_argument("--cull-frac", type=float, default=0.5,
                    help="share of the configs re-drawn each --evolve "
                         "rung (default 0.5)")
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")


def build_parser():
    p = argparse.ArgumentParser(prog="factorized_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    for name in DATASETS:
        sp = sub.add_parser(name, help=(
            f"train on {name} from its CMU-MultimodalSDK .csd files under "
            f"--data-root (needs h5py)" if name.endswith("_sdk") else
            f"train on {name} (its files under --data-root, else a "
            f"synthetic set)"))
        add_training_args(sp)
        sp.set_defaults(func=run_dataset, dataset=name)
    sp = sub.add_parser("mosi_acc", help="MOSI's binary-accuracy variant "
                                         "(labels y >= 0)")
    add_training_args(sp)
    sp.set_defaults(func=run_mosi_acc, dataset="mosi")

    sp = sub.add_parser("predictor",
                        help="the EFLSTM, MFN and SelfAttention baselines")
    add_training_args(sp)
    sp.add_argument("--kind", default="mfn",
                    choices=["eflstm", "mfn", "self_attention"])
    sp.add_argument("--dataset", default="mosi", choices=list(DATASETS),
                    help="the dataset (the *_sdk ones from their .csd files "
                         "under --data-root)")
    sp.add_argument("--hidden", type=int, default=128,
                    help="LSTM width of eflstm and self_attention")
    sp.add_argument("--drop", type=float, default=0.5,
                    help="dropout of eflstm's and self_attention's head")
    sp.add_argument("--optimizer", default="adam", choices=["adam", "sgd"],
                    help="the reference's acc variant trains with "
                         "SGD+momentum (test_mosi_acc.py:285)")
    sp.add_argument("--best", default="mae", choices=["mae", "acc"],
                    help="which pinned MFN config --mode best uses")
    sp.set_defaults(func=run_predictor)

    sp = sub.add_parser("test_attention",
                        help="the SelfAttention ablation on MOSI")
    add_training_args(sp)
    sp.add_argument("--hidden", type=int, default=128)
    sp.set_defaults(func=run_test_attention)

    sp = sub.add_parser("multitrait",
                        help="POM/IEMOCAP-style multi-trait regression")
    add_training_args(sp)
    sp.add_argument("--style", default="pom", choices=MULTITRAIT_STYLES,
                    help="pom or iemocap (synthetic, or CSVs under "
                         "--data-root), mosei_sdk or pom_sdk (.csd files "
                         "under --data-root)")
    sp.set_defaults(func=run_multitrait)

    sp = sub.add_parser("check", help="the best metrics of the run logs "
                                      "under --dir")
    sp.add_argument("--dir", default="runs")
    sp.add_argument("--condition", default=None, choices=["l", "a", "v"])
    sp.add_argument("--multitrait", action="store_true",
                    help="per-trait aggregation (reference pom/ie2 modes)")
    sp.add_argument("--style", default=None, choices=["pom", "ie2"],
                    help="multitrait report style: pom = directory-wide "
                         "with x100 acc row; ie2 = per-file reset")
    sp.set_defaults(func=run_check)

    sp = sub.add_parser("test_mosi",
                        help="score a checkpoint on the MOSI test set")
    sp.add_argument("--checkpoint", required=True,
                    help="directory written by utils.checkpoint."
                         "save_checkpoint or by the JAX package's (Orbax "
                         "or msgpack)")
    sp.add_argument("--autotune", action="store_true",
                    help="pick the serving batch size by throughput")
    add_data_args(sp)
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")
    sp.set_defaults(func=run_test_mosi)

    sp = sub.add_parser("serve", help="JSON-over-HTTP inference endpoint")
    group = sp.add_mutually_exclusive_group(required=True)
    group.add_argument("--checkpoint",
                       help="directory written by utils.checkpoint."
                            "save_checkpoint or by the JAX package's "
                            "(Orbax or msgpack)")
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

    sp = sub.add_parser(
        "warmup", help="build the kernels' library (or find it built) and "
                       "run the main programs once: the MOSI trainer, 8 "
                       "lanes of seeds, the released checkpoints' serving")
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")
    sp.set_defaults(func=run_warmup)
    return p


def run_warmup(args):
    from factorized_tpu_torch.warmup import run_warmup as warm

    return warm(args)


def main(argv=None):
    args = build_parser().parse_args(argv)
    joined = False
    if getattr(args, "multihost", False):
        # before any device is touched: the rank's card becomes current
        from factorized_tpu_torch.parallel import sharding

        joined = sharding.init_distributed(device=args.device)
    try:
        if getattr(args, "profile", None):
            from factorized_tpu_torch.utils.profiling import trace

            with trace(args.profile):
                return args.func(args)
        return args.func(args)
    finally:
        if joined:
            sharding.dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
