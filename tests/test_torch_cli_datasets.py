"""The port's dataset subcommands ``moud``, ``you`` and ``mmmo`` and
``mosi_acc`` against the JAX command line, trial for trial, with both
packages' trainers replaced by recorders and both loaders by the same
arrays:

- under ``--mode best``, ``--mode single --config configs/<set>.json``
  and ``--mode search --trials 3``: the same trainers called with the
  same configs, data (``mosi_acc``'s labels binarized ``y >= 0``), seeds,
  lr (the config's for ``moud`` and ``you``, ``--lr`` for ``mmmo`` and
  ``mosi_acc``), thresholds, remainder flag and resume path; the same run
  ids, ``config`` records and printed lines;
- ``--type s2s|bm --missing 1`` reaching ``train_seq2seq`` /
  ``train_basic_missing`` as the JAX package's dispatch does (``s2s``
  without the threshold);
- ``mosi_sdk`` with a malformed ``--split``, ``mosei_sdk`` without a
  ``--data-root`` directory and ``mosi_acc --evolve`` (the JAX package's
  refusal) exiting before any data loads; ``--mode search --bucket`` and ``--evolve`` (with ``--seeds
  2`` too) reaching the bucket and evolving trainers.

Exact equality throughout: nothing here is computed in floating point."""

import json
from pathlib import Path

import numpy as np
import pytest

from factorized_tpu import cli as jax_cli
from factorized_tpu import trainers as jtrainers
from factorized_tpu_torch import cli, trainers

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
TRAINERS = ("train_mfm", "train_beta_vae", "train_mfm_missing",
            "train_mfm_test_zeros", "train_mfm_ablation", "train_seq2seq",
            "train_basic_missing", "train_mfm_acc")


def _data(d_total, seed=0, n=(6, 4, 4)):
    rng = np.random.default_rng(seed)
    out = []
    for k in n:
        out += [rng.normal(size=(k, 20, d_total)).astype(np.float32),
                rng.normal(size=(k,)).astype(np.float32)]
    return tuple(out)


@pytest.fixture
def recorded(monkeypatch):
    """Both packages' trainers replaced by recorders, both loaders by the
    same arrays (325 wide for MOSI, 410 for the others): returns {"port":
    calls, "jax": calls}, each call (trainer, data, config dict, keyword
    arguments but the logger, the snapshot's cadence in their place)."""
    calls = {"port": [], "jax": []}

    def recorder(side, name):
        def train(*args, **kw):
            snapshot = kw.pop("snapshot", None)
            kw.pop("logger")
            kw.pop("device", None)
            kw["snapshot_every"] = getattr(snapshot, "every", None)
            calls[side].append((name, args[:-1], args[-1].to_dict(), kw))
            return {"params": {}, "history": [], "opt_state": {}, "step": 0}
        return train

    for name in TRAINERS:
        monkeypatch.setattr(trainers, name, recorder("port", name))
        monkeypatch.setattr(jtrainers, name, recorder("jax", name))

    def data(name):
        return _data(325 if name == "mosi" else 410)

    monkeypatch.setattr(cli, "load_dataset",
                        lambda name, seqlength, args: data(name))
    monkeypatch.setattr(jax_cli, "load_dataset",
                        lambda name, *a, **kw: data(name))
    return calls


def _run_both(argv, tmp_path, capsys):
    """The port's command and the JAX command on ``argv``, each into its
    own ``--out``: (port's printed lines, JAX's printed lines)."""
    assert cli.main(argv + ["--device", "cpu", "--out",
                            str(tmp_path / "port")]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jax_cli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    return port, capsys.readouterr().out.splitlines()


def _records(out):
    """Each run id's log without its timestamps."""
    return {p.stem: [{k: v for k, v in json.loads(line).items()
                      if k != "ts"} for line in p.read_text().splitlines()]
            for p in sorted(Path(out).glob("*.jsonl"))}


def _same_calls(calls):
    assert len(calls["port"]) == len(calls["jax"]) > 0
    for (name, data, cfg, kw), (j_name, j_data, j_cfg, j_kw) in zip(
            calls["port"], calls["jax"]):
        assert (name, cfg, kw) == (j_name, j_cfg, j_kw)
        for got, want in zip(data, j_data):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


MODES = {"best": ["--mode", "best"],
         "single": ["--mode", "single", "--config", "{config}"],
         "search": ["--mode", "search", "--trials", "3"]}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("command", ["moud", "you", "mmmo", "mosi_acc"])
def test_trials_are_the_jax_commands(command, mode, recorded, tmp_path,
                                     capsys):
    config = CONFIGS / ("mosi.json" if command == "mosi_acc"
                        else f"{command}.json")
    argv = [command, *(a.format(config=config) for a in MODES[mode]),
            "--epochs", "2", "--seed", "7", "--lr", "0.003", "--resume",
            str(tmp_path / "ck"), "--ckpt-every", "2"]
    port_lines, jax_lines = _run_both(argv, tmp_path, capsys)
    _same_calls(recorded)
    trials = 3 if mode == "search" else 1
    prefix = "mosi_acc" if command == "mosi_acc" else command
    got, want = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert got == want
    assert list(got) == [f"{prefix}_{t}" for t in range(trials)]
    assert port_lines == jax_lines
    for name, _, cfg, kw in recorded["port"]:
        assert name == ("train_mfm_acc" if command == "mosi_acc"
                        else "train_mfm")
        assert cfg["num_epochs"] == 2 and kw["snapshot_every"] == 2
        if command in ("moud", "you"):
            assert kw["lr"] == cfg["lr"] and kw["include_remainder"]
        elif command == "mmmo":
            assert kw["lr"] == 0.003
            assert (kw["binary_threshold"], kw["threshold_mode"]) == (3.5,
                                                                      "gt")
    if command == "mosi_acc":
        labels = recorded["port"][0][1][1]
        assert labels.dtype == np.int64 and set(labels) <= {0, 1}


@pytest.mark.parametrize("command", ["mosi", "moud", "mmmo"])
@pytest.mark.parametrize("model_type,trainer", [
    ("s2s", "train_seq2seq"), ("bm", "train_basic_missing")])
def test_missing_baselines_reach_their_trainers(command, model_type,
                                                trainer, recorded, tmp_path,
                                                capsys):
    argv = [command, "--mode", "best", "--type", model_type, "--missing",
            "1", "--epochs", "1"]
    _run_both(argv, tmp_path, capsys)
    _same_calls(recorded)
    (name, _, cfg, kw), = recorded["port"]
    assert name == trainer == cli.trainer_name(cli.trial_config(
        cli.build_parser().parse_args(argv)))
    assert (cfg["model_type"], cfg["missing"]) == (model_type, 1)
    assert ("binary_threshold" in kw) == (model_type == "bm"
                                          and command != "moud")
    assert "include_remainder" not in kw


# argv, then the refusal's words before any load, or None where the
# command now runs: the search's trainer then gets the draws
@pytest.mark.parametrize("argv,refusal", [
    (["mosi_sdk", "--mode", "best", "--split", "52"],
     "--split must be N_TRAIN,N_VALID video counts"),
    (["mosei_sdk"], "mosei_sdk needs --data-root pointing at a directory"),
    (["moud", "--seeds", "2", "--mode", "search", "--bucket"], None),
    (["mosi_acc", "--seeds", "2", "--mode", "search", "--evolve", "2"],
     "is not wired to the mosi_acc surface"),
    (["you", "--mode", "search", "--bucket"], None),
    (["mmmo", "--mode", "search", "--evolve", "2"], None),
], ids=["mosi_sdk", "mosei_sdk", "moud_seeds", "mosi_acc_seeds", "bucket",
        "evolve"])
def test_what_is_not_ported_exits_before_loading(argv, refusal,
                                                 monkeypatch, tmp_path):
    from factorized_tpu_torch.parallel import multiconfig

    calls = []

    def load(name, seqlength, args):
        if refusal:
            raise AssertionError("the data loaded before the refusal")
        return _data(410)

    def trainer(name):
        def train(*a, **kw):
            calls.append((name, a[6], kw))
            if name == "train_config_bucket":
                return {"results": []}
            return {"explored_configs": 3, "best": {"metrics": {},
                                                    "rung": 1}}
        return train

    monkeypatch.setattr(cli, "load_dataset", load)
    for name in ("train_config_bucket", "train_evolving_search"):
        monkeypatch.setattr(multiconfig, name, trainer(name))
    argv = argv + ["--device", "cpu", "--out", str(tmp_path)]
    if refusal:
        with pytest.raises(SystemExit, match=refusal):
            cli.main(argv)
        assert not calls
        return
    assert cli.main(argv + ["--trials", "3", "--epochs", "1"]) == 0
    seeds = 2 if "--seeds" in argv else 1
    for name, cfgs, kw in calls:
        assert kw["seeds_per_config"] == seeds
        assert kw["device"].type == "cpu"
        if name == "train_config_bucket":
            assert all(c.num_epochs == 1 for c in cfgs)
            assert kw.get("use_config_lr") == (argv[0] in ("moud", "you"))
        else:
            assert (cfgs.num_epochs, kw["rungs"], kw["n_configs"]) == (1, 2,
                                                                       3)
            assert kw["binary_threshold"] == 3.5
    assert sum(len(c) if n == "train_config_bucket" else 3
               for n, c, _ in calls) == 3


def test_feature_flags_apply_to_mosi_alone():
    for flag in (["--feature-selection", "0"], ["--normalize-covarep"]):
        with pytest.raises(SystemExit, match="only applies to the mosi"):
            cli.main(["moud", "--device", "cpu", *flag])
