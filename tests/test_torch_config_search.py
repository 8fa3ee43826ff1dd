"""The port's configuration surface against the JAX package's:
``MFMConfig.from_json`` on the four ``configs/*.json`` files and on a
legacy-schema file, ``sample_search_config`` over 50 seeds of each
dataset's search space with and without overrides (equal dicts: the draws
are the same for one ``random.Random(seed)``), and the ``mosi`` command's
``--mode search --trials`` logging the same ``config`` records as the JAX
command with the same ``--seed``; ``--config``, ``--data-root``,
``--resume`` and ``--ckpt-every`` reach the trainer. Exact equality
throughout: nothing here is computed in floating point."""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from factorized_tpu import cli as jax_cli
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import sample_search_config as jax_sample
from factorized_tpu_torch import cli, trainers
from factorized_tpu_torch.config import MFMConfig, sample_search_config
from factorized_tpu_torch.data import mosi

CONFIGS = sorted(str(p) for p in (Path(__file__).resolve().parent.parent
                                  / "configs").glob("*.json"))
OVERRIDES = {
    "none": {},
    "type": dict(model_type="kl_ef", missing=0, zeros=0),
    "missing": dict(model_type="mfm", missing=1, zeros=0, num_epochs=3,
                    batchsize=16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_from_json_is_the_jax_packages(path):
    assert len(CONFIGS) == 4
    port = MFMConfig.from_json(path)
    assert port.to_dict() == JaxConfig.from_json(path).to_dict()
    over = dict(num_epochs=2, h_dims=[10, 6, 4])
    assert (MFMConfig.from_json(path, **over).to_dict()
            == JaxConfig.from_json(path, **over).to_dict())


def test_from_json_reads_the_legacy_schema(tmp_path):
    """``inputdims`` and ``seqlength`` of the reference's schema, and keys
    that are not fields ignored."""
    path = tmp_path / "legacy.json"
    path.write_text(json.dumps({"inputdims": [300, 74, 36], "seqlength": 15,
                                "memsize": 128, "not_a_field": 1}))
    port = MFMConfig.from_json(str(path))
    assert port.to_dict() == JaxConfig.from_json(str(path)).to_dict()
    assert (port.input_dims, port.seqlength, port.memsize) == (
        [300, 74, 36], 15, 128)


@pytest.mark.parametrize("overrides", list(OVERRIDES))
@pytest.mark.parametrize("dataset", ["mosi", "moud", "you", "mmmo"])
def test_sample_search_config_draws_the_jax_packages(dataset, overrides):
    kw = OVERRIDES[overrides]
    for seed in range(50):
        port, ref = random.Random(seed), random.Random(seed)
        for _ in range(2):  # the second draw from the same generator too
            assert (sample_search_config(dataset, port, **kw).to_dict()
                    == jax_sample(dataset, ref, **kw).to_dict()), seed


def test_sample_search_config_refuses_an_unknown_dataset():
    with pytest.raises(ValueError, match="unknown dataset"):
        sample_search_config("imdb", random.Random(0))


def _data(seed, n=(24, 8, 8)):
    rng = np.random.default_rng(seed)
    out = []
    for k in n:
        out += [rng.normal(size=(k, 20, 325)).astype(np.float32),
                rng.normal(size=(k,)).astype(np.float32)]
    return tuple(out)


def _configs(path):
    with open(path) as f:
        recs = [r for r in map(json.loads, f) if r["kind"] == "config"]
    return [{k: v for k, v in r.items() if k not in ("kind", "ts")}
            for r in recs]


def test_search_logs_the_jax_commands_config_records(tmp_path, monkeypatch):
    """``mosi --mode search --trials 2 --epochs 1 --seed 7`` (batch 8):
    the port trains each drawn config on the CPU; the JAX command, its
    trainer stubbed, logs its draws; each trial's ``config`` record is the
    same."""
    data = _data(1)
    monkeypatch.setattr(cli, "load_mosi", lambda t, **kw: data)
    monkeypatch.setattr(jax_cli, "load_dataset", lambda *a, **kw: data)
    monkeypatch.setattr(jax_cli, "dispatch_trainer", lambda *a, **kw: {})
    argv = ["mosi", "--mode", "search", "--trials", "2", "--epochs", "1",
            "--batchsize", "8", "--seed", "7"]
    assert cli.main(argv + ["--device", "cpu", "--out",
                            str(tmp_path / "port")]) == 0
    assert jax_cli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    for trial in range(2):
        got = _configs(tmp_path / "port" / f"mosi_{trial}.jsonl")
        want = _configs(tmp_path / "jax" / f"mosi_{trial}.jsonl")
        assert got == want and len(got) == 1
    rng = random.Random(7)
    drawn = [sample_search_config("mosi", rng).replace(
        num_epochs=1, batchsize=8).to_dict() for _ in range(2)]
    assert [_configs(tmp_path / "port" / f"mosi_{t}.jsonl")[0]["h_dims"]
            for t in range(2)] == [d["h_dims"] for d in drawn]


@pytest.fixture
def caught(monkeypatch):
    """The port's ``train_mfm`` replaced by one that records what the
    command hands it."""
    calls = []

    def train(*args, **kw):
        calls.append((args, kw))
        return {"params": {}, "history": [], "opt_state": {}, "step": 0}

    monkeypatch.setattr(trainers, "train_mfm", train)
    return calls


def test_config_and_data_root_reach_the_trainer(tmp_path, caught):
    """``--config`` (``--mode single``) sets the trainer's config, with
    the data's input dims; ``--data-root`` gives it the real files'
    arrays (a fabricated root, raw features); ``--resume`` and
    ``--ckpt-every`` reach it as ``resume_from`` and a snapshot of that
    cadence; the seed is ``--seed`` + trial."""
    root = mosi.fabricate_root(str(tmp_path / "root"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"h_dims": [12, 6, 4], "memsize": 20,
                                "seqlength": 12, "batchsize": 16}))
    assert cli.main(["mosi", "--config", str(path), "--data-root", root,
                     "--feature-selection", "0", "--normalize-covarep",
                     "--resume", str(tmp_path / "ck"), "--ckpt-every", "3",
                     "--seed", "5", "--device", "cpu", "--out",
                     str(tmp_path / "runs")]) == 0
    (args, kw), = caught
    cfg = args[-1]
    want = MFMConfig.from_json(str(path)).replace(input_dims=[300, 34, 43])
    assert cfg.to_dict() == want.to_dict()
    for got, ref in zip(args[:-1], mosi.get_data(12, False, root, True)):
        np.testing.assert_array_equal(got, ref)
    assert args[0].shape == (52, 12, 377)
    assert kw["resume_from"] == str(tmp_path / "ck")
    assert kw["snapshot"].every == 3 and kw["seed"] == 5
