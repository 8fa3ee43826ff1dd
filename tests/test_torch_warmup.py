"""``python -m factorized_tpu_torch warmup`` on the CPU: its legs run in
order, each timed, with their work cut (the trainers replaced by
recorders of what they were given, the MOSI set by a small one; the
released checkpoints are served for real), and a failing leg makes the
command exit 1 after the others ran."""

import numpy as np
import pytest

from factorized_tpu_torch import cli, trainers
from factorized_tpu_torch.data import mosi
from factorized_tpu_torch.parallel import multiseed

LEGS = ["trainer_chunked_loop_mosi", "multiseed_k8", "serve_mfn_mae",
        "serve_mfn_acc"]


@pytest.fixture
def cut(monkeypatch):
    calls = []
    rng = np.random.default_rng(0)
    data = tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((4, 20, 325), (4,)) * 3)
    monkeypatch.setattr(mosi, "get_data", lambda t: data)

    def recorder(name):
        def train(*args, **kw):
            calls.append((name, args[6], kw))
        return train

    monkeypatch.setattr(trainers, "train_mfm", recorder("train_mfm"))
    monkeypatch.setattr(multiseed, "train_mfm_multiseed",
                        recorder("train_mfm_multiseed"))
    return calls


def _legs(out):
    return [line.split()[1] for line in out.splitlines()
            if line.startswith("warmup ") and not line.startswith(
                "warmup total")]


def test_warmup_runs_its_legs(cut, capsys):
    assert cli.main(["warmup", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _legs(out) == LEGS
    assert out.count(" ok") == len(LEGS) and "FAILED" not in out
    (name, cfg, kw), (lanes_name, lanes_cfg, lanes_kw) = cut
    assert name == "train_mfm" and lanes_name == "train_mfm_multiseed"
    assert cfg.num_epochs == lanes_cfg.num_epochs == 2
    assert lanes_kw["n_seeds"] == 8
    assert kw["device"].type == lanes_kw["device"].type == "cpu"


def test_a_failing_leg_exits_1(cut, monkeypatch, capsys):
    def fail(*a, **kw):
        raise RuntimeError("leg failed")

    monkeypatch.setattr(trainers, "train_mfm", fail)
    assert cli.main(["warmup", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert _legs(out) == LEGS
    assert "trainer_chunked_loop_mosi" in out.splitlines()[0]
    assert "FAILED RuntimeError: leg failed" in out.splitlines()[0]
    assert "FAILED: ['trainer_chunked_loop_mosi']" in out
