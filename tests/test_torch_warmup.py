"""``python -m factorized_tpu_torch warmup`` on the CPU: its legs run in
order, each timed, with their work cut (the bench legs' configs and
epochs by tiny ones, trained for real; the trainers replaced by
recorders of what they were given, the MOSI set by a small one; the
released checkpoints are served for real), and a failing leg makes the
command exit 1 after the others ran."""

import numpy as np
import pytest

from factorized_tpu_torch import benchprog, cli, trainers
from factorized_tpu_torch.data import mosi
from factorized_tpu_torch.parallel import multiseed

LEGS = ["bench_epoch_dispatched", "bench_chunk_e20", "bench_scale_chunk",
        "trainer_chunked_loop_mosi", "multiseed_k8", "serve_mfn_mae",
        "serve_mfn_acc"]
TINY = dict(input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6, zy_size=5,
            zl_size=6, za_size=4, zv_size=5, fy_size=4, fl_size=5,
            fa_size=4, fv_size=3, att1_shape=8, att2_shape=8,
            gamma1_shape=8, gamma2_shape=8, seqlength=4)


@pytest.fixture
def cut(monkeypatch):
    calls = []
    build_cfg, scale_cfg = benchprog.build_cfg, benchprog.scale_cfg
    monkeypatch.setattr(benchprog, "build_cfg",
                        lambda: build_cfg().replace(**TINY))
    monkeypatch.setattr(benchprog, "scale_cfg", lambda: scale_cfg().replace(
        **dict(TINY, batchsize=6)))
    for name in ("NB", "E", "SCALE_NB", "SCALE_E"):
        monkeypatch.setattr(benchprog, name, 2)
    chunks = []
    make_chunk = benchprog.make_chunk

    def recorded(program, e):
        chunks.append((program.cfg.batchsize, e))
        return make_chunk(program, e)

    monkeypatch.setattr(benchprog, "make_chunk", recorded)
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
    calls.append(chunks)
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
    chunks, (name, cfg, kw), (lanes_name, lanes_cfg, lanes_kw) = cut
    # bench_chunk_e20 at the MOSI batch, bench_scale_chunk at the scale's
    assert chunks == [(32, 2), (6, 2)]
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
    line = out.splitlines()[LEGS.index("trainer_chunked_loop_mosi")]
    assert "trainer_chunked_loop_mosi" in line
    assert "FAILED RuntimeError: leg failed" in line
    assert "FAILED: ['trainer_chunked_loop_mosi']" in out
