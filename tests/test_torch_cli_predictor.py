"""The port's ``predictor``, ``test_attention`` and ``multitrait``
commands against the JAX command line, and the checkpoints they save.

- With both packages' trainers replaced by recorders and both loaders by
  the same arrays: the same trainers called with the same configs, data,
  kinds, seeds, lrs (``--lr or cfg.lr or 0.01`` for ``predictor``:
  ``best_mfn_mosi_config``'s 0.01 and 0.005, ``best_acc_mosi_config``'s
  0.01, a search draw's; ``--lr or 0.01`` for ``test_attention``;
  ``--lr`` for ``multitrait``), widths, optimizers, thresholds and resume
  paths, under the same run ids, ``config`` records and printed lines.
- ``--save-ckpt`` refused for ``eflstm`` before any data loads; the
  .csd datasets and styles without a ``--data-root`` directory or with a
  malformed ``--split``, ``--evolve``, ``--bucket``, ``--seeds 2`` and the
  MOSI-only feature flags exiting before any load.
- A ``predictor --kind mfn --save-ckpt`` run and a ``multitrait
  --save-ckpt`` run through the real trainers (one epoch on small
  arrays): the checkpoints' configs, ``test_mosi`` on the ``mfn`` one,
  and ``Predictor`` replies one column a trait on the multi-trait one.
- ``Predictor`` and ``test_mosi`` on an ``mfn`` checkpoint of JAX-drawn
  weights against the JAX ``Predictor`` (rtol 1e-5 / atol 1e-6) and the
  JAX package's score of those replies.

Exact equality elsewhere: nothing else here is computed in floating
point."""

import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from factorized_tpu import cli as jax_cli
from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.data import multitrait as jmultitrait
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.serve import Predictor as JaxPredictor
from factorized_tpu.utils import metrics as jmetrics
from factorized_tpu_torch import cli, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy
from factorized_tpu_torch.data import multitrait
from factorized_tpu_torch.serve import Predictor
from factorized_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)

SERVE = dict(rtol=1e-5, atol=1e-6)
TRAINERS = ("train_predictor", "train_mfm_multitrait")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data(d_total, seed=0, n=(6, 4, 4), traits=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in n:
        out += [rng.normal(size=(k, 20, d_total)).astype(np.float32),
                rng.normal(size=(k, traits) if traits else (k,)).astype(
                    np.float32)]
    return tuple(out)


@pytest.fixture
def recorded(monkeypatch):
    """Both packages' trainers replaced by recorders, both loaders by the
    same arrays (325 wide for MOSI, 410 for the others, 17 traits for
    ``pom`` and 4 for ``iemocap``): returns {"port": calls, "jax":
    calls}, each call (trainer, positional arguments, config dict,
    keyword arguments but the logger and device, the snapshot's cadence
    in their place)."""
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

    def traits(seqlength, data_root=None, style="pom"):
        return _data(410, seed=1, traits=17 if style == "pom" else 4)

    monkeypatch.setattr(cli, "load_dataset",
                        lambda name, seqlength, args: data(name))
    monkeypatch.setattr(jax_cli, "load_dataset",
                        lambda name, *a, **kw: data(name))
    monkeypatch.setattr(multitrait, "get_data", traits)
    monkeypatch.setattr(jmultitrait, "get_data", traits)
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
    for (name, args, cfg, kw), (j_name, j_args, j_cfg, j_kw) in zip(
            calls["port"], calls["jax"]):
        assert (name, cfg, kw) == (j_name, j_cfg, j_kw)
        assert len(args) == len(j_args)
        for got, want in zip(args, j_args):
            if isinstance(want, str):  # the predictor's kind
                assert got == want
                continue
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


PREDICTOR_RUNS = {
    "mfn_best_mae": ["--kind", "mfn", "--mode", "best"],
    "mfn_best_acc_sgd": ["--kind", "mfn", "--mode", "best", "--best", "acc",
                         "--optimizer", "sgd"],
    "eflstm_single_lr": ["--kind", "eflstm", "--lr", "0.003", "--hidden",
                         "16", "--drop", "0.2"],
    "self_attention_best": ["--kind", "self_attention", "--mode", "best"],
    "mfn_search": ["--kind", "mfn", "--mode", "search", "--trials", "3"],
    "eflstm_mmmo": ["--kind", "eflstm", "--dataset", "mmmo"],
    "mfn_moud": ["--kind", "mfn", "--dataset", "moud", "--mode", "search",
                 "--trials", "2"],
}


@pytest.mark.parametrize("run", list(PREDICTOR_RUNS))
def test_predictor_trials_are_the_jax_command(run, recorded, tmp_path,
                                              capsys):
    argv = ["predictor", *PREDICTOR_RUNS[run], "--epochs", "2", "--seed",
            "7", "--resume", str(tmp_path / "ck"), "--ckpt-every", "2"]
    port_lines, jax_lines = _run_both(argv, tmp_path, capsys)
    _same_calls(recorded)
    got, want = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert got == want
    kind = PREDICTOR_RUNS[run][1]
    trials = int(argv[argv.index("--trials") + 1]) if "--trials" in argv \
        else 1
    assert list(got) == [f"{kind}_{t}" for t in range(trials)]
    assert port_lines == jax_lines
    for name, args, cfg, kw in recorded["port"]:
        assert name == "train_predictor" and args[-1] == kind
        assert cfg["num_epochs"] == 2 and kw["snapshot_every"] == 2
        assert kw["lr"] == (0.003 if "--lr" in argv else cfg["lr"] or 0.01)
    first = recorded["port"][0][2]
    if run == "mfn_best_mae":
        assert (first["h_dims"], first["lr"]) == ([88, 48, 16], 0.01)
    if run == "mfn_best_acc_sgd":
        assert (first["memsize"], first["lr"]) == (400, 0.005)
        assert recorded["port"][0][3]["optimizer"] == "sgd"
    if run == "self_attention_best":
        assert first["h_dims"] == [88, 64, 48]  # best_acc_mosi_config's


@pytest.mark.parametrize("argv", [
    ["test_attention"],
    ["test_attention", "--epochs", "3", "--batchsize", "16", "--lr",
     "0.02", "--hidden", "32", "--seed", "5"],
], ids=["defaults", "flags"])
def test_test_attention_is_the_jax_command(argv, recorded, tmp_path,
                                           capsys):
    port_lines, jax_lines = _run_both(argv, tmp_path, capsys)
    _same_calls(recorded)
    assert _records(tmp_path / "port") == _records(tmp_path / "jax")
    assert port_lines == jax_lines
    ((name, args, cfg, kw),) = recorded["port"]
    assert args[-1] == "self_attention" and kw["drop"] == 0.5
    if len(argv) == 1:
        assert (cfg["batchsize"], cfg["num_epochs"], kw["lr"], kw["h"]) == (
            128, 100, 0.01, 128)


MULTITRAIT_RUNS = {
    "pom_best": ["--style", "pom", "--mode", "best"],
    "iemocap_single_kl": ["--style", "iemocap", "--type", "kl", "--lr",
                          "0.002"],
    "pom_search": ["--style", "pom", "--mode", "search", "--trials", "2"],
}


@pytest.mark.parametrize("run", list(MULTITRAIT_RUNS))
def test_multitrait_trials_are_the_jax_command(run, recorded, tmp_path,
                                               capsys):
    argv = ["multitrait", *MULTITRAIT_RUNS[run], "--epochs", "2", "--seed",
            "9", "--ckpt-every", "1"]
    port_lines, jax_lines = _run_both(argv, tmp_path, capsys)
    _same_calls(recorded)
    got, want = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert got == want
    style = MULTITRAIT_RUNS[run][1]
    assert list(got)[0] == f"{style}_0"
    assert port_lines == jax_lines
    for name, _, cfg, kw in recorded["port"]:
        assert name == "train_mfm_multitrait"
        assert cfg["input_dims"] == [300, 74, 36]
        assert kw["lr"] == (0.002 if "--lr" in argv else None)


@pytest.mark.parametrize("argv,message", [
    (["predictor", "--kind", "eflstm", "--save-ckpt"],
     "only supported for --kind mfn"),
    (["predictor", "--kind", "self_attention", "--save-ckpt"],
     "only supported for --kind mfn"),
    (["predictor", "--dataset", "mosei_sdk"], "mosei_sdk needs --data-root"),
    (["predictor", "--seeds", "2"], "the command trains one model"),
    (["predictor", "--mode", "search", "--bucket"],
     "--bucket does not apply to predictor: the command trains one model"),
    (["predictor", "--mode", "search", "--evolve", "2"],
     "--evolve does not apply to predictor: the command trains one model"),
    (["test_attention", "--seeds", "3"],
     "--seeds does not apply to test_attention: the command trains one"),
    (["test_attention", "--mode", "search", "--bucket"],
     "the command trains one model"),
    (["test_attention", "--evolve", "2"], "the command trains one model"),
    (["multitrait", "--style", "mosei_sdk", "--split", "40;10"],
     "--split must be N_TRAIN,N_VALID video counts, got '40;10'"),
    (["multitrait", "--style", "pom_sdk", "--data-root", "no_such_dir"],
     "pom_sdk needs --data-root pointing at a directory"),
    (["multitrait", "--mode", "best", "--evolve", "2"],
     "--evolve only applies to --mode search"),
    (["multitrait", "--bucket"], "--bucket only applies to --mode search"),
    (["multitrait", "--seeds", "2"],
     "--seeds 2 on the multitrait surface only applies to --mode search "
     "with --bucket or --evolve"),
    (["multitrait", "--feature-selection", "0"], "only apply to the mosi"),
    (["multitrait", "--normalize-covarep"], "only apply to the mosi"),
], ids=["eflstm_save", "self_attention_save", "mosei_sdk", "seeds",
        "predictor_bucket", "predictor_evolve", "test_attention_seeds",
        "test_attention_bucket", "test_attention_evolve",
        "mosei_sdk_style", "pom_sdk_style", "evolve", "bucket",
        "multitrait_seeds", "feature_selection", "normalize_covarep"])
def test_refusals_come_before_any_load(argv, message, monkeypatch, tmp_path):
    def no_load(*a, **kw):
        raise AssertionError("data was loaded")

    monkeypatch.setattr(cli, "load_dataset", no_load)
    monkeypatch.setattr(multitrait, "get_data", no_load)
    with pytest.raises(SystemExit, match=message):
        cli.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


# ------------------------------------------------ the saved checkpoints

def test_predictor_mfn_save_ckpt_is_scored_by_test_mosi(monkeypatch,
                                                        tmp_path, capsys):
    data = _data(325, seed=2, n=(16, 8, 12))
    monkeypatch.setattr(cli, "load_dataset", lambda *a: data)
    monkeypatch.setattr(cli, "load_mosi", lambda t, **kw: data)
    out = tmp_path / "runs"
    assert cli.main(["predictor", "--kind", "mfn", "--mode", "best",
                     "--epochs", "1", "--batchsize", "8", "--device", "cpu",
                     "--out", str(out), "--save-ckpt"]) == 0
    trained = capsys.readouterr().out
    state, meta = restore_checkpoint(str(out / "ckpt_mfn_0"))
    cfg = meta["config"]
    assert cfg["model_type"] == "mfn" and cfg["h_dims"] == [88, 48, 16]
    assert cfg["_resume_lr"] == pytest.approx(0.01)
    assert "_resume_best_valid" not in cfg
    assert set(state["opt_state"]["state"]) == {"count", "mu", "nu"}
    assert cli.main(["test_mosi", "--checkpoint", str(out / "ckpt_mfn_0"),
                     "--device", "cpu"]) == 0
    scored = capsys.readouterr().out
    # the trainer's score of its kept parameters is test_mosi's
    mae = [line for line in trained.splitlines() if line.startswith("mae")]
    assert mae and mae[-1] in scored.splitlines()


def test_multitrait_save_ckpt_serves_one_column_a_trait(monkeypatch,
                                                        tmp_path, capsys):
    data = _data(410, seed=3, n=(16, 8, 12), traits=17)
    monkeypatch.setattr(multitrait, "get_data", lambda *a, **kw: data)
    out = tmp_path / "runs"
    assert cli.main(["multitrait", "--style", "pom", "--mode", "best",
                     "--epochs", "1", "--batchsize", "8", "--device", "cpu",
                     "--out", str(out), "--save-ckpt"]) == 0
    assert any(line.startswith("mae: [")
               for line in capsys.readouterr().out.splitlines())
    _, meta = restore_checkpoint(str(out / "ckpt_pom_0"))
    assert meta["config"]["output_dim"] == 17
    records = _records(out)["pom_0"]
    assert records[0]["kind"] == "config" and records[0]["output_dim"] == 1
    y = Predictor.from_checkpoint(str(out / "ckpt_pom_0"),
                                  device="cpu").predict(data[4])
    assert y.shape == (12, 17) and np.isfinite(y).all()


JCFG = JaxConfig(
    seqlength=5, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    out_shape=7, model_type="mfn")


def test_an_mfn_checkpoint_serves_and_scores_as_the_jax_predictor(
        monkeypatch, tmp_path, capsys):
    params = jax.tree.map(np.asarray, jax_get_model("mfn")[0](
        jax.random.PRNGKey(4), JCFG))
    rng = np.random.default_rng(5)
    X = rng.normal(size=(19, JCFG.seqlength, JCFG.d_total)).astype(
        np.float32)
    want = JaxPredictor(JCFG, params, batch_size=8).predict(X)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, from_numpy(params), config=JCFG.to_dict())
    predictor = Predictor.from_checkpoint(ckpt, batch_size=8, device="cpu")
    got = predictor.predict(X)
    assert got.shape == want.shape == (19,)
    np.testing.assert_allclose(got, want, **SERVE)
    assert predictor.forward.family == "mfn_predictor"

    y = rng.normal(size=(19,)).astype(np.float32)
    data = (X, y, X, y, X, y)
    monkeypatch.setattr(cli, "load_mosi", lambda t, **kw: data)
    assert cli.main(["test_mosi", "--checkpoint", ckpt, "--device",
                     "cpu"]) == 0
    printed = capsys.readouterr().out
    score = io.StringIO()
    jmetrics.score_regression(Predictor(
        MFMConfig.from_dict(JCFG.to_dict()), from_numpy(params),
        device="cpu").predict(X), y, out=score)
    assert score.getvalue() in printed
