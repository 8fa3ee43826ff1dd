"""The port's serving path over the y_hat-only forward on the CPU: the
forward against the JAX package's Predictor for ``mfm``, ``kl``,
``kl_ef`` and ``missing`` (a partial last chunk included) and against
``decoded[3]`` of the port's full eval forward; the operands packed once
against the per-call packing; ``autotune`` and ``device_latency``;
``export`` and ``ExportedPredictor`` (symbolic and fixed batch, the
refusals); the ``serve --export/--exported/--autotune`` and
``test_mosi`` command lines, scored as the JAX package scores; and the
classification metrics against the JAX package's. The CUDA-graph checks
are the ``gpu`` tests of ``tests/test_torch_cuda.py``.

Tolerances: y_hat against the JAX Predictor rtol 1e-5 / atol 1e-6,
float32; the packed input projection against the six hoisted ones
rtol 1e-6 / atol 1e-6 (the zero blocks add exact zeros, only the order
of the sums differs)."""

import io
import json

import jax
import numpy as np
import pytest
import torch

import factorized_tpu.models.mfm as jmfm
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.serve import Predictor as JaxPredictor
from factorized_tpu.utils import metrics as jmetrics
from factorized_tpu_torch import cli, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.models.common import split_modalities
from factorized_tpu_torch.models.predict import YHat, pack
from factorized_tpu_torch.ops import cuda_mfn
from factorized_tpu_torch.ops.fused import (encode_operands, hoist_xproj,
                                            repack_gate_major)
from factorized_tpu_torch.serve import ExportedPredictor, Predictor
from factorized_tpu_torch.utils import metrics
from factorized_tpu_torch.utils.checkpoint import save_checkpoint
from factorized_tpu_torch.utils.logging import RunLogger

SERVE = dict(rtol=1e-5, atol=1e-6)
PACK = dict(rtol=1e-6, atol=1e-6)
MODELS = ("mfm", "kl", "kl_ef", "missing")
INITS = {"mfm": jmfm.mfm_init, "kl": jmfm.mfm_kl_init,
         "kl_ef": jmfm.mfm_kl_ef_init, "missing": jmfm.mfm_missing_init}

JCFG = JaxConfig(
    seqlength=5, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
)
CFG = MFMConfig.from_dict(JCFG.to_dict())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_params(model_type, seed=0):
    return jax.tree.map(np.asarray, INITS[model_type](
        jax.random.PRNGKey(seed), JCFG.replace(model_type=model_type)))


def _x(n, seed=0, cfg=CFG):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.seqlength, cfg.d_total)).astype(np.float32)


@pytest.fixture(scope="module")
def predictor():
    return Predictor(CFG, from_numpy(_jax_params("mfm")), batch_size=8,
                     device="cpu")


# ----------------------------------------------------------- the forward

@pytest.mark.parametrize("model_type", MODELS)
def test_yhat_forward_matches_the_jax_predictor(model_type):
    params = _jax_params(model_type, seed=1)
    X = _x(19, seed=2)  # two full chunks of 8 and a partial one of 3
    want = JaxPredictor(JCFG.replace(model_type=model_type), params,
                        model_type=model_type, batch_size=8).predict(X)
    got = Predictor(CFG.replace(model_type=model_type), from_numpy(params),
                    model_type=model_type, batch_size=8,
                    device="cpu").predict(X)
    assert got.shape == want.shape == (19,)
    np.testing.assert_allclose(got, want, **SERVE)


@pytest.mark.parametrize("model_type", MODELS)
def test_yhat_forward_is_decoded_3_of_the_full_forward(model_type):
    init, apply_fn = get_model(model_type)
    params = init(torch.Generator().manual_seed(3), CFG)
    x = torch.from_numpy(_x(6, seed=4)).transpose(0, 1)
    with torch.no_grad():
        full = apply_fn(params, x, CFG,
                        generator=torch.Generator().manual_seed(0))[0][3]
        y = YHat(CFG, params, model_type)(x)
    torch.testing.assert_close(y, full[:, 0], rtol=0, atol=0)


def test_yhat_keeps_classification_logits():
    cfg = CFG.replace(task="classification", output_dim=3)
    init, apply_fn = get_model("mfm")
    params = init(torch.Generator().manual_seed(5), cfg)
    x = torch.from_numpy(_x(4, seed=6)).transpose(0, 1)
    with torch.no_grad():
        full = apply_fn(params, x, cfg,
                        generator=torch.Generator().manual_seed(0))[0][3]
        y = YHat(cfg, params, "mfm")(x)
    assert y.shape == (4, 3)
    torch.testing.assert_close(y, full, rtol=0, atol=0)


def test_packed_once_equals_the_per_call_packing():
    init, _ = get_model("mfm")
    params = init(torch.Generator().manual_seed(7), CFG)
    x = torch.from_numpy(_x(5, seed=8)).transpose(0, 1)
    ops, h_dims, z_tot = pack(params, CFG, "mfm")
    xp, weights, z_want, h_want = encode_operands(
        [params["enc"][k]["lstm"] for k in ("encoder_l", "encoder_a",
                                            "encoder_v")],
        params["mfn_enc"]["mfn"], *split_modalities(x, CFG.input_dims))
    assert (h_dims, z_tot) == (h_want, z_want)
    for name in cuda_mfn.W_NAMES:
        assert torch.equal(ops[f"w_{name}"], weights[name]), name
    t, n, d = x.shape
    one = (x.reshape(t * n, d) @ ops["wx"] + ops["bx"]).reshape(t, n, -1)
    torch.testing.assert_close(one, xp, **PACK)


def test_kl_ef_packs_its_early_fusion_cell_alone():
    init, _ = get_model("kl_ef")
    params = init(torch.Generator().manual_seed(9), CFG)
    x = torch.from_numpy(_x(5, seed=10)).transpose(0, 1)
    ops, h_dims, _ = pack(params, CFG, "kl_ef")
    cell = params["ef_encoder"]["lstm"]
    assert h_dims == [cell["wh"].shape[0]]
    assert torch.equal(ops["wh"], cell["wh"])
    t, n, d = x.shape
    one = (x.reshape(t * n, d) @ ops["wx"] + ops["bx"]).reshape(t, n, -1)
    torch.testing.assert_close(
        one, repack_gate_major([hoist_xproj(cell, x)], h_dims), **PACK)


def test_pack_refuses_other_model_types():
    with pytest.raises(ValueError, match="no y_hat forward"):
        pack({}, CFG, "s2s")


# ------------------------------------------------ autotune and latency

def test_autotune_returns_rates_and_keeps_the_best(predictor, monkeypatch):
    p = Predictor(CFG, predictor.params, batch_size=8, device="cpu")
    X = _x(20, seed=11)
    want = p.predict(X)
    # a clock on which a call takes as long as its chunks: the fewer
    # chunks, the faster, so 32 wins among the sizes not past 2 n
    clock = {"now": 0.0}
    real = p.predict

    def predict(X_):
        clock["now"] += -(-len(X_) // p.batch_size)
        return real(X_)

    monkeypatch.setattr(p, "predict", predict)
    monkeypatch.setattr("factorized_tpu_torch.serve.time.perf_counter",
                        lambda: clock["now"])
    rates = p.autotune(X, candidates=(4, 8, 32, 64), reps=2)
    assert set(rates) == {4, 8, 32}  # 64 > 2 n = 40
    assert rates[32] == max(rates.values()) == 20.0
    assert p.batch_size == 32
    np.testing.assert_allclose(real(X), want, **SERVE)


def test_device_latency_on_the_cpu(predictor):
    out = predictor.device_latency(_x(3), iters=4)
    assert set(out) == {"batch", "iters", "latency_s", "throughput_per_s",
                        "wall_latency_s"}
    assert (out["batch"], out["iters"]) == (8, 4)
    assert out["latency_s"] > 0 and out["throughput_per_s"] > 0


# ------------------------------------------------------------ export

@pytest.mark.parametrize("symbolic", [True, False],
                         ids=["symbolic", "fixed"])
@pytest.mark.parametrize("model_type", ["mfm", "kl_ef"])
def test_export_round_trip(tmp_path, model_type, symbolic):
    init, _ = get_model(model_type)
    params = init(torch.Generator().manual_seed(12), CFG)
    p = Predictor(CFG.replace(model_type=model_type), params,
                  batch_size=8, device="cpu")
    path = str(tmp_path / "art")
    assert p.export(path, symbolic_batch=symbolic) == path
    meta = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert meta == {"config": p.cfg.to_dict(), "model_type": model_type,
                    "batch_size": 8, "symbolic_batch": symbolic,
                    "platforms": ["cpu"]}
    served = Predictor.from_exported(path, device="cpu")
    assert isinstance(served, ExportedPredictor)
    assert served.params == () and served.batch_size == 8
    X = _x(19, seed=13)
    np.testing.assert_array_equal(served.predict(X), p.predict(X))
    assert served.predict(X[:0]).shape == (0,)
    if symbolic:
        served.autotune(X, candidates=(4, 16), reps=1)
        assert served.batch_size in (4, 16)
        np.testing.assert_allclose(served.predict(X), p.predict(X),
                                   **SERVE)
    else:
        with pytest.raises(NotImplementedError, match="symbolic_batch"):
            served.autotune(X)


def test_exported_refuses_another_platform(tmp_path, predictor):
    path = str(tmp_path / "art")
    predictor.export(path)
    meta_path = tmp_path / "art" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps(dict(meta, platforms=["cuda"])))
    with pytest.raises(ValueError, match="re-export on the serving"):
        ExportedPredictor(path, device="cpu")


# ------------------------------------------------------- command lines

def test_serve_cli_export_exported_autotune(tmp_path, monkeypatch,
                                            predictor, capsys):
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, predictor.params, config=CFG.to_dict())
    parser = cli.build_parser()
    args = parser.parse_args(["serve", "--exported", "a", "--autotune"])
    assert (args.exported, args.checkpoint, args.export, args.autotune) == \
        ("a", None, None, True)
    for argv in (["serve"], ["serve", "--checkpoint", "c", "--exported",
                             "a"]):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)
    seen = []
    monkeypatch.setattr("factorized_tpu_torch.serve.serve_http",
                        lambda p, *a, **kw: seen.append(p))
    # 1024 tuning rows at full width are slow on the CPU: tune on fewer
    real_tune = Predictor.autotune
    monkeypatch.setattr(Predictor, "autotune", lambda self, X: real_tune(
        self, X[:16], candidates=(8, 16), reps=1))
    art = str(tmp_path / "art")
    assert cli.main(["serve", "--checkpoint", ckpt, "--device", "cpu",
                     "--autotune", "--export", art]) == 0
    out = capsys.readouterr().out
    assert "autotuned batch sizes:" in out and "exported" in out
    assert not seen
    tuned = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert tuned["batch_size"] in (8, 16) and tuned["symbolic_batch"]
    assert cli.main(["serve", "--exported", art, "--device", "cpu"]) == 0
    assert isinstance(seen[0], ExportedPredictor)
    np.testing.assert_allclose(seen[0].predict(_x(5)),
                               predictor.predict(_x(5)), **SERVE)
    with pytest.raises(SystemExit, match="--export only applies"):
        cli.main(["serve", "--exported", art, "--export", "b", "--device",
                  "cpu"])
    fixed = str(tmp_path / "fixed")
    predictor.export(fixed, symbolic_batch=False)
    with pytest.raises(SystemExit, match="fixed batch shape"):
        cli.main(["serve", "--exported", fixed, "--autotune", "--device",
                  "cpu"])


def _test_mosi(tmp_path, monkeypatch, capsys, cfg, params, data):
    """``test_mosi`` on a checkpoint of ``params``: its printout and the
    Predictor's predictions on the test set."""
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, params, config=cfg.to_dict())
    monkeypatch.setattr(cli, "load_mosi", lambda t, **kw: data)
    assert cli.main(["test_mosi", "--checkpoint", ckpt, "--device",
                     "cpu"]) == 0
    printed = capsys.readouterr().out
    y_hat = Predictor(cfg, params, device="cpu").predict(data[4])
    return printed, y_hat


def _data(seed, cfg, n=(40, 10, 30)):
    rng = np.random.default_rng(seed)
    out = []
    for k in n:
        out += [_x(k, seed=int(rng.integers(1 << 30)), cfg=cfg),
                rng.normal(size=(k,)).astype(np.float32)]
    return tuple(out)


def test_test_mosi_scores_a_regression_checkpoint_as_jax(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    cfg = CFG.replace(num_epochs=2, batchsize=16)
    data = _data(14, cfg)
    res = trainers.train_mfm(*data, cfg, seed=0, device="cpu",
                             logger=RunLogger(echo=False))
    assert len(res["history"]) == 2
    printed, y_hat = _test_mosi(tmp_path, monkeypatch, capsys, cfg,
                                res["params"], data)
    want = io.StringIO()
    jmetrics.score_regression(y_hat, data[5], out=want)
    assert want.getvalue() in printed
    lines = [line for line in printed.splitlines() if line.startswith(
        ("inference probe:", "on-device latency:"))]
    probe, dev = (json.loads(line.split(":", 1)[1]) for line in lines)
    assert probe["n"] == 30 and dev["batch"] == 256


def test_test_mosi_scores_a_classification_checkpoint_as_jax(tmp_path,
                                                             monkeypatch,
                                                             capsys):
    cfg = CFG.replace(task="classification", output_dim=2)
    init, _ = get_model("mfm")
    params = init(torch.Generator().manual_seed(15), cfg)
    data = _data(16, cfg)
    printed, y_hat = _test_mosi(tmp_path, monkeypatch, capsys, cfg, params,
                                data)
    assert y_hat.shape == (30, 2)
    want = io.StringIO()
    jmetrics.score_classification(y_hat, (data[5] >= 0).astype(np.int64),
                                  out=want)
    assert want.getvalue() in printed


# ------------------------------------------------------------ metrics

@pytest.mark.parametrize("two_d", [True, False], ids=["logits", "labels"])
def test_classification_metrics_equal_the_jax_ones(two_d):
    rng = np.random.default_rng(17)
    y = rng.integers(0, 3, size=50)
    pred = (rng.normal(size=(50, 3)) if two_d
            else rng.integers(0, 3, size=50))
    assert metrics.classification_metrics(pred, y) == \
        jmetrics.classification_metrics(pred, y)
    got, want = io.StringIO(), io.StringIO()
    assert metrics.score_classification(pred, y, out=got) == \
        jmetrics.score_classification(pred, y, out=want)
    assert got.getvalue() == want.getvalue()
    nan = np.full((4, 3), np.nan)
    assert set(metrics.score_classification(nan, y[:4], out=io.StringIO())) \
        == {"accuracy", "f1_weighted"}


def test_trainers_score_classification():
    cfg = CFG.replace(task="classification", output_dim=2)
    rng = np.random.default_rng(18)
    logits, y = rng.normal(size=(20, 2)), rng.integers(0, 2, size=20)
    assert trainers._score(logits, y, cfg, 0.0, "ge") == \
        jmetrics.classification_metrics(logits, y)
