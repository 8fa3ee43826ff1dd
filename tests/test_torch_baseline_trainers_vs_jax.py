"""The port's trainers of this slice against the JAX package's, run for
run: ``train_seq2seq``, ``train_basic_missing`` (regression and three
classes), ``train_mfm_acc`` (through the chunked loop and the host loop)
and ``train_mfm`` on a three-class set with a non-empty remainder batch
(the ``moud``/``you`` path).

The same data, the same initial parameters (the JAX init, handed to the
port through ``convert.from_numpy``) and a configuration that leaves no
randomness in the run: every dropout rate 0 and ``lda_mmd`` 0. Held to
the bounds of ``tests/test_torch_trainers_vs_jax.py``: parameters within
1e-6, each epoch's train and validation numbers within 1e-5 relative,
every lr equal, test metrics within 1e-6 (a correlation within 1e-6 plus
1e-5 relative)."""

import jax
import numpy as np
import pytest
import torch

from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.utils.logging import RunLogger as JaxLogger
from factorized_tpu_torch import trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.utils.logging import RunLogger

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
METRICS = dict(rtol=0.0, atol=1e-6)
CORR = dict(rtol=1e-5, atol=1e-6)
EPOCHS = 3

# the small config of tests/test_torch_trainers_vs_jax.py: no random
# draw weighs on the run
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0, za_to_fa_dropout=0.0,
    zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0, lda_mmd=0.0,
    batchsize=16, num_epochs=EPOCHS)
CLASSES = dict(task="classification", output_dim=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data(seed, labels="regression", n=(48, 16, 20)):
    """(X, y) of train, valid and test: y a noisy readout of the last
    step, as floats, three classes of it, or its sign (``"binary"``,
    ``mosi_acc``'s ``y >= 0`` upstream)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in n:
        X = rng.normal(size=(k, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        y = (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=k)).astype(
            np.float32)
        if labels == "classes":
            y = np.digitize(y, [-0.7, 0.7]).astype(np.int64)
        elif labels == "binary":
            y = (y >= 0).astype(np.int64)
        out += [X, y]
    return tuple(out)


def _run_both(monkeypatch, name, model_type, jcfg, data, seed=3, init_cfg=None,
              host=False, **kw):
    """The JAX trainer ``name`` and the port's on the same data and
    initial parameters (the JAX init of ``init_cfg``, by default
    ``jcfg``), through the chunked loops or, ``host``, the host loops."""
    ik = jax.random.split(jax.random.PRNGKey(seed))[1]
    init = jax.tree.map(np.asarray, jax_get_model(model_type)[0](
        ik, init_cfg or jcfg))

    class FromJax:
        def __init__(self, cfg, *, seed, device, model_type):
            self._tree = from_numpy(init, device)

        def tree(self):
            return self._tree

    monkeypatch.setattr(trainers, "MFM", FromJax)
    if host:
        monkeypatch.setenv("FACTORIZED_TPU_HOST_LOOP", "1")
    else:
        monkeypatch.delenv("FACTORIZED_TPU_HOST_LOOP", raising=False)
    want = getattr(jtrainers, name)(*data, jcfg, seed=seed,
                                    logger=JaxLogger(echo=False), **kw)
    got = getattr(trainers, name)(*data, MFMConfig.from_dict(jcfg.to_dict()),
                                  seed=seed, device="cpu",
                                  logger=RunLogger(echo=False), **kw)
    return got, want


def _flat(metrics, prefix=""):
    out = {}
    for k, v in metrics.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_same_runs(got, want):
    assert len(got["history"]) == len(want["history"]) == EPOCHS
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        assert g["lr"] == w["lr"], (g, w)
        for k in ("train_loss", "valid"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **LOSSES)
    assert got["step"] == want["step"]
    np.testing.assert_allclose(got["best_valid"], want["best_valid"],
                               **LOSSES)
    flat_j = to_state_dict(jax.tree.map(np.asarray, want["params"]))
    flat_p = to_state_dict(got["params"])
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].detach().numpy(), v, err_msg=k,
                                   **PARAMS)
    metrics_j, metrics_p = _flat(want["metrics"]), _flat(got["metrics"])
    assert list(metrics_p) == list(metrics_j)
    for k, v in metrics_j.items():
        np.testing.assert_allclose(
            metrics_p[k], v, err_msg=k,
            **(CORR if k.endswith("corr") else METRICS))


@pytest.mark.parametrize("name,model_type,kw,labels", [
    ("train_seq2seq", "s2s", {}, "regression"),
    ("train_basic_missing", "bm", {}, "regression"),
    ("train_basic_missing", "bm", CLASSES, "classes"),
], ids=["s2s", "bm", "bm_classes"])
def test_baseline_trainer_matches_the_jax_trainer(monkeypatch, name,
                                                  model_type, kw, labels):
    jcfg = CFG.replace(model_type=model_type, missing=1, **kw)
    got, want = _run_both(monkeypatch, name, model_type, jcfg,
                          _data(4, labels))
    _assert_same_runs(got, want)
    if name == "train_seq2seq":
        assert list(got["metrics"]) == ["x_l_nol_mse", "x_a_noa_mse",
                                        "x_v_nov_mse"]
    else:
        assert list(got["metrics"]) == ["y_hat_nol", "y_hat_noa",
                                        "y_hat_nov"]


@pytest.mark.parametrize("host", [False, True], ids=["chunked", "host"])
def test_train_mfm_acc_matches_the_jax_trainer(monkeypatch, host):
    """The validation accuracy kept at its maximum, the same device
    accuracy in the chunked loop and the host loop, against the JAX
    package's ``eval_accuracy_device`` and ``eval_accuracy``."""
    got, want = _run_both(
        monkeypatch, "train_mfm_acc", "mfm", CFG, _data(5, "binary"),
        init_cfg=CFG.replace(task="classification", output_dim=2),
        host=host)
    _assert_same_runs(got, want)
    valids = [e["valid"] for e in got["history"]]
    assert all(v * 16 == round(v * 16) for v in valids)  # hits of 16 rows
    assert got["best_valid"] == max(valids)
    assert set(got["metrics"]) == {"accuracy", "f1_weighted"}


def test_train_mfm_with_a_remainder_batch_matches_the_jax_trainer(
        monkeypatch):
    """Three classes, 53 training rows at batch 16: three batches and a
    remainder of 5, its tracked loss divided by nb."""
    jcfg = CFG.replace(**CLASSES)
    got, want = _run_both(monkeypatch, "train_mfm", "mfm", jcfg,
                          _data(6, "classes", n=(53, 16, 20)),
                          include_remainder=True)
    _assert_same_runs(got, want)
