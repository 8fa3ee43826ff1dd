"""The port's trainers of the predictor slice against the JAX package's,
run for run: ``train_predictor`` for ``eflstm``, ``mfn`` and
``self_attention`` under the flat Adam and the flat SGD (``mfn`` also
through the host loop, ``eflstm`` also on three classes), and
``train_mfm_multitrait`` over four traits; and a ``train_predictor`` run
resumed from an auto-snapshot against the uninterrupted run.

The same data, the same initial parameters (the JAX init, handed to the
port through ``convert.from_numpy``) and a configuration that leaves no
randomness in the run: every dropout rate 0 (the MFN's sites, its out
head, the LSTM heads' ``drop``) and ``lda_mmd`` 0. Held to the bounds of
``tests/test_torch_trainers_vs_jax.py``: parameters within 1e-6, each
epoch's train and validation numbers within 1e-5 relative, every lr
equal, test metrics within 1e-6 (a correlation within 1e-6 plus 1e-5
relative).

The learning rates: the SGD runs take ``train_predictor``'s 0.01, the
Adam runs the 1e-3 of the other trainer tests. At 0.01 one weight of
``eflstm``'s LSTM, whose first gradients lie near Adam's eps, ends 4.2e-6
from the JAX run's after its first epoch (1e-3: 4.3e-7), the update
``m / (sqrt(v) + eps)`` magnifying the sums' other order. The
multi-trait run takes 0.01: at 1e-3 its 20 test predictions of a trait
spread over 7.5e-4, so the 3e-8 by which the serving forward's y_hat
differs from the JAX eval forward's on the same parameters moves a
correlation by 1.5e-6; at 0.01 they spread far enough."""

import jax
import numpy as np
import pytest
import torch

import factorized_tpu.models.baselines as jbase
from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.utils.logging import RunLogger as JaxLogger
from factorized_tpu_torch import trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import baselines
from factorized_tpu_torch.utils.logging import RunLogger

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
METRICS = dict(rtol=0.0, atol=1e-6)
CORR = dict(rtol=1e-5, atol=1e-6)
EPOCHS = 3
H = 8

# the small config of tests/test_torch_trainers_vs_jax.py: no random
# draw weighs on the run
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    out_shape=7, out_drop=0.0,
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


def _data(seed, labels="regression", traits=0, n=(48, 16, 20)):
    """(X, y) of train, valid and test: y a noisy readout of the last
    step, as floats, three classes of it, or ``traits`` columns of such
    readouts."""
    rng = np.random.default_rng(seed)
    out = []
    for k in n:
        X = rng.normal(size=(k, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        if traits:
            y = (X[:, -1, :traits] + 0.1 * rng.normal(size=(k, traits)))
            out += [X, y.astype(np.float32)]
            continue
        y = (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=k)).astype(
            np.float32)
        if labels == "classes":
            y = np.digitize(y, [-0.7, 0.7]).astype(np.int64)
        out += [X, y]
    return tuple(out)


def _jax_init(kind, jcfg, seed):
    """The JAX trainer's initial parameters: its init on the second half
    of ``split(PRNGKey(seed))``."""
    ik = jax.random.split(jax.random.PRNGKey(seed))[1]
    d, t = jcfg.d_total, jcfg.seqlength
    if kind in ("mfn", "mfm"):
        tree = jax_get_model(kind)[0](ik, jcfg)
    elif kind == "eflstm":
        tree = jbase.eflstm_init(ik, d, H, jcfg.output_dim)
    else:
        tree = jbase.self_attention_init(ik, d, H, t, jcfg.output_dim)
    return jax.tree.map(np.asarray, tree)


def _from_jax(monkeypatch, init):
    """The port's trainers start from ``init``: ``MFM``'s tree and the
    two LSTM baselines' inits all give it."""
    class FromJax:
        def __init__(self, cfg, *, seed, device, model_type):
            self._tree = from_numpy(init, device)

        def tree(self):
            return self._tree

    monkeypatch.setattr(trainers, "MFM", FromJax)
    for name in ("eflstm_init", "self_attention_init"):
        monkeypatch.setattr(baselines, name, lambda *a: from_numpy(init))


def _host_loop(monkeypatch, host):
    if host:
        monkeypatch.setenv("FACTORIZED_TPU_HOST_LOOP", "1")
    else:
        monkeypatch.delenv("FACTORIZED_TPU_HOST_LOOP", raising=False)


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


@pytest.mark.parametrize("kind,optimizer,labels,host", [
    ("eflstm", "adam", "regression", False),
    ("eflstm", "sgd", "regression", False),
    ("eflstm", "sgd", "classes", False),
    ("mfn", "adam", "regression", False),
    ("mfn", "sgd", "regression", True),
    ("self_attention", "adam", "regression", False),
    ("self_attention", "sgd", "regression", False),
], ids=["eflstm_adam", "eflstm_sgd", "eflstm_sgd_classes", "mfn_adam",
        "mfn_sgd_host", "self_attention_adam", "self_attention_sgd"])
def test_train_predictor_matches_the_jax_trainer(monkeypatch, kind,
                                                 optimizer, labels, host):
    jcfg = CFG.replace(model_type="mfn",
                       **(CLASSES if labels == "classes" else {}))
    seed = 3
    _from_jax(monkeypatch, _jax_init(kind, jcfg, seed))
    _host_loop(monkeypatch, host)
    data = _data(4, labels)
    kw = dict(h=H, drop=0.0, optimizer=optimizer, seed=seed,
              lr=0.01 if optimizer == "sgd" else 1e-3)
    want = jtrainers.train_predictor(*data, kind, jcfg,
                                     logger=JaxLogger(echo=False), **kw)
    got = trainers.train_predictor(*data, kind,
                                   MFMConfig.from_dict(jcfg.to_dict()),
                                   device="cpu",
                                   logger=RunLogger(echo=False), **kw)
    _assert_same_runs(got, want)
    state = got["opt_state"]["state"]
    assert set(state) == ({"trace"} if optimizer == "sgd"
                          else {"count", "mu", "nu"})


def test_train_mfm_multitrait_matches_the_jax_trainer(monkeypatch):
    seed = 5
    data = _data(6, traits=4)
    _from_jax(monkeypatch, _jax_init(
        "mfm", CFG.replace(task="regression", output_dim=4), seed))
    _host_loop(monkeypatch, False)
    want = jtrainers.train_mfm_multitrait(*data, CFG, seed=seed, lr=0.01,
                                          logger=JaxLogger(echo=False))
    got = trainers.train_mfm_multitrait(
        *data, MFMConfig.from_dict(CFG.to_dict()), seed=seed, lr=0.01,
        device="cpu", logger=RunLogger(echo=False))
    _assert_same_runs(got, want)
    assert list(got["metrics"]) == ["mae", "corr", "mult_acc"]
    assert all(len(v) == 4 for v in got["metrics"].values())


@pytest.mark.parametrize("kind,optimizer", [("eflstm", "sgd"),
                                            ("mfn", "adam")])
def test_a_resumed_predictor_run_goes_on_as_the_uninterrupted_one(
        tmp_path, monkeypatch, kind, optimizer):
    """``train_predictor`` with ``resume_from`` an auto-snapshot of its
    first two epochs (``cli.make_autosnapshot``: parameters, the flat
    optimizer's state, step, lr and best validation loss) gives the last
    two epochs of the uninterrupted four-epoch run, bit for bit: nothing
    in this configuration draws."""
    from factorized_tpu_torch.cli import make_autosnapshot

    _host_loop(monkeypatch, False)
    cfg = MFMConfig.from_dict(CFG.replace(model_type="mfn").to_dict())
    data = _data(7)
    kw = dict(h=H, drop=0.0, optimizer=optimizer, seed=2, device="cpu",
              lr=0.01 if optimizer == "sgd" else 1e-3)

    def run(epochs, **more):
        return trainers.train_predictor(
            *data, kind, cfg.replace(num_epochs=epochs),
            logger=RunLogger(echo=False), **kw, **more)

    whole = run(4)
    run(2, snapshot=make_autosnapshot(str(tmp_path), "p", cfg, 2))
    resumed = run(4, resume_from=str(tmp_path / "ckpt_auto_p"))
    assert resumed["step"] == whole["step"] == 4
    assert resumed["history"] == whole["history"][2:]
    assert resumed["best_valid"] == whole["best_valid"]
    for k, v in whole["opt_state"]["state"].items():
        assert torch.equal(resumed["opt_state"]["state"][k], v), k
    assert resumed["opt_state"]["lr"] == whole["opt_state"]["lr"]
