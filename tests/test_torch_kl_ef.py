"""The port's early-fusion variational MFM (``kl_ef``) against the JAX
package's on the same parameters, inputs and random draws: the eval
forward, the ``"joint"`` and ``"beta_vae"`` losses and their gradients
(JAX on its Pallas kernels in interpret mode and on its scan path, and at
``best_acc_mosi_config`` width), the init tree, the two-stage trainer,
the ``mosi --type kl_ef`` command line and the Predictor.

Tolerances: forward rtol 2e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 2e-5 (as tests/test_pallas_mfn.py), float32."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.models.mfm as jmfm
import factorized_tpu.ops.fused as jfused
from factorized_tpu import train as jtrain
from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import best_acc_mosi_config as jax_best
from factorized_tpu.serve import Predictor as JaxPredictor
from factorized_tpu.utils import metrics as jmetrics
from factorized_tpu_torch import cli, train, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import get_model, mfm
from factorized_tpu_torch.serve import Predictor
from factorized_tpu_torch.utils.checkpoint import (BestKeeper,
                                                   restore_checkpoint)
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.metrics import score_regression

FWD = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)

# the small config of tests/test_torch_train.py: every z->f dropout site
# of best_acc_mosi_config active at its rate
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.2,
    za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7, fy_to_y_dropout=0.0,
    model_type="kl_ef",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _with_pallas(flag, fn):
    old = jfused.USE_PALLAS
    jfused.USE_PALLAS = flag
    try:
        return fn()
    finally:
        jfused.USE_PALLAS = old


def _draws(jcfg, key, n):
    """The z->f masks of JAX's kl_ef train forward for the loss's ``key``:
    the loss splits key -> k1, ``mfm_kl_ef_apply`` splits k1 into 2 and
    ``_zf_all`` k[0] into one key per site (the y head's rate is 0)."""
    k1 = jax.random.split(key)[0]
    zk = jax.random.split(jax.random.split(k1, 2)[0], 4)
    rates = (jcfg.zy_to_fy_dropout, jcfg.zl_to_fl_dropout,
             jcfg.za_to_fa_dropout, jcfg.zv_to_fv_dropout)
    f_dims = (jcfg.fy_size, jcfg.fl_size, jcfg.fa_size, jcfg.fv_size)
    masks = []
    for kk, rate, f in zip(zk, rates, f_dims):
        if rate <= 0.0:
            masks.append(None)
            continue
        keep = 1.0 - rate
        bern = np.array(jax.random.bernoulli(kk, keep, (n, f)))
        masks.append(torch.from_numpy(
            bern.astype(np.float32) * np.float32(1.0 / keep)))
    assert jcfg.fy_to_y_dropout == 0.0
    return {"zf_masks": masks}


def _params(jcfg, seed=0):
    return jmfm.mfm_kl_ef_init(jax.random.PRNGKey(seed), jcfg)


# ------------------------------------------------------------ forward

def _forward_matches(jcfg, t, n, use_pallas):
    assert jmfm.fused_active(jcfg)
    params = _params(jcfg)
    x = np.random.default_rng(1).normal(
        size=(t, n, jcfg.d_total)).astype(np.float32)
    apply_j = jax.jit(lambda p, x_: jmfm.mfm_kl_ef_apply(
        p, x_, jcfg, key=jax.random.PRNGKey(2), train=False))
    decoded_j, kld_j, _ = _with_pallas(
        use_pallas, lambda: apply_j(params, jnp.asarray(x)))
    cfg = MFMConfig.from_dict(jcfg.to_dict())
    with torch.no_grad():
        decoded_p, kld_p, missing = mfm.mfm_kl_ef_apply(
            from_numpy(jax.tree.map(np.asarray, params)),
            torch.from_numpy(x), cfg)
    assert missing == 0.0 and len(decoded_p) == 4
    for p, j in zip(decoded_p, decoded_j):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **FWD)
    np.testing.assert_allclose(float(kld_p), float(kld_j), **FWD)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
def test_eval_forward_matches_jax(use_pallas):
    _forward_matches(CFG, t=6, n=4, use_pallas=use_pallas)


def test_eval_forward_matches_jax_at_full_width():
    # best_acc_mosi_config widths, t = 20, n = 4, the JAX scan path
    _forward_matches(jax_best(model_type="kl_ef"), t=20, n=4,
                     use_pallas=False)


# ---------------------------------------------------------- gradients

def _grads_match(jcfg, t, n, use_pallas, variant, stage=0):
    params = _params(jcfg)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(t, n, jcfg.d_total)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    loss_j = jtrain.make_loss_fn(jmfm.mfm_kl_ef_apply, jcfg, variant, stage)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, jnp.asarray(x), jnp.asarray(y), key),
        has_aux=True))
    (lj, tj), gj = _with_pallas(use_pallas, lambda: grad_fn(params))

    cfg = MFMConfig.from_dict(jcfg.to_dict())
    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    loss_p = train.make_loss_fn(mfm.mfm_kl_ef_apply, cfg, variant, stage)
    lp, tp = loss_p(tree, torch.from_numpy(x), torch.from_numpy(y),
                    draws=_draws(jcfg, key, n))
    lp.backward()
    np.testing.assert_allclose(lp.item(), float(lj), **FWD)
    np.testing.assert_allclose(tp.item(), float(tj), **FWD)
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    assert set(flat_j) == set(flat)
    for name, leaf in flat.items():
        # a stage-1 loss does not reach the label head
        got = (np.zeros_like(flat_j[name]) if leaf.grad is None
               else leaf.grad.numpy())
        np.testing.assert_allclose(got, flat_j[name], err_msg=name, **GRAD)


@pytest.mark.parametrize("use_pallas,variant,stage", [
    (True, "joint", 0), (False, "joint", 0), (True, "beta_vae", 1),
    (False, "beta_vae", 2)], ids=["pallas-joint", "scan-joint",
                                  "pallas-stage1", "scan-stage2"])
def test_loss_grads_match_jax(use_pallas, variant, stage):
    _grads_match(CFG, t=6, n=4, use_pallas=use_pallas, variant=variant,
                 stage=stage)


def test_loss_grads_match_jax_at_full_width():
    # best_acc_mosi_config widths and rates, t = 20, n = 4, the scan path
    _grads_match(jax_best(model_type="kl_ef"), t=20, n=4, use_pallas=False,
                 variant="joint")


def test_train_draws_come_from_the_generator():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    params = mfm.mfm_kl_ef_init(torch.Generator().manual_seed(0), cfg)
    # a seeded input: with 3% of inputs the units the two seeds' masks
    # differ on are all zero after the relu, and the decodes agree
    x = torch.randn(5, 3, cfg.d_total,
                    generator=torch.Generator().manual_seed(2))

    def run(seed):
        return mfm.mfm_kl_ef_apply(
            params, x, cfg, train=True,
            generator=torch.Generator().manual_seed(seed))[0][0]

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="Generator"):
        mfm.mfm_kl_ef_apply(params, x, cfg, train=True)
    # the eval forward draws nothing
    mfm.mfm_kl_ef_apply(params, x, cfg)


# ------------------------------------------------------ tree and module

def test_init_tree_and_module_match_jax():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    ref = to_state_dict(jax.tree.map(np.asarray, _params(CFG)))
    port = to_state_dict(mfm.mfm_kl_ef_init(torch.Generator().manual_seed(0),
                                            cfg))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    model = mfm.MFM(cfg, seed=1, device="cpu")
    assert model.model_type == "kl_ef" and set(model.state_dict()) == set(ref)
    assert get_model("kl_ef") == (mfm.mfm_kl_ef_init, mfm.mfm_kl_ef_apply)
    x = torch.randn(5, 2, cfg.d_total)
    with torch.no_grad():
        out_m = model(x)
        out_f = mfm.mfm_kl_ef_apply(model.tree(), x, cfg)
    assert all(torch.equal(a, b) for a, b in zip(out_m[0], out_f[0]))


# ------------------------------------------------------------- trainer

def _small_data(seed, n_train=70, n_valid=20, n_test=24, t=6, d=17):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, t, d)).astype(np.float32)
        return X, (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)).astype(
            np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def _return_keys(trainer):
    """The keys of the JAX trainer's return dict, from its source."""
    src = open(jtrainers.__file__).read()
    body = src[src.index(f"def {trainer}("):]
    body = body[:body.index("\ndef ", 1)]
    ret = body[body.rindex("return {"):]
    return set(k.strip('"') for k in
               __import__("re").findall(r'"(\w+)":', ret))


def test_train_beta_vae_two_stages_on_cpu(tmp_path, monkeypatch):
    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(batchsize=16,
                                                     num_epochs=2)
    # the validation loss rises every epoch, so only save_always keeps
    # the later epochs
    valids = iter([1.0, 2.0, 3.0, 4.0])
    real_eval = train.TrainProgram.evaluate
    monkeypatch.setattr(
        train.TrainProgram, "evaluate",
        lambda self, *a: (real_eval(self, *a), torch.tensor(next(valids)))[1])
    keepers, schedulers = [], []

    class Keeper(BestKeeper):
        def __init__(self, mode):
            super().__init__(mode)
            keepers.append(self)

    real_plateau = trainers.ReduceLROnPlateau
    monkeypatch.setattr(trainers, "BestKeeper", Keeper)
    monkeypatch.setattr(trainers, "ReduceLROnPlateau",
                        lambda lr: schedulers.append(lr) or real_plateau(lr))
    logger = RunLogger(str(tmp_path), run_id="run", echo=False)
    res = trainers.train_beta_vae(*_small_data(0), cfg, logger=logger,
                                  seed=3, device="cpu")
    logger.close()
    assert set(res) == _return_keys("train_beta_vae") == {
        "metrics", "params", "opt_state", "history", "step"}
    assert [(e["stage"], e["epoch"]) for e in res["history"]] == [
        (1, 0), (1, 1), (2, 0), (2, 1)]
    assert res["step"] == 4 and all(np.isfinite(e["train_loss"])
                                    for e in res["history"])
    # one keeper per stage, each keeping its last epoch; one scheduler and
    # one Adam across both stages (4 batches per epoch, 4 epochs)
    assert len(keepers) == 2 and len(schedulers) == 1
    assert [(k.best, k.best_epoch) for k in keepers] == [(2.0, 1), (4.0, 1)]
    assert int(res["opt_state"]["state"]["count"]) == 16
    records = [json.loads(line) for line in
               (tmp_path / "run.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in records] == ["epoch"] * 4 + ["final"]
    assert all(r["saved"] for r in records[:4])
    # the last parameters are returned and scored
    last = to_state_dict(keepers[1].best_params)
    for k, v in to_state_dict(res["params"]).items():
        assert torch.equal(v.detach(), last[k]), k
    y_hat = Predictor(cfg, res["params"], device="cpu").predict(
        _small_data(0)[4])
    assert score_regression(y_hat, _small_data(0)[5],
                            out=__import__("io").StringIO()) == res["metrics"]
    assert set(res["metrics"]) == set(jmetrics.regression_metrics(
        np.ones(3), np.arange(3.0)))


def test_train_mfm_takes_kl_ef_under_the_joint_loss():
    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(batchsize=32,
                                                     num_epochs=1)
    res = trainers.train_mfm(*_small_data(1), cfg, seed=0, device="cpu",
                             logger=RunLogger(echo=False))
    assert len(res["history"]) == 1 and np.isfinite(res["best_valid"])
    assert set(to_state_dict(res["params"])) == set(
        to_state_dict(jax.tree.map(np.asarray, _params(CFG))))
    with pytest.raises(ValueError, match="cannot train model type"):
        trainers.train_mfm(*_small_data(1), cfg, model_type="missing",
                           device="cpu", logger=RunLogger(echo=False))


# ---------------------------------------------------------- command line

def test_mosi_cli_trains_kl_ef_and_saves(tmp_path, monkeypatch, capsys):
    # best_acc_mosi_config at full width on a few random segments
    rng = np.random.default_rng(0)

    def data(n):
        return (rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))

    monkeypatch.setattr(cli, "load_mosi",
                        lambda t, **kw: (*data(40), *data(10), *data(12)))
    out = tmp_path / "runs"
    assert cli.main(["mosi", "--mode", "best", "--type", "kl_ef",
                     "--epochs", "1", "--batchsize", "16", "--device", "cpu",
                     "--out", str(out), "--save-ckpt"]) == 0
    printed = capsys.readouterr().out
    assert "mae: " in printed and "checkpoint saved" in printed
    state, meta = restore_checkpoint(str(out / "ckpt_mosi_0"))
    assert meta["step"] == 2 and meta["has_opt_state"]
    assert meta["config"]["model_type"] == "kl_ef"
    assert "varhead" in state["params"] and "ef_encoder" in state["params"]
    kinds = [json.loads(line)["kind"] for line in
             (out / "mosi_0.jsonl").read_text().splitlines()]
    assert kinds == ["config", "epoch", "epoch", "final"]
    y = Predictor.from_checkpoint(str(out / "ckpt_mosi_0"),
                                  device="cpu").predict(data(3)[0])
    assert y.shape == (3,) and np.isfinite(y).all()


# ------------------------------------------------------------- serving

def test_predictor_matches_jax_predictor():
    params = jax.tree.map(np.asarray, _params(CFG, seed=5))
    X = np.random.default_rng(6).normal(
        size=(11, CFG.seqlength, CFG.d_total)).astype(np.float32)
    want = JaxPredictor(CFG, params, batch_size=8).predict(X)
    got = Predictor(MFMConfig.from_dict(CFG.to_dict()), from_numpy(params),
                    batch_size=8, device="cpu").predict(X)
    assert got.shape == want.shape == (11,)
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("model_type", ["s2s", "bm"])
def test_predictor_refuses_as_jax_does(model_type):
    with pytest.raises(ValueError) as want:
        JaxPredictor(CFG, {}, model_type=model_type)
    with pytest.raises(ValueError) as got:
        Predictor(MFMConfig.from_dict(CFG.to_dict()), {},
                  model_type=model_type, device="cpu")
    assert str(got.value) == str(want.value)
