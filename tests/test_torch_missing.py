"""The port's MFM_missing (``missing``) against the JAX package's on the
same parameters, inputs and random draws: the eval forward's six outputs,
the ``"missing"`` loss and its gradients (JAX on its Pallas kernels in
interpret mode and on its scan path, and at ``best_acc_mosi_config``
width), the init tree, the trainer, the ``mosi --missing 1`` command line
and the Predictor.

Tolerances: forward rtol 2e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 2e-5 (as tests/test_pallas_mfn.py), float32."""

import io
import json
import re

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
from factorized_tpu.ops import pallas_mfn
from factorized_tpu.serve import Predictor as JaxPredictor
from factorized_tpu.utils import metrics as jmetrics
from factorized_tpu_torch import cli, train, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import get_model, mfm
from factorized_tpu_torch.ops import cuda_lstm
from factorized_tpu_torch.serve import Predictor
from factorized_tpu_torch.utils.checkpoint import restore_checkpoint
from factorized_tpu_torch.utils.logging import RunLogger

FWD = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)

# the small config of tests/test_torch_train.py with every dropout site
# of best_acc_mosi_config active at its rate
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.5, att2_drop=0.5, gamma1_drop=0.5, gamma2_drop=0.5,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.2,
    za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7, fy_to_y_dropout=0.0,
    missing=1,
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


def _noise(jcfg, key, n):
    dmax = max(jcfg.zl_size, jcfg.za_size, jcfg.zv_size, jcfg.zy_size)
    return torch.from_numpy(np.array(
        jax.random.normal(key, (4, n, dmax), jnp.float32)))


def _draws(jcfg, key, t, n):
    """Every draw of JAX's missing loss for ``key``, as tensors: the loss
    splits key -> k1, ``mfm_missing_apply`` splits k1 into 6 (encode
    masks, MMD Gaussian, then the four decodes, each splitting its key
    into the z->f key, split per site, and the y head's, whose rate is
    0)."""
    k = jax.random.split(jax.random.split(key)[0], 6)
    sizes = (jcfg.att1_shape, jcfg.att2_shape, jcfg.gamma1_shape,
             jcfg.gamma2_shape)
    drops = (jcfg.att1_drop, jcfg.att2_drop, jcfg.gamma1_drop,
             jcfg.gamma2_drop)
    encode = np.array(pallas_mfn.make_dropout_masks(k[0], t, n, sizes,
                                                    drops))
    rates = (jcfg.zy_to_fy_dropout, jcfg.zl_to_fl_dropout,
             jcfg.za_to_fa_dropout, jcfg.zv_to_fv_dropout)
    f_dims = (jcfg.fy_size, jcfg.fl_size, jcfg.fa_size, jcfg.fv_size)
    zf = []
    for dkey in k[2:]:
        zk = jax.random.split(jax.random.split(dkey, 2)[0], 4)
        masks = []
        for kk, rate, f in zip(zk, rates, f_dims):
            if rate <= 0.0:
                masks.append(None)
                continue
            keep = 1.0 - rate
            bern = np.array(jax.random.bernoulli(kk, keep, (n, f)))
            masks.append(torch.from_numpy(
                bern.astype(np.float32) * np.float32(1.0 / keep)))
        zf.append(masks)
    assert jcfg.fy_to_y_dropout == 0.0
    return {"encode_masks": torch.from_numpy(encode),
            "mmd_noise": _noise(jcfg, k[1], n), "zf_masks": zf}


def _params(jcfg, seed=0):
    return jmfm.mfm_missing_init(jax.random.PRNGKey(seed), jcfg)


# ------------------------------------------------------------ forward

def _forward_matches(jcfg, t, n, use_pallas):
    assert jmfm.fused_active(jcfg)
    params = _params(jcfg)
    x = np.random.default_rng(1).normal(
        size=(t, n, jcfg.d_total)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    apply_j = jax.jit(lambda p, x_: jmfm.mfm_missing_apply(
        p, x_, jcfg, key=key, train=False))
    out_j = _with_pallas(use_pallas, lambda: apply_j(params, jnp.asarray(x)))
    cfg = MFMConfig.from_dict(jcfg.to_dict())
    with torch.no_grad():
        out_p = mfm.mfm_missing_apply(
            from_numpy(jax.tree.map(np.asarray, params)),
            torch.from_numpy(x), cfg,
            mmd_noise=_noise(jcfg, jax.random.split(key, 6)[1], n))
    assert len(out_p) == len(out_j) == 6
    for dec_p, dec_j in zip(out_p[:4], out_j[:4]):
        assert len(dec_p) == 4
        for p, j in zip(dec_p, dec_j):
            assert tuple(p.shape) == j.shape
            np.testing.assert_allclose(p.numpy(), np.asarray(j), **FWD)
    for p, j in zip(out_p[4:], out_j[4:]):
        np.testing.assert_allclose(float(p), float(j), **FWD)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
def test_eval_forward_matches_jax(use_pallas):
    _forward_matches(CFG, t=6, n=4, use_pallas=use_pallas)


def test_eval_forward_matches_jax_at_full_width():
    # best_acc_mosi_config widths, t = 20, n = 4, the JAX scan path
    _forward_matches(jax_best(missing=1), t=20, n=4, use_pallas=False)


# ---------------------------------------------------------- gradients

def _grads_match(jcfg, t, n, use_pallas):
    params = _params(jcfg)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(t, n, jcfg.d_total)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    loss_j = jtrain.make_loss_fn(jmfm.mfm_missing_apply, jcfg, "missing")
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, jnp.asarray(x), jnp.asarray(y), key),
        has_aux=True))
    (lj, tj), gj = _with_pallas(use_pallas, lambda: grad_fn(params))

    cfg = MFMConfig.from_dict(jcfg.to_dict())
    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    loss_p = train.make_loss_fn(mfm.mfm_missing_apply, cfg, "missing")
    lp, tp = loss_p(tree, torch.from_numpy(x), torch.from_numpy(y),
                    draws=_draws(jcfg, key, t, n))
    lp.backward()
    np.testing.assert_allclose(lp.item(), float(lj), **FWD)
    np.testing.assert_allclose(tp.item(), float(tj), **FWD)
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    assert set(flat_j) == set(flat)
    for name, leaf in flat.items():
        np.testing.assert_allclose(leaf.grad.numpy(), flat_j[name],
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
def test_loss_grads_match_jax(use_pallas):
    _grads_match(CFG, t=6, n=4, use_pallas=use_pallas)


def test_loss_grads_match_jax_at_full_width():
    # best_acc_mosi_config widths and rates, t = 20, n = 4, the scan path
    _grads_match(jax_best(missing=1), t=20, n=4, use_pallas=False)


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_stacked_decodes_equal_the_four_separate_ones(monkeypatch,
                                                      train_mode):
    """``mfm_missing_apply`` runs its four decodes' recurrence once, over
    the latent sets stacked along the rows; each decode equals ``_decode``
    run alone on its set, with the same injected z->f masks in train
    mode. The stacked products sum over the same depths as the separate
    ones, so the tolerance is float32 rounding only."""
    cfg = MFMConfig.from_dict(CFG.to_dict())
    params = from_numpy(jax.tree.map(np.asarray, _params(CFG)))
    t, n = 6, 4
    rng = np.random.default_rng(5)
    latents = [tuple(torch.from_numpy(rng.normal(size=(n, d))
                                      .astype(np.float32))
                     for d in (cfg.zl_size, cfg.za_size, cfg.zv_size,
                               cfg.zy_size)) for _ in range(4)]
    masks = (_draws(CFG, jax.random.PRNGKey(6), t, n)["zf_masks"]
             if train_mode else [None] * 4)
    rows, decoder_lstm = [], cuda_lstm.decoder_lstm

    def counted(h0, *rest):
        rows.append(h0.shape[0])
        return decoder_lstm(h0, *rest)

    monkeypatch.setattr(cuda_lstm, "decoder_lstm", counted)
    with torch.no_grad():
        stacked = mfm._decode_stacked(params, latents, t, cfg,
                                      train=train_mode, zf_masks=masks,
                                      y_masks=[None] * 4)
        assert rows == [4 * n]
        for k, (zl, za, zv, zy) in enumerate(latents):
            f = mfm._zf_all(params, zy, zl, za, zv, cfg, train=train_mode,
                            masks=masks[k])
            alone = mfm._decode(params, *f, t, cfg, train=train_mode)
            assert len(stacked[k]) == len(alone) == 4
            for got, want in zip(stacked[k], alone):
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_eval_loss_is_the_composite_loss():
    """The eval function scores the whole composite loss, in eval mode,
    as the JAX package's does."""
    params = _params(CFG)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 3, CFG.d_total)).astype(np.float32)
    y = rng.normal(size=(3,)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jax.jit(jtrain.make_eval_fn(jmfm.mfm_missing_apply, CFG,
                                       "missing"))(
        params, jnp.asarray(x), jnp.asarray(y), key)
    cfg = MFMConfig.from_dict(CFG.to_dict())
    noise = _noise(CFG, jax.random.split(key, 6)[1], 3)
    eval_fn = train.make_eval_fn(
        lambda *a, **kw: mfm.mfm_missing_apply(*a, mmd_noise=noise, **kw),
        cfg, "missing")
    got = eval_fn(from_numpy(jax.tree.map(np.asarray, params)),
                  torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), **FWD)


# ------------------------------------------------------ tree and module

def test_init_tree_and_module_match_jax():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    ref = to_state_dict(jax.tree.map(np.asarray, _params(CFG)))
    port = to_state_dict(mfm.mfm_missing_init(
        torch.Generator().manual_seed(0), cfg))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    model = mfm.MFM(cfg, seed=1, device="cpu", model_type="missing")
    assert set(model.state_dict()) == set(ref)
    assert get_model("missing") == (mfm.mfm_missing_init,
                                    mfm.mfm_missing_apply)
    x = torch.randn(5, 2, cfg.d_total)
    model.train()
    out = model(x, generator=torch.Generator().manual_seed(0))
    again = model(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out[3][0], again[3][0]) and torch.equal(out[5],
                                                                again[5])
    (sum(torch.sum(d) for dec in out[:4] for d in dec) + out[4]
     + out[5]).backward()
    assert all(p.grad is not None for p in model.parameters())
    with pytest.raises(ValueError, match="Generator"):
        mfm.mfm_missing_apply(model.tree(), x, cfg)


# ------------------------------------------------------------- trainer

def _small_data(seed, n_train=70, n_valid=20, n_test=24, t=6, d=17):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, t, d)).astype(np.float32)
        return X, (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)).astype(
            np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def test_train_mfm_missing_on_cpu(tmp_path, capsys):
    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(batchsize=16,
                                                     num_epochs=2)
    logger = RunLogger(str(tmp_path), run_id="run")
    res = trainers.train_mfm_missing(*_small_data(0), cfg, logger=logger,
                                     seed=3, device="cpu")
    logger.close()
    src = open(jtrainers.__file__).read()
    body = src[src.index("def train_mfm_missing("):
               src.index("def train_mfm_test_zeros(")]
    ret = body[body.rindex("return {"):]
    assert set(res) == set(re.findall(r'"(\w+)":', ret))
    assert len(res["history"]) == 2 and res["step"] == 2
    assert res["best_valid"] == min(e["valid"] for e in res["history"])
    assert all(np.isfinite(e["train_loss"]) for e in res["history"])
    regression = set(jmetrics.regression_metrics(np.ones(3), np.arange(3.0)))
    assert list(res["metrics"]) == ["y_hat_nol", "y_hat_noa", "y_hat_nov",
                                    "y_hat"]
    assert all(set(m) == regression for m in res["metrics"].values())
    # the four per-condition reconstruction MSEs, then the four scores
    lines = capsys.readouterr().out.splitlines()
    tags = [ln for ln in lines
            if ln.startswith(("all present", "l missing", "a missing",
                              "v missing", "scoring"))]
    assert [" ".join(t.split()[:2]) for t in tags] == [
        "all present", "l missing", "a missing", "v missing",
        "scoring y_hat_nol", "scoring y_hat_noa", "scoring y_hat_nov",
        "scoring y_hat"]
    assert all(np.isfinite(float(v)) for t in tags[:4]
               for v in t.split()[2:])
    kinds = [json.loads(line)["kind"]
             for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    assert kinds == ["epoch", "epoch", "final"]
    # the y_hat of the all-present decode is what a Predictor serves
    y = Predictor(cfg, res["params"], model_type="missing",
                  device="cpu").predict(_small_data(0)[4])
    from factorized_tpu_torch.utils.metrics import score_regression

    assert score_regression(y, _small_data(0)[5], out=io.StringIO()) == \
        res["metrics"]["y_hat"]


# ---------------------------------------------------------- command line

def test_mosi_cli_trains_missing_and_saves(tmp_path, monkeypatch, capsys):
    # best_acc_mosi_config at full width on a few random segments
    rng = np.random.default_rng(0)

    def data(n):
        return (rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))

    monkeypatch.setattr(cli, "load_mosi",
                        lambda t, **kw: (*data(40), *data(10), *data(12)))
    out = tmp_path / "runs"
    assert cli.main(["mosi", "--mode", "best", "--missing", "1",
                     "--epochs", "1", "--batchsize", "16", "--device", "cpu",
                     "--out", str(out), "--save-ckpt"]) == 0
    printed = capsys.readouterr().out
    assert "scoring y_hat_nov" in printed and "checkpoint saved" in printed
    state, meta = restore_checkpoint(str(out / "ckpt_mosi_0"))
    assert meta["step"] == 1 and meta["has_opt_state"]
    assert (meta["config"]["model_type"], meta["config"]["missing"]) == \
        ("mfm", 1)
    assert "encoder_av_to_y" in state["params"]
    kinds = [json.loads(line)["kind"] for line in
             (out / "mosi_0.jsonl").read_text().splitlines()]
    assert kinds == ["config", "epoch", "final"]
    y = Predictor.from_checkpoint(str(out / "ckpt_mosi_0"),
                                  model_type="missing",
                                  device="cpu").predict(data(3)[0])
    assert y.shape == (3,) and np.isfinite(y).all()


@pytest.mark.parametrize("mode", ["best", "single"])
def test_mosi_cli_picks_the_jax_trainer(mode):
    picks = {("mfm", 0, 0): "train_mfm", ("kl_ef", 0, 0): "train_beta_vae",
             ("mfm", 1, 0): "train_mfm_missing",
             ("mfm", 1, 1): "train_mfm_missing"}
    for (kind, missing, zeros), name in picks.items():
        args = cli.build_parser().parse_args(
            ["mosi", "--mode", mode, "--type", kind, "--missing",
             str(missing), "--zeros", str(zeros)])
        cfg = cli.trial_config(args)
        assert (cfg.model_type, cfg.missing, cfg.zeros) == (kind, missing,
                                                            zeros)
        assert cli.trainer_name(cfg) == name
    with pytest.raises(SystemExit, match="no trainer"):
        cli.trainer_name(MFMConfig(model_type="nope"))


# ------------------------------------------------------------- serving

def test_predictor_matches_jax_predictor():
    params = jax.tree.map(np.asarray, _params(CFG, seed=5))
    X = np.random.default_rng(6).normal(
        size=(11, CFG.seqlength, CFG.d_total)).astype(np.float32)
    want = JaxPredictor(CFG, params, model_type="missing",
                        batch_size=8).predict(X)
    got = Predictor(MFMConfig.from_dict(CFG.to_dict()), from_numpy(params),
                    model_type="missing", batch_size=8,
                    device="cpu").predict(X)
    assert got.shape == want.shape == (11,)
    np.testing.assert_allclose(got, want, **FWD)
