"""The port's variational MFM (``kl``) against the JAX package's on the
same parameters, inputs and random draws: the init tree, the eval
forward, the ``"joint"`` loss and its gradients (JAX on its Pallas
kernels in interpret mode and on its scan path), the trainer's route
(``cli.trainer_name``), a CPU training run through ``mosi --type kl``
and the Predictor.

Tolerances: forward rtol 2e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 2e-5 (as tests/test_pallas_mfn.py), float32; the y_hat-only
forward against the JAX Predictor rtol 1e-5 / atol 1e-6."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.models.mfm as jmfm
import factorized_tpu.ops.fused as jfused
from factorized_tpu import train as jtrain
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.ops import pallas_mfn
from factorized_tpu.serve import Predictor as JaxPredictor
from factorized_tpu_torch import cli, train
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import get_model, mfm
from factorized_tpu_torch.serve import Predictor
from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

FWD = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)
SERVE = dict(rtol=1e-5, atol=1e-6)

# the small config of tests/test_torch_train.py: every dropout site of
# best_acc_mosi_config active at its rate
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.5, att2_drop=0.5, gamma1_drop=0.5, gamma2_drop=0.5,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.2,
    za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7, fy_to_y_dropout=0.0,
    model_type="kl",
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


def _params(seed=0):
    return jmfm.mfm_kl_init(jax.random.PRNGKey(seed), CFG)


def _draws(key, t, n):
    """Every draw of JAX's joint loss on ``kl`` for ``key``: the loss
    splits key -> k1 (train.py), ``mfm_kl_apply`` splits k1 into 3: the
    encode's masks from k[0], the z->f masks from k[1] split once a site
    (the y head's rate is 0)."""
    k1 = jax.random.split(key)[0]
    k = jax.random.split(k1, 3)
    sizes = (CFG.att1_shape, CFG.att2_shape, CFG.gamma1_shape,
             CFG.gamma2_shape)
    drops = (CFG.att1_drop, CFG.att2_drop, CFG.gamma1_drop, CFG.gamma2_drop)
    encode = np.array(pallas_mfn.make_dropout_masks(k[0], t, n, sizes,
                                                    drops))
    rates = (CFG.zy_to_fy_dropout, CFG.zl_to_fl_dropout,
             CFG.za_to_fa_dropout, CFG.zv_to_fv_dropout)
    f_dims = (CFG.fy_size, CFG.fl_size, CFG.fa_size, CFG.fv_size)
    zf = []
    for kk, rate, f in zip(jax.random.split(k[1], 4), rates, f_dims):
        if rate <= 0.0:
            zf.append(None)
            continue
        keep = 1.0 - rate
        bern = np.array(jax.random.bernoulli(kk, keep, (n, f)))
        zf.append(torch.from_numpy(bern.astype(np.float32)
                                   * np.float32(1.0 / keep)))
    assert CFG.fy_to_y_dropout == 0.0
    return {"encode_masks": torch.from_numpy(encode), "zf_masks": zf}


def test_init_tree_and_registry_match_jax():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    ref = to_state_dict(jax.tree.map(np.asarray, _params()))
    port = to_state_dict(mfm.mfm_kl_init(torch.Generator().manual_seed(0),
                                         cfg))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert get_model("kl") == (mfm.mfm_kl_init, mfm.mfm_kl_apply)
    model = mfm.MFM(cfg, seed=1, device="cpu")
    assert model.model_type == "kl" and set(model.state_dict()) == set(ref)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
def test_eval_forward_matches_jax(use_pallas):
    params = _params()
    x = np.random.default_rng(1).normal(
        size=(6, 4, CFG.d_total)).astype(np.float32)
    apply_j = jax.jit(lambda p, x_: jmfm.mfm_kl_apply(
        p, x_, CFG, key=jax.random.PRNGKey(2), train=False))
    decoded_j, kld_j, _ = _with_pallas(
        use_pallas, lambda: apply_j(params, jnp.asarray(x)))
    with torch.no_grad():
        decoded_p, kld_p, missing = mfm.mfm_kl_apply(
            from_numpy(jax.tree.map(np.asarray, params)),
            torch.from_numpy(x), MFMConfig.from_dict(CFG.to_dict()))
    assert missing == 0.0 and len(decoded_p) == 4
    for p, j in zip(decoded_p, decoded_j):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **FWD)
    np.testing.assert_allclose(float(kld_p), float(kld_j), **FWD)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
def test_joint_loss_grads_match_jax(use_pallas):
    t, n = 6, 4
    params = _params()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(t, n, CFG.d_total)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    loss_j = jtrain.make_loss_fn(jmfm.mfm_kl_apply, CFG, "joint")
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, jnp.asarray(x), jnp.asarray(y), key),
        has_aux=True))
    (lj, tj), gj = _with_pallas(use_pallas, lambda: grad_fn(params))

    cfg = MFMConfig.from_dict(CFG.to_dict())
    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    loss_p = train.make_loss_fn(mfm.mfm_kl_apply, cfg, "joint")
    lp, tp = loss_p(tree, torch.from_numpy(x), torch.from_numpy(y),
                    draws=_draws(key, t, n))
    lp.backward()
    np.testing.assert_allclose(lp.item(), float(lj), **FWD)
    np.testing.assert_allclose(tp.item(), float(tj), **FWD)
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    assert set(flat_j) == set(flat)
    for name, leaf in flat.items():
        np.testing.assert_allclose(leaf.grad.numpy(), flat_j[name],
                                   err_msg=name, **GRAD)


def test_train_draws_come_from_the_generator():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    params = mfm.mfm_kl_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(5, 3, cfg.d_total)

    def run(seed):
        return mfm.mfm_kl_apply(
            params, x, cfg, train=True,
            generator=torch.Generator().manual_seed(seed))[0][0]

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="Generator"):
        mfm.mfm_kl_apply(params, x, cfg, train=True)
    # the eval forward draws nothing
    mfm.mfm_kl_apply(params, x, cfg)


def test_trainer_name_routes_kl_to_train_mfm():
    for mode in ("best", "single"):
        args = cli.build_parser().parse_args(
            ["mosi", "--mode", mode, "--type", "kl"])
        cfg = cli.trial_config(args)
        assert cfg.model_type == "kl"
        assert cli.trainer_name(cfg) == "train_mfm"


def test_mosi_cli_trains_kl_and_saves(tmp_path, monkeypatch, capsys):
    # best_acc_mosi_config at full width on a few random segments
    rng = np.random.default_rng(0)

    def data(n):
        return (rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))

    monkeypatch.setattr(cli, "load_mosi",
                        lambda t, **kw: (*data(40), *data(10), *data(12)))
    out = tmp_path / "runs"
    assert cli.main(["mosi", "--mode", "best", "--type", "kl",
                     "--epochs", "1", "--batchsize", "16", "--device", "cpu",
                     "--out", str(out), "--save-ckpt"]) == 0
    printed = capsys.readouterr().out
    assert "mae: " in printed and "checkpoint saved" in printed
    state, meta = restore_checkpoint(str(out / "ckpt_mosi_0"))
    assert meta["step"] == 1 and meta["config"]["model_type"] == "kl"
    assert "varhead" in state["params"]
    assert "last_to_logvarzy" in state["params"]
    kinds = [json.loads(line)["kind"] for line in
             (out / "mosi_0.jsonl").read_text().splitlines()]
    assert kinds == ["config", "epoch", "final"]
    y = Predictor.from_checkpoint(str(out / "ckpt_mosi_0"),
                                  device="cpu").predict(data(3)[0])
    assert y.shape == (3,) and np.isfinite(y).all()


def test_predictor_matches_jax_predictor():
    params = jax.tree.map(np.asarray, _params(seed=5))
    X = np.random.default_rng(6).normal(
        size=(11, CFG.seqlength, CFG.d_total)).astype(np.float32)
    want = JaxPredictor(CFG, params, batch_size=8).predict(X)
    got = Predictor(MFMConfig.from_dict(CFG.to_dict()), from_numpy(params),
                    batch_size=8, device="cpu").predict(X)
    assert got.shape == want.shape == (11,)
    np.testing.assert_allclose(got, want, **SERVE)
