"""The port's training path against the JAX package's on the same
parameters, inputs and random draws: the joint loss and its gradients
through the whole MFM (JAX on its Pallas kernels in interpret mode and on
its scan path), Adam, the host-side copies (batching, the synthetic MOSI
set, the scheduler, the best-keeper, the losses and the score), the
trainer and the ``mosi`` command line.

Tolerances: forward rtol 2e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 2e-5 (as tests/test_pallas_mfn.py), float32."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import factorized_tpu.models.mfm as jmfm
import factorized_tpu.ops.fused as jfused
from factorized_tpu import train as jtrain
from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import best_acc_mosi_config as jax_best
from factorized_tpu.data import batcher as jbatcher
from factorized_tpu.data import mosi as jmosi
from factorized_tpu.ops import losses as jlosses
from factorized_tpu.ops import pallas_mfn
from factorized_tpu.utils import checkpoint as jcheckpoint
from factorized_tpu.utils import metrics as jmetrics
from factorized_tpu.utils.scheduler import ReduceLROnPlateau as JaxPlateau
from factorized_tpu_torch import cli, train, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.data import batcher, mosi
from factorized_tpu_torch.models import mfm
from factorized_tpu_torch.ops import losses
from factorized_tpu_torch.utils import metrics
from factorized_tpu_torch.utils.checkpoint import (BestKeeper,
                                                   restore_checkpoint)
from factorized_tpu_torch.utils.scheduler import ReduceLROnPlateau

FWD = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)

# the small config of tests/test_torch_mfm.py with every dropout site of
# best_acc_mosi_config active at its rate
CFG = JaxConfig(
    input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.5, att2_drop=0.5, gamma1_drop=0.5, gamma2_drop=0.5,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.2,
    za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7, fy_to_y_dropout=0.0,
)
RESULT_KEYS = {"metrics", "params", "opt_state", "history", "best_valid",
               "step"}  # factorized_tpu/trainers.py train_mfm's return


def _with_pallas(flag, fn):
    old = jfused.USE_PALLAS
    jfused.USE_PALLAS = flag
    try:
        return fn()
    finally:
        jfused.USE_PALLAS = old


def _draws(jcfg, key, t, n):
    """Every draw of JAX's joint loss for ``key``, as numpy: the loss
    splits key -> k1 (train.py), mfm_apply splits k1 into 4."""
    k1 = jax.random.split(key)[0]
    k = jax.random.split(k1, 4)
    sizes = (jcfg.att1_shape, jcfg.att2_shape, jcfg.gamma1_shape,
             jcfg.gamma2_shape)
    drops = (jcfg.att1_drop, jcfg.att2_drop, jcfg.gamma1_drop,
             jcfg.gamma2_drop)
    encode = np.array(pallas_mfn.make_dropout_masks(k[0], t, n, sizes,
                                                    drops))
    dmax = max(jcfg.zl_size, jcfg.za_size, jcfg.zv_size, jcfg.zy_size)
    noise = np.array(jax.random.normal(k[1], (4, n, dmax), jnp.float32))
    rates = (jcfg.zy_to_fy_dropout, jcfg.zl_to_fl_dropout,
             jcfg.za_to_fa_dropout, jcfg.zv_to_fv_dropout)
    f_dims = (jcfg.fy_size, jcfg.fl_size, jcfg.fa_size, jcfg.fv_size)
    zk = jax.random.split(k[2], 4)
    zf = []
    for kk, rate, f in zip(zk, rates, f_dims):
        if rate <= 0.0:
            zf.append(None)
            continue
        keep = 1.0 - rate
        bern = np.array(jax.random.bernoulli(kk, keep, (n, f)))
        zf.append(bern.astype(np.float32) * np.float32(1.0 / keep))
    return {"encode_masks": torch.from_numpy(encode),
            "mmd_noise": torch.from_numpy(noise),
            "zf_masks": [None if m is None else torch.from_numpy(m)
                         for m in zf]}


def _grads_match(jcfg, t, n, use_pallas):
    assert jmfm.fused_active(jcfg)
    params = jmfm.mfm_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(t, n, jcfg.d_total)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    loss_j = jtrain.make_loss_fn(jmfm.mfm_apply, jcfg, "joint")
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, jnp.asarray(x), jnp.asarray(y), key),
        has_aux=True))
    (lj, tj), gj = _with_pallas(use_pallas, lambda: grad_fn(params))

    cfg = MFMConfig.from_dict(jcfg.to_dict())
    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    loss_p = train.make_loss_fn(mfm.mfm_apply, cfg, "joint")
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


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas", "scan"])
def test_joint_loss_grads_match_jax(use_pallas):
    _grads_match(CFG, t=6, n=4, use_pallas=use_pallas)


def test_joint_loss_grads_match_jax_at_full_width():
    # best_acc_mosi_config widths and rates, t = 20, n = 4, the scan path
    _grads_match(jax_best(), t=20, n=4, use_pallas=False)


def test_train_draws_come_from_the_generator():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    params = mfm.mfm_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(5, 3, cfg.d_total, generator=torch.Generator()
                    .manual_seed(1))

    def run(seed):
        return mfm.mfm_apply(params, x, cfg, train=True,
                             generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0][0], c[0][0])
    with pytest.raises(ValueError, match="Generator"):
        mfm.mfm_apply(params, x, cfg, train=True)


# ------------------------------------------------------------------ Adam

def test_adam_matches_optax_scale_by_adam():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [{"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
             for _ in range(3)]
    lrs = (1e-3, 1e-3, 1e-4)  # a scheduler step between steps 2 and 3

    opt = optax.scale_by_adam(eps=1e-8)
    pj = jax.tree.map(jnp.asarray, p0)
    state = opt.init(pj)
    for g, lr in zip(grads, lrs):
        u, state = opt.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = jax.tree.map(lambda p, u_: p - lr * u_, pj, u)

    tree = from_numpy(p0)
    optimizer = train.make_optimizer(tree, lrs[0])
    for g, lr in zip(grads, lrs):
        # each leaf's grad is a view of the flat Adam's gradient buffer
        for leaf, gl in zip(train.leaves(tree), train.leaves(from_numpy(g))):
            leaf.grad.copy_(gl)
        optimizer.set_lr(lr)
        optimizer.step()
    for a, b in zip(train.leaves(tree), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- host-side copies

@pytest.mark.parametrize("include_remainder", [False, True])
def test_batching_copies_match_jax(include_remainder):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(37, 6, 5)).astype(np.float32)
    y = rng.normal(size=(37,)).astype(np.float32)
    Xt, yt = train.shuffle_and_time_major(X, y, 123)
    Xj, yj = jtrain.shuffle_and_time_major(X, y, 123)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    got = train.make_batches(Xt, yt, 8, include_remainder)
    want = jtrain.make_batches(Xj, yj, 8, include_remainder)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[2] is None) == (want[2] is None) == (not include_remainder)
    if include_remainder:
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceeds"):
        train.make_batches(Xt, yt, 64, False)


def test_synthetic_mosi_matches_jax():
    got, want = mosi.get_data(), jmosi.get_data()
    assert [a.shape for a in got] == [a.shape for a in want]
    assert got[0].shape == (624, 20, 325) and got[4].shape == (686, 20, 325)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).normal(size=(4, 3, 5)).astype(np.float32)
    x[..., 2] = 0.0
    np.testing.assert_array_equal(batcher.compute_train_max(x),
                                  jbatcher.compute_train_max(x))


def test_plateau_scheduler_matches_jax():
    metrics_seq = [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.89991, 0.9, 0.95,
                   0.8, 0.85, 0.86, 0.87, 0.88, 0.8, 0.7]
    port = ReduceLROnPlateau(1e-3, patience=2, cooldown=1)
    ref = JaxPlateau(1e-3, patience=2, cooldown=1)
    lrs = []
    for m in metrics_seq:
        lrs.append(port.step(m))
        assert lrs[-1] == ref.step(m)
        assert (port.best, port.num_bad_epochs, port.cooldown_counter) == \
            (ref.best, ref.num_bad_epochs, ref.cooldown_counter)
    assert min(lrs) < 1e-3  # the schedule did reduce


def test_best_keeper_matches_jax():
    seq = [3.0, 2.0, 2.0, 2.5, 1.0, 1.0]
    port, ref = BestKeeper("min"), jcheckpoint.BestKeeper("min")
    for epoch, m in enumerate(seq):
        params = {"w": torch.full((2,), float(epoch))}
        assert port.update(m, params, epoch) == ref.update(
            m, {"w": np.full((2,), float(epoch))}, epoch)
        assert (port.best, port.best_epoch) == (ref.best, ref.best_epoch)
    assert port.best_params["w"].device.type == "cpu"
    assert float(port.best_params["w"][0]) == 5.0  # ties replace


def test_score_regression_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=50).astype(np.float32) * 2
    y = rng.normal(size=50).astype(np.float32) * 2
    for threshold, mode in ((0.0, "ge"), (0.5, "gt")):
        out_p, out_j = io.StringIO(), io.StringIO()
        got = metrics.score_regression(pred, y, threshold, mode, out=out_p)
        want = jmetrics.score_regression(pred, y, threshold, mode, out=out_j)
        assert got == want
        assert out_p.getvalue() == out_j.getvalue()
    bad = pred.copy()
    bad[0] = np.nan
    got = metrics.score_regression(bad, y, out=io.StringIO())
    assert set(got) == set(jmetrics.score_regression(bad, y,
                                                     out=io.StringIO()))
    assert all(np.isnan(v) for v in got.values())


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    z = rng.normal(size=(7, 5)).astype(np.float32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), (6, 5)))
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    np.testing.assert_allclose(losses.compute_kernel(tx, tz).numpy(),
                               jlosses.compute_kernel(x, z), **FWD)
    np.testing.assert_allclose(
        float(losses.loss_mmd(tx, noise=torch.from_numpy(noise))),
        float(jlosses.loss_mmd(jax.random.PRNGKey(0), jnp.asarray(x))),
        **FWD)
    np.testing.assert_allclose(float(losses.loss_kld(tx, tz[:6])),
                               float(jlosses.loss_kld(x, z[:6])), **FWD)
    np.testing.assert_allclose(float(losses.l1_loss(tx, tz[:6])),
                               float(jlosses.l1_loss(x, z[:6])), **FWD)
    np.testing.assert_allclose(float(losses.l2_loss(tx, tz[:6])),
                               float(jlosses.l2_loss(x, z[:6])), **FWD)
    labels = np.array([0, 4, 2, 1, 3, 0], np.int32)
    np.testing.assert_allclose(
        float(losses.cross_entropy_loss(tx, torch.from_numpy(labels))),
        float(jlosses.cross_entropy_loss(x, labels)), **FWD)
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(losses.loss_mmd(tx, generator=g))


# -------------------------------------------------------------- trainer

def _small_data(seed, n_train=70, n_valid=20, n_test=24, t=6, d=17):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, t, d)).astype(np.float32)
        return X, (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)).astype(
            np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def test_train_mfm_two_epochs_on_cpu(tmp_path):
    from factorized_tpu_torch.utils.logging import RunLogger

    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(
        seqlength=6, batchsize=16, num_epochs=2)
    logger = RunLogger(str(tmp_path), run_id="run", echo=False)
    res = trainers.train_mfm(*_small_data(0), cfg, logger=logger, seed=3,
                             device="cpu")
    logger.close()
    assert set(res) == RESULT_KEYS
    assert len(res["history"]) == 2 and res["step"] == 2
    for e in res["history"]:
        assert np.isfinite(e["train_loss"]) and np.isfinite(e["valid"])
        # the chunked loop records the float32 lr, as the JAX package's
        assert e["lr"] == float(np.float32(1e-3))
    assert set(res["metrics"]) == set(jmetrics.regression_metrics(
        np.ones(3), np.arange(3.0)))
    assert res["best_valid"] == min(e["valid"] for e in res["history"])
    assert set(to_state_dict(res["params"])) == set(to_state_dict(
        jax.tree.map(np.asarray, jmfm.mfm_init(jax.random.PRNGKey(0), CFG))))
    assert res["opt_state"]["state"]  # Adam's moments after 8 steps
    kinds = [json.loads(line)["kind"]
             for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    assert kinds == ["epoch", "epoch", "final"]
    # the same seed gives the same run
    again = trainers.train_mfm(*_small_data(0), cfg, seed=3, device="cpu",
                               logger=RunLogger(echo=False))
    assert [e["train_loss"] for e in again["history"]] == \
        [e["train_loss"] for e in res["history"]]


def test_train_mfm_breaks_on_divergence(monkeypatch):
    from factorized_tpu_torch.utils.logging import RunLogger

    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(
        seqlength=6, batchsize=32, num_epochs=3)
    monkeypatch.setattr(train.TrainProgram, "evaluate",
                        lambda self, *a: torch.tensor(float("nan")))
    res = trainers.train_mfm(*_small_data(1), cfg, seed=0, device="cpu",
                             logger=RunLogger(echo=False))
    assert len(res["history"]) == 1 and res["history"][0]["diverged"]
    assert res["step"] == 0 and res["best_valid"] == float("inf")
    with pytest.raises(ValueError, match="cannot train model type 's2s'"):
        trainers.train_mfm(*_small_data(1), cfg.replace(model_type="s2s"),
                           device="cpu", logger=RunLogger(echo=False))


def test_result_keys_are_the_jax_trainers():
    src = open(jtrainers.__file__).read()
    body = src[src.index("def train_mfm("):src.index("def train_beta_vae(")]
    for key in RESULT_KEYS:
        assert f'"{key}"' in body


# ---------------------------------------------------------- command line

def test_mosi_cli_trains_and_saves(tmp_path, monkeypatch, capsys):
    # best_acc_mosi_config at full width on a few random segments
    rng = np.random.default_rng(0)

    def data(n):
        return (rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))

    monkeypatch.setattr(cli, "load_mosi",
                        lambda t, **kw: (*data(40), *data(10), *data(12)))
    out = tmp_path / "runs"
    assert cli.main(["mosi", "--mode", "best", "--epochs", "1",
                     "--batchsize", "16", "--device", "cpu", "--out",
                     str(out), "--save-ckpt"]) == 0
    printed = capsys.readouterr().out
    assert "mae: " in printed and "checkpoint saved" in printed
    state, meta = restore_checkpoint(str(out / "ckpt_mosi_0"))
    assert meta["step"] == 1 and meta["has_opt_state"]
    assert meta["config"]["batchsize"] == 16
    assert meta["config"]["h_dims"] == [88, 64, 48]
    assert state["opt_state"]["state"]
    kinds = [json.loads(line)["kind"] for line in
             (out / "mosi_0.jsonl").read_text().splitlines()]
    assert kinds == ["config", "epoch", "final"]


# the two search strategies of the JAX package's parallel/multiconfig.py
# on the mosi command, with lanes of seeds too: each reaches its trainer
# with the lanes, the --lr and the threshold of the JAX command
@pytest.mark.parametrize("argv", [["--seeds", "2", "--mode", "search",
                                   "--bucket"],
                                  ["--mode", "search", "--bucket"],
                                  ["--mode", "search", "--evolve", "2"]])
def test_mosi_cli_refuses_what_is_not_ported(argv, monkeypatch, tmp_path):
    from factorized_tpu_torch.parallel import multiconfig

    calls = []

    def train(*a, **kw):
        calls.append((a[6], kw))
        if "--bucket" in argv:
            return {"results": []}
        return {"explored_configs": 2, "best": {"metrics": {}, "rung": 1}}

    name = ("train_config_bucket" if "--bucket" in argv
            else "train_evolving_search")
    rng = np.random.default_rng(1)

    def data(n):
        return (rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))

    monkeypatch.setattr(multiconfig, name, train)
    monkeypatch.setattr(cli, "load_mosi", lambda t, **kw: (
        *data(40), *data(10), *data(12)))
    assert cli.main(["mosi", "--device", "cpu", "--trials", "2", "--epochs",
                     "1", "--lr", "0.002", "--out", str(tmp_path)] + argv) \
        == 0
    assert calls
    for cfgs, kw in calls:
        assert kw["seeds_per_config"] == (2 if "--seeds" in argv else 1)
        assert kw["lr"] == 0.002 and "use_config_lr" not in kw
        assert (kw["binary_threshold"], kw["threshold_mode"]) == (0.0, "ge")
    if "--evolve" in argv:
        assert calls[0][1]["rungs"] == 2 and calls[0][1]["n_configs"] == 2


def test_mosi_cli_configs():
    args = cli.build_parser().parse_args(["mosi", "--mode", "single"])
    cfg = cli.trial_config(args)
    assert cfg.to_dict() == MFMConfig(seqlength=20).replace(
        input_dims=[300, 5, 20]).to_dict()
    args = cli.build_parser().parse_args(
        ["mosi", "--mode", "best", "--epochs", "3", "--batchsize", "8"])
    cfg = cli.trial_config(args)
    assert (cfg.num_epochs, cfg.batchsize) == (3, 8)
    assert cfg.to_dict() == MFMConfig.from_dict(jax_best().to_dict()).replace(
        num_epochs=3, batchsize=8).to_dict()
