"""The port's ablations ``m_a``..``m_d`` and the modular MFN against the
JAX package's on the same parameters, inputs and random draws.

- each ablation's init tree, its eval forward and its train forward with
  every draw injected (the MFN's dropout masks rebuilt from the JAX
  package's per-step keys, each MMD sample, each z->f and y-head mask),
  and the ``"joint"`` loss's gradients against ``jax.grad``;
- ``ops.mfn.mfn_apply`` (the encode with no encoder cell) against
  ``factorized_tpu.ops.mfn.mfn_apply``, eval and train, and its
  gradients;
- ``ops.fused.encode_operands`` for 0, 1 and 3 encoder cells, the
  ``mfm`` packing bit for bit as it was;
- each y_hat family's ``YHat`` (``"mfn"``: ``m_a``, ``m_c``; ``"trio"``:
  ``m_b``, ``m_d``) against the JAX apply's ``y_hat`` and the JAX
  ``Predictor``;
- ``mosi --type m_a..m_d`` and ``--zeros 1`` on the CPU.

The JAX ablations run the modular scan path (no Pallas kernel); the port
runs the fused kernels' plain versions. Tolerances: rtol 1e-5 / atol
1e-6, float32."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.models.ablations as jabl
from factorized_tpu import train as jtrain
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.ops import mfn as jmfn
from factorized_tpu.serve import Predictor as JaxPredictor
from factorized_tpu_torch import cli, train
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import ablations, get_model
from factorized_tpu_torch.models.common import mfn_drops
from factorized_tpu_torch.models.predict import FAMILIES, YHat, pack
from factorized_tpu_torch.ops import fused, mfn
from factorized_tpu_torch.serve import Predictor
from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

TOL = dict(rtol=1e-5, atol=1e-6)
TYPES = ("m_a", "m_b", "m_c", "m_d")

# the small config of tests/test_torch_train.py, every dropout site of
# the ablations active
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.5, att2_drop=0.5, gamma1_drop=0.0, gamma2_drop=0.5,
    zy_to_fy_dropout=0.2, zl_to_fl_dropout=0.2,
    za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7, fy_to_y_dropout=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(model_type):
    jcfg = CFG.replace(model_type=model_type)
    return jcfg, MFMConfig.from_dict(jcfg.to_dict())


def _jax_model(model_type):
    return (getattr(jabl, f"{model_type}_init"),
            getattr(jabl, f"{model_type}_apply"))


def _params(model_type, seed=0):
    jcfg, _ = _cfgs(model_type)
    return _jax_model(model_type)[0](jax.random.PRNGKey(seed), jcfg)


def _mask(key, rate, shape):
    """``core.dropout``'s scaled keep-mask for ``key``, or None at rate 0
    (the site is the identity)."""
    if rate <= 0.0:
        return None
    keep = 1.0 - rate
    bern = np.array(jax.random.bernoulli(key, keep, shape))
    return torch.from_numpy(bern.astype(np.float32) * np.float32(1.0 / keep))


def _mfn_masks(key, t, n, cfg=CFG):
    """The MFN's (t, n, att1 + att2 + gamma1 + gamma2) masks of the JAX
    scan path's draws: ``split(key, t * 4)`` reshaped (t, 4), site j of
    step i drawn from key (i, j) by ``core.dropout``; all ones at a rate-0
    site."""
    ks = jax.random.split(key, t * 4).reshape((t, 4, -1))
    sizes = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
             cfg.gamma2_shape)
    steps = []
    for i in range(t):
        sites = [_mask(ks[i, j], rate, (n, s))
                 for j, (s, rate) in enumerate(zip(sizes, mfn_drops(cfg)))]
        steps.append(torch.cat([torch.ones(n, s) if m is None else m
                                for m, s in zip(sites, sizes)], dim=1))
    return torch.stack(steps)


def _noise(key, d, n):
    return torch.from_numpy(np.array(jax.random.normal(key, (n, d))))


def _draws(model_type, key, t, n, train=True):
    """Every draw the JAX apply of ``model_type`` makes from ``key``, as
    the port's injected draws (eval: the MMD samples alone)."""
    c = CFG
    split = jax.random.split
    if model_type == "m_a":
        k = split(key, 5)
        km = split(k[1], 2)
        draws = {"mmd_noise": [_noise(km[0], c.zl_size, n),
                               _noise(km[1], c.zy_size, n)]}
        if train:
            draws.update(
                encode_masks=_mfn_masks(k[0], t, n),
                zf_masks=[_mask(k[2], c.zy_to_fy_dropout, (n, c.fy_size)),
                          _mask(k[3], c.zl_to_fl_dropout, (n, c.fl_size))],
                y_mask=_mask(k[4], c.fy_to_y_dropout, (n, c.fy_size)))
    elif model_type == "m_b":
        k = split(key, 5)
        km = split(k[0], 3)
        draws = {"mmd_noise": [_noise(km[0], c.zl_size, n),
                               _noise(km[1], c.za_size, n),
                               _noise(km[2], c.zv_size, n)]}
        if train:
            draws.update(
                zf_masks=[_mask(k[1], c.zl_to_fl_dropout, (n, c.fl_size)),
                          _mask(k[2], c.za_to_fa_dropout, (n, c.fa_size)),
                          _mask(k[3], c.zv_to_fv_dropout, (n, c.fv_size))],
                y_mask=_mask(k[4], c.fy_to_y_dropout, (n, c.fy_size)))
    elif model_type == "m_c":
        k = split(key, 4)
        draws = {"mmd_noise": [_noise(k[1], c.zy_size, n)]}
        if train:
            draws.update(
                encode_masks=_mfn_masks(k[0], t, n),
                zf_masks=[_mask(k[2], c.zy_to_fy_dropout, (n, c.fy_size))],
                y_mask=_mask(k[3], c.fy_to_y_dropout, (n, c.fy_size)))
    else:
        k = split(key, 3)
        draws = {}
        if train:
            draws["zf_masks"] = [
                _mask(k[0], c.zl_to_fl_dropout, (n, c.fl_size)),
                _mask(k[1], c.za_to_fa_dropout, (n, c.fa_size)),
                _mask(k[2], c.zv_to_fv_dropout, (n, c.fv_size))]
    return draws


def _x(t, n, seed):
    return np.random.default_rng(seed).normal(
        size=(t, n, CFG.d_total)).astype(np.float32)


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **TOL)


# ----------------------------------------------------------- the models

@pytest.mark.parametrize("model_type", TYPES)
def test_init_tree_and_registry_match_jax(model_type):
    _, cfg = _cfgs(model_type)
    ref = to_state_dict(jax.tree.map(np.asarray, _params(model_type)))
    init, apply_fn = get_model(model_type)
    port = to_state_dict(init(torch.Generator().manual_seed(0), cfg))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert (init, apply_fn) == (getattr(ablations, f"{model_type}_init"),
                                getattr(ablations, f"{model_type}_apply"))


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("model_type", TYPES)
def test_forward_matches_jax(model_type, train_mode):
    jcfg, cfg = _cfgs(model_type)
    t, n = 6, 4
    params = _params(model_type)
    x = _x(t, n, 1)
    key = jax.random.PRNGKey(2)
    decoded_j, reg_j, missing_j = _jax_model(model_type)[1](
        params, jnp.asarray(x), jcfg, key=key, train=train_mode)
    with torch.no_grad():
        decoded_p, reg_p, missing_p = get_model(model_type)[1](
            from_numpy(jax.tree.map(np.asarray, params)),
            torch.from_numpy(x), cfg, train=train_mode,
            **_draws(model_type, key, t, n, train_mode))
    assert missing_p == missing_j == 0.0 and len(decoded_p) == 4
    for k, (p, j) in enumerate(zip(decoded_p, decoded_j)):
        assert tuple(p.shape) == j.shape
        _close(p, j, f"decoded[{k}]")
    if model_type == "m_d":
        assert reg_p == reg_j == 0.0
    else:
        _close(reg_p, float(reg_j), "reg")


@pytest.mark.parametrize("model_type", TYPES)
def test_joint_loss_grads_match_jax(model_type):
    jcfg, cfg = _cfgs(model_type)
    t, n = 6, 4
    params = _params(model_type, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(t, n, CFG.d_total)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    loss_j = jtrain.make_loss_fn(_jax_model(model_type)[1], jcfg, "joint")
    (lj, tj), gj = jax.value_and_grad(
        lambda p: loss_j(p, jnp.asarray(x), jnp.asarray(y), key),
        has_aux=True)(params)

    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    loss_p = train.make_loss_fn(get_model(model_type)[1], cfg, "joint")
    # the JAX loss splits its key once and hands the first half to apply
    lp, tp = loss_p(tree, torch.from_numpy(x), torch.from_numpy(y),
                    draws=_draws(model_type, jax.random.split(key)[0], t, n))
    lp.backward()
    _close(lp, float(lj), "loss")
    _close(tp, float(tj), "tracked")
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    assert set(flat_j) == set(flat)
    for name, leaf in flat.items():
        grad = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        _close(grad, flat_j[name], name)


def test_train_draws_come_from_the_generator():
    _, cfg = _cfgs("m_a")
    params = ablations.m_a_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(5, 3, cfg.d_total)

    def run(seed):
        return ablations.m_a_apply(
            params, x, cfg, train=True,
            generator=torch.Generator().manual_seed(seed))[0][0]

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="Generator"):
        ablations.m_a_apply(params, x, cfg, train=True)
    # the eval forward draws the MMD samples alone; m_d draws nothing
    with pytest.raises(ValueError, match="mmd_noise"):
        ablations.m_c_apply(ablations.m_c_init(
            torch.Generator().manual_seed(0), cfg), x, cfg)
    ablations.m_d_apply(ablations.m_d_init(torch.Generator().manual_seed(0),
                                           cfg), x, cfg)


# ----------------------------------------------------------------- MFN

def _mfn_inputs(seed):
    t, n = 6, 5
    x = _x(t, n, seed)
    d_l, d_a, _ = CFG.input_dims
    return t, n, (x[..., :d_l], x[..., d_l:d_l + d_a], x[..., d_l + d_a:])


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_mfn_apply_matches_jax(train_mode):
    t, n, xs = _mfn_inputs(6)
    params = jabl.mfn_encoder_init(jax.random.PRNGKey(7), CFG)["mfn"]
    key = jax.random.PRNGKey(8)
    w = np.random.default_rng(9).normal(
        size=(n, CFG.last_mfn_size)).astype(np.float32)

    def objective(p):
        out = jmfn.mfn_apply(p, *map(jnp.asarray, xs), mem_dim=CFG.memsize,
                             drops=mfn_drops(CFG), key=key, train=train_mode)
        return jnp.sum(out * w), out

    (_, want), gj = jax.value_and_grad(objective, has_aux=True)(params)
    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    got = mfn.mfn_apply(tree, *map(torch.from_numpy, xs), mem_dim=CFG.memsize,
                        drops=mfn_drops(CFG), train=train_mode,
                        masks=_mfn_masks(key, t, n) if train_mode else None)
    assert tuple(got.shape) == (n, CFG.last_mfn_size)
    _close(got, want, "last_hs")
    (got * torch.from_numpy(w)).sum().backward()
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    for name, leaf in flat.items():
        _close(leaf.grad, flat_j[name], name)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_encode_operands_for_k_encoder_cells(k):
    t, n, (x_l, x_a, x_v) = _mfn_inputs(10)
    x_l, x_a, x_v = map(torch.from_numpy, (x_l, x_a, x_v))
    x = torch.cat([x_l, x_a, x_v], dim=2)
    g = torch.Generator().manual_seed(11)
    _, cfg = _cfgs("mfm")
    mfn_params = mfn.mfn_init(g, cfg.input_dims, cfg.h_dims, cfg.memsize,
                              cfg.windowsize, cfg.att1_shape,
                              cfg.att2_shape, cfg.gamma1_shape,
                              cfg.gamma2_shape)
    from factorized_tpu_torch.ops.lstm import lstm_cell_init
    if k == 3:
        enc = [lstm_cell_init(g, d, h) for d, h in
               zip(cfg.input_dims, (cfg.zl_size, cfg.za_size, cfg.zv_size))]
        enc_xs = None
        inputs = [x_l, x_a, x_v]
    elif k == 1:
        enc, enc_xs = [lstm_cell_init(g, cfg.d_total, cfg.zl_size)], (x,)
        inputs = [x]
    else:
        enc, enc_xs, inputs = [], (), []
    xp, weights, z_tot, h_dims = fused.encode_operands(
        enc, mfn_params, x_l, x_a, x_v, enc_xs)
    cells = enc + [mfn_params[c] for c in ("lstm_l", "lstm_a", "lstm_v")]
    assert h_dims == [c["wh"].shape[0] for c in cells]
    assert z_tot == sum(h_dims[:k])
    # the packing as it was for mfm's three encoders: each cell's hoisted
    # projection repacked gate-major, the weights of encode_weights
    want = fused.repack_gate_major(
        [fused.hoist_xproj(c, xi) for c, xi in
         zip(cells, inputs + [x_l, x_a, x_v])], h_dims)
    assert torch.equal(xp, want)
    for name, wgt in fused.encode_weights(cells, mfn_params).items():
        assert torch.equal(weights[name], wgt), name
    # the serving packing: one input product over the rows each cell reads
    d_l, d_a, d_v = cfg.input_dims
    spans = [(0, d_l), (d_l, d_l + d_a), (d_l + d_a, cfg.d_total)]
    rows = {3: spans, 1: [(0, cfg.d_total)], 0: []}[k] + spans
    wx, bx = fused.input_projection(cells, rows, cfg.d_total)
    torch.testing.assert_close(
        (x.reshape(t * n, -1) @ wx + bx).reshape(t, n, -1), xp, **TOL)
    with pytest.raises(ValueError, match="inputs"):
        fused.encode_operands(enc, mfn_params, x_l, x_a, x_v,
                              enc_xs=[x] * (k + 1))


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("model_type", TYPES)
def test_yhat_matches_the_jax_apply_and_predictor(model_type):
    jcfg, cfg = _cfgs(model_type)
    params = jax.tree.map(np.asarray, _params(model_type, seed=12))
    x = _x(6, 7, 13)
    decoded, _, _ = _jax_model(model_type)[1](
        params, jnp.asarray(x), jcfg, key=jax.random.PRNGKey(0), train=False)
    got = YHat(cfg, from_numpy(params), model_type)(torch.from_numpy(x))
    assert FAMILIES[model_type] == ("mfn" if model_type in ("m_a", "m_c")
                                    else "trio")
    _close(got, np.asarray(decoded[3])[:, 0], "y_hat")
    X = np.ascontiguousarray(x.swapaxes(0, 1))
    want = JaxPredictor(jcfg, params, batch_size=4).predict(X)
    served = Predictor(cfg, from_numpy(params), batch_size=4,
                       device="cpu").predict(X)
    assert served.shape == want.shape == (7,)
    _close(served, want, "predict")


def test_yhat_of_the_mfn_family_packs_no_encoder_cell():
    _, cfg = _cfgs("m_a")
    params = ablations.m_a_init(torch.Generator().manual_seed(14), cfg)
    ops, h_dims, z_tot = pack(params, cfg, "m_a")
    assert h_dims == list(cfg.h_dims) and z_tot == 0
    assert ops["wx"].shape == (cfg.d_total, 4 * sum(cfg.h_dims))
    # m_d's head is one linear map
    ops, h_dims, _ = pack(ablations.m_d_init(
        torch.Generator().manual_seed(15), cfg), cfg, "m_d")
    assert h_dims == [cfg.zl_size, cfg.za_size, cfg.zv_size]
    assert "y1w" not in ops and "zyw" not in ops


# -------------------------------------------------------- command line

def _mosi_data(monkeypatch):
    # best_acc_mosi_config at full width on a few random segments
    rng = np.random.default_rng(0)

    def data(n):
        return (rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))

    monkeypatch.setattr(cli, "load_mosi",
                        lambda t, **kw: (*data(24), *data(8), *data(8)))


@pytest.mark.parametrize("model_type", TYPES)
def test_mosi_cli_trains_an_ablation_and_serves_it(model_type, tmp_path,
                                                   monkeypatch, capsys):
    _mosi_data(monkeypatch)
    out = tmp_path / "runs"
    argv = ["mosi", "--mode", "best", "--type", model_type, "--epochs", "1",
            "--batchsize", "8", "--device", "cpu", "--out", str(out),
            "--save-ckpt"]
    assert cli.trainer_name(cli.mosi_config(
        cli.build_parser().parse_args(argv))) == "train_mfm_ablation"
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "mae: " in printed and "checkpoint saved" in printed
    ckpt = str(out / "ckpt_mosi_0")
    state, meta = restore_checkpoint(ckpt)
    assert meta["step"] == 1 and meta["config"]["model_type"] == model_type
    kinds = [json.loads(line)["kind"] for line in
             (out / "mosi_0.jsonl").read_text().splitlines()]
    assert kinds == ["config", "epoch", "final"]
    assert cli.main(["test_mosi", "--checkpoint", ckpt, "--device",
                     "cpu"]) == 0
    assert "mae: " in capsys.readouterr().out
    y = Predictor.from_checkpoint(ckpt, device="cpu").predict(
        np.random.default_rng(1).normal(size=(3, 20, 325)).astype(
            np.float32))
    assert y.shape == (3,) and np.isfinite(y).all()


def test_mosi_cli_zeros_scores_three_ways(tmp_path, monkeypatch, capsys):
    _mosi_data(monkeypatch)
    out = tmp_path / "runs"
    argv = ["mosi", "--mode", "best", "--zeros", "1", "--epochs", "2",
            "--batchsize", "8", "--device", "cpu", "--out", str(out)]
    assert cli.trainer_name(cli.mosi_config(
        cli.build_parser().parse_args(argv))) == "train_mfm_test_zeros"
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert [line.split()[1] for line in printed.splitlines()
            if line.startswith("scoring")] == ["y_hat_nol", "y_hat_noa",
                                               "y_hat_nov"]
    records = [json.loads(line) for line in
               (out / "mosi_0.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in records] == ["config", "epoch", "epoch",
                                            "final"]
    final = records[-1]
    for tag in ("y_hat_nol", "y_hat_noa", "y_hat_nov"):
        assert np.isfinite(final[tag]["mae"]), tag


def test_zeros_trainer_scores_the_zeroed_test_sets(monkeypatch):
    """Each score is the best parameters' y_hat with one modality's slice
    of the test set zeroed, and the three differ."""
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.utils.logging import RunLogger
    from factorized_tpu_torch.utils.metrics import score_regression

    _, cfg = _cfgs("mfm")
    cfg = cfg.replace(batchsize=8, num_epochs=2)
    rng = np.random.default_rng(16)

    def data(n):
        X = rng.normal(size=(n, 6, 17)).astype(np.float32)
        return X, X[:, -1, :3].sum(1).astype(np.float32)

    sets = (*data(24), *data(8), *data(10))
    res = trainers.train_mfm_test_zeros(*sets, cfg, seed=3, device="cpu",
                                        logger=RunLogger(echo=False))
    assert list(res["metrics"]) == ["y_hat_nol", "y_hat_noa", "y_hat_nov"]
    assert res["step"] == 2 and len(res["history"]) == 2
    X_test = sets[4]
    d_l, d_a, _ = cfg.input_dims
    for tag, (lo, hi) in (("y_hat_nol", (0, d_l)),
                          ("y_hat_noa", (d_l, d_l + d_a)),
                          ("y_hat_nov", (d_l + d_a, 17))):
        X = X_test.copy()
        X[..., lo:hi] = 0.0
        y = Predictor(cfg, res["params"], device="cpu").predict(X)
        assert score_regression(y, sets[5], out=io.StringIO()) == \
            res["metrics"][tag], tag
    assert len({m["mae"] for m in res["metrics"].values()}) == 3
