"""The port's modular path (``models/mfm.py::FUSED`` = False: the encoders'
and decoders' own recurrences, ``ops/lstm.py``, and the modular MFN,
``ops/mfn.py::mfn_scan``) against the JAX package's modular path (its
``mfm.FUSED`` = False, set and restored here as tests/test_fused.py does)
and against the port's fused path, for ``mfm``, ``kl``, ``kl_ef`` and
``missing``: eval outputs, the train loss and its gradients, on the same
parameters, inputs and draws (the JAX modular MFN's per-step dropout
masks rebuilt from its keys); the gate (``_step_flops_estimate``,
``fused_active``) against the JAX package's; the modular MFN under
``torch.func.vmap`` with a lane's tensor rate; serving through the gate.

Tolerance rtol 2e-4 / atol 1e-5 (tests/test_torch_mfm.py), float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.models.mfm as jmfm
from factorized_tpu import train as jtrain
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import best_acc_mosi_config as jax_best
from factorized_tpu_torch import benchprog
from factorized_tpu_torch.config import MFMConfig, best_acc_mosi_config
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import get_model, mfm, predict
from factorized_tpu_torch.ops import cuda_mfn
from factorized_tpu_torch.ops.mfn import mfn_scan
from factorized_tpu_torch.serve import Predictor
from factorized_tpu_torch.train import make_loss_fn

TOL = dict(rtol=2e-4, atol=1e-5)
DROPS = ("att1_drop", "att2_drop", "gamma1_drop", "gamma2_drop")

CFG = JaxConfig(
    input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=7, gamma1_shape=6, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0,
    za_to_fa_dropout=0.0, zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0,
)
# the att and gamma dropouts at best_acc_mosi_config's rates
CFG_DROP = CFG.replace(**{k: getattr(jax_best(), k) for k in DROPS})
# model type -> (the loss's composition, its stage, the apply's subkeys,
# the index of the MMD Gaussian's key among them or None)
MODELS = {"mfm": ("joint", 0, 4, 1), "kl": ("joint", 0, 3, None),
          "kl_ef": ("beta_vae", 1, 2, None),
          "missing": ("missing", 0, 6, 1)}
T, N = 5, 3


@pytest.fixture
def jax_modular():
    saved = jmfm.FUSED
    jmfm.FUSED = False
    yield
    jmfm.FUSED = saved


@pytest.fixture
def port_gate():
    saved = mfm.FUSED
    yield
    mfm.FUSED = saved


def _jax_model(name):
    return {"mfm": (jmfm.mfm_init, jmfm.mfm_apply),
            "kl": (jmfm.mfm_kl_init, jmfm.mfm_kl_apply),
            "kl_ef": (jmfm.mfm_kl_ef_init, jmfm.mfm_kl_ef_apply),
            "missing": (jmfm.mfm_missing_init,
                        jmfm.mfm_missing_apply)}[name]


def _cfg(jcfg, name):
    return jcfg.replace(missing=1) if name == "missing" else jcfg


def modular_masks(jcfg, key, t, n):
    """The dropout masks of the JAX modular MFN for ``key`` as the port's
    (t, n, att1 + att2 + gamma1 + gamma2): each step's four sites drawn
    from ``jax.random.split(key, t * 4)`` (``factorized_tpu/ops/mfn.py``)."""
    ks = jax.random.split(key, t * 4).reshape(t, 4, -1)
    widths = (jcfg.att1_shape, jcfg.att2_shape, jcfg.gamma1_shape,
              jcfg.gamma2_shape)
    steps = []
    for s in range(t):
        sites = []
        for i, (w, name) in enumerate(zip(widths, DROPS)):
            rate = getattr(jcfg, name)
            if rate <= 0.0:
                sites.append(np.ones((n, w), np.float32))
                continue
            keep = 1.0 - rate
            bern = np.array(jax.random.bernoulli(ks[s, i], keep, (n, w)))
            sites.append(bern.astype(np.float32) * np.float32(1.0 / keep))
        steps.append(np.concatenate(sites, axis=1))
    return torch.from_numpy(np.stack(steps))


def _draws(jcfg, name, key, t, n):
    """The port's injected draws for the JAX loss's ``key`` (the loss
    splits key -> k1, the apply splits k1 into its subkeys; the z->f and y
    rates are 0 here)."""
    _, _, nk, mmd_at = MODELS[name]
    k = jax.random.split(jax.random.split(key)[0], nk)
    draws = {}
    if name != "kl_ef":
        draws["encode_masks"] = modular_masks(jcfg, k[0], t, n)
    if mmd_at is not None:
        dmax = max(jcfg.zl_size, jcfg.za_size, jcfg.zv_size, jcfg.zy_size)
        draws["mmd_noise"] = torch.from_numpy(np.array(
            jax.random.normal(k[mmd_at], (4, n, dmax), jnp.float32)))
    return draws


def _data(jcfg, t, n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, n, jcfg.d_total)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _port_grads(name, cfg, tree, x, y, **kw):
    variant, stage, _, _ = MODELS[name]
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    loss, tracked = make_loss_fn(get_model(name)[1], cfg, variant, stage)(
        tree, torch.from_numpy(x), torch.from_numpy(y), **kw)
    loss.backward()
    return loss.item(), tracked.item(), {
        k: (v.grad if v.grad is not None else torch.zeros_like(v)).numpy()
        for k, v in flat.items()}


def _against_jax(jcfg, name):
    jcfg = _cfg(jcfg, name)
    init, apply_j = _jax_model(name)
    variant, stage, _, _ = MODELS[name]
    params = init(jax.random.PRNGKey(0), jcfg)
    x, y = _data(jcfg, T, N)
    key = jax.random.PRNGKey(2)
    loss_j = jtrain.make_loss_fn(apply_j, jcfg, variant, stage)
    grad_fn = jax.value_and_grad(
        lambda p: loss_j(p, jnp.asarray(x), jnp.asarray(y), key),
        has_aux=True)
    # the train loss with its gradients and the eval forward, one program
    ((lj, tj), gj), out_j = jax.jit(lambda p: (grad_fn(p), apply_j(
        p, jnp.asarray(x), jcfg, key=key, train=False)))(params)

    cfg = MFMConfig.from_dict(jcfg.to_dict())
    mfm.FUSED = False
    tree = from_numpy(jax.tree.map(np.asarray, params))
    lp, tp, gp = _port_grads(name, cfg, tree, x, y,
                             draws=_draws(jcfg, name, key, T, N))
    np.testing.assert_allclose(lp, float(lj), **TOL)
    np.testing.assert_allclose(tp, float(tj), **TOL)
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    assert set(flat_j) == set(gp)
    for k, g in gp.items():
        np.testing.assert_allclose(g, flat_j[k], err_msg=k, **TOL)

    # the eval forward, every output
    kw = {}
    if MODELS[name][3] is not None:
        k = jax.random.split(key, MODELS[name][2])[MODELS[name][3]]
        dmax = max(jcfg.zl_size, jcfg.za_size, jcfg.zv_size, jcfg.zy_size)
        kw["mmd_noise"] = torch.from_numpy(np.array(
            jax.random.normal(k, (4, N, dmax), jnp.float32)))
    with torch.no_grad():
        out_p = get_model(name)[1](from_numpy(jax.tree.map(np.asarray,
                                                           params)),
                                   torch.from_numpy(x), cfg, **kw)
    leaves_j = jax.tree.leaves(out_j)
    leaves_p = torch.utils._pytree.tree_leaves(out_p)
    assert len(leaves_j) == len(leaves_p)
    for a, b in zip(leaves_p, leaves_j):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_modular_matches_the_jax_modular_path(name, jax_modular, port_gate):
    _against_jax(CFG, name)


def test_modular_dropout_masks_match_the_jax_keys(jax_modular, port_gate):
    assert all(getattr(CFG_DROP, k) > 0 for k in DROPS)
    _against_jax(CFG_DROP, "mfm")


@pytest.mark.parametrize("name", list(MODELS))
def test_modular_matches_fused(name, port_gate):
    # the same generator gives both paths the same draws: every dropout
    # site of best_acc_mosi_config active
    cfg = _cfg(MFMConfig.from_dict(CFG.to_dict()).replace(
        **{k: getattr(best_acc_mosi_config(), k)
           for k in (*DROPS, "zl_to_fl_dropout", "za_to_fa_dropout",
                     "zv_to_fv_dropout")}), name)
    x, y = _data(cfg, T, N, seed=3)
    init = get_model(name)[0]
    out = []
    for fused in (True, False):
        mfm.FUSED = fused
        tree = init(torch.Generator().manual_seed(0), cfg)
        out.append(_port_grads(name, cfg, tree, x, y,
                               generator=torch.Generator().manual_seed(4)))
    (lf, tf, gf), (lm, tm, gm) = out
    np.testing.assert_allclose(lm, lf, **TOL)
    np.testing.assert_allclose(tm, tf, **TOL)
    for k in gf:
        np.testing.assert_allclose(gm[k], gf[k], err_msg=k, **TOL)


def test_step_flops_estimate_equals_the_jax_package():
    # best_acc_mosi_config, the scale probe's A to E and scale_cfg (their
    # fields equal the JAX package's: tests/test_torch_benchprog.py)
    cfgs = [best_acc_mosi_config(), *benchprog.scale_candidates().values(),
            benchprog.scale_cfg()]
    assert len(cfgs) == 7
    for cfg in cfgs:
        assert mfm._step_flops_estimate(cfg) == jmfm._step_flops_estimate(
            JaxConfig(**cfg.to_dict())) > 0


def test_the_gate(port_gate):
    small, scale = best_acc_mosi_config(), benchprog.scale_cfg()
    assert mfm.FUSED == "auto"
    assert mfm._step_flops_estimate(small) < mfm._FUSED_FLOPS_CROSSOVER
    assert mfm.fused_active(small)
    assert mfm.fused_active(scale) == (
        mfm._step_flops_estimate(scale) < mfm._FUSED_FLOPS_CROSSOVER)
    mfm.FUSED = True
    assert mfm.fused_active(scale)
    mfm.FUSED = False
    assert not mfm.fused_active(small)


def test_modular_mfn_under_vmap_with_tensor_rates():
    # two lanes, each its own weights and att1 rate (the searches' lane
    # values), against each lane alone with the same masks
    cfg = MFMConfig.from_dict(CFG_DROP.to_dict())
    trees = [mfm.mfm_init(torch.Generator().manual_seed(s), cfg)["mfn_enc"]
             ["mfn"] for s in (0, 1)]
    stacked = torch.utils._pytree.tree_map(lambda *a: torch.stack(a),
                                           *trees)
    x = torch.randn(T, N, cfg.d_total, generator=torch.Generator()
                    .manual_seed(2))
    xs = (x[..., :8], x[..., 8:12], x[..., 12:])
    rates = torch.tensor([0.0, 0.25])
    widths = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
              cfg.gamma2_shape)

    def lane(tree, rate, gen_seed):
        drops = (rate, cfg.att2_drop, cfg.gamma1_drop, cfg.gamma2_drop)
        return mfn_scan(tree, *xs, mem_dim=cfg.memsize, drops=drops,
                        train=True, generator=gen)

    gen = torch.Generator().manual_seed(5)
    out = torch.func.vmap(lane, in_dims=(0, 0, None),
                          randomness="different")(stacked, rates, 0)
    assert out.shape == (2, N, sum(cfg.h_dims) + cfg.memsize)
    assert torch.isfinite(out).all()
    # lane 0's rate 0 keeps every att1 unit: equal to the lane alone with
    # att1's mask all ones and the other sites' masks drawn
    masks = cuda_mfn.make_dropout_masks(
        torch.Generator().manual_seed(6), T, N, widths,
        (0.0, cfg.att2_drop, cfg.gamma1_drop, cfg.gamma2_drop))
    alone = mfn_scan(trees[0], *xs, mem_dim=cfg.memsize,
                     drops=(torch.tensor(0.0), cfg.att2_drop,
                            cfg.gamma1_drop, cfg.gamma2_drop),
                     train=True, masks=masks)
    plain = mfn_scan(trees[0], *xs, mem_dim=cfg.memsize,
                     drops=(0.0, cfg.att2_drop, cfg.gamma1_drop,
                            cfg.gamma2_drop), train=True, masks=masks)
    torch.testing.assert_close(alone, plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator or masks"):
        mfn_scan(trees[0], *xs, mem_dim=cfg.memsize,
                 drops=(0.5, 0.0, 0.0, 0.0), train=True)


@pytest.mark.parametrize("name", list(MODELS))
def test_serving_follows_the_gate(name, port_gate):
    cfg = _cfg(MFMConfig.from_dict(CFG.to_dict()), name)
    tree = mfm.MFM(cfg, seed=0, device="cpu", model_type=name).tree()
    X = np.random.default_rng(0).normal(
        size=(7, cfg.seqlength, cfg.d_total)).astype(np.float32)
    ys = []
    for fused in (True, False):
        mfm.FUSED = fused
        p = Predictor(cfg, tree, model_type=name, device="cpu")
        assert p.forward.modular is (not fused)
        ys.append(p.predict(X))
    np.testing.assert_allclose(ys[1], ys[0], **TOL)
    # the ablations' serving forward does not follow the gate
    assert not predict.modular(cfg, "m_b") and not predict.modular(cfg,
                                                                   "m_c")


def test_encoder_and_decoder_under_vmap():
    # the modular recurrences over two lanes of weights equal each lane's
    from factorized_tpu_torch.ops.lstm import (decoder_apply, decoder_init,
                                               encoder_apply, encoder_init)

    encs = [encoder_init(torch.Generator().manual_seed(s), 7, 5)
            for s in (0, 1)]
    decs = [decoder_init(torch.Generator().manual_seed(s), 6, 4)
            for s in (2, 3)]
    x = torch.randn(T, N, 7, generator=torch.Generator().manual_seed(4))
    hT = torch.randn(N, 6, generator=torch.Generator().manual_seed(5))

    def stack(trees):
        return torch.utils._pytree.tree_map(lambda *a: torch.stack(a),
                                            *trees)

    z = torch.func.vmap(encoder_apply, in_dims=(0, None))(stack(encs), x)
    r = torch.func.vmap(lambda p: decoder_apply(p, hT, T))(stack(decs))
    for k in range(2):
        torch.testing.assert_close(z[k], encoder_apply(encs[k], x))
        torch.testing.assert_close(r[k], decoder_apply(decs[k], hT, T))
