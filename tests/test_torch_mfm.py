"""The port's MFM eval forward against the JAX package's on the same
parameters, inputs and MMD Gaussian: the four decoded outputs and mmd,
with the JAX side on its Pallas kernels (interpret mode) and on its scan
path, plus the module, init, registry and conversion surfaces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.models.mfm as jmfm
import factorized_tpu.ops.fused as jfused
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import best_acc_mosi_config as jax_best
from factorized_tpu_torch.config import MFMConfig, best_acc_mosi_config
from factorized_tpu_torch.convert import (from_numpy, from_state_dict,
                                          to_numpy, to_state_dict)
from factorized_tpu_torch.models import get_model, mfm

TOL = dict(rtol=2e-4, atol=1e-5)  # as tests/test_pallas_mfn.py, float32

CFG = JaxConfig(
    input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0,
    za_to_fa_dropout=0.0, zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0,
)


def _with_pallas(flag, fn):
    old = jfused.USE_PALLAS
    jfused.USE_PALLAS = flag
    try:
        return fn()
    finally:
        jfused.USE_PALLAS = old


def _compare(jcfg, t, n, use_pallas):
    assert jmfm.fused_active(jcfg)
    params = jmfm.mfm_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).normal(
        size=(t, n, jcfg.d_total)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    dmax = max(jcfg.zl_size, jcfg.za_size, jcfg.zv_size, jcfg.zy_size)
    # the Gaussian JAX's _mmd4 draws: subkeys(key, 4)[1], (4, n, dmax)
    noise = jax.random.normal(jax.random.split(key, 4)[1], (4, n, dmax),
                              jnp.float32)
    decoded_j, mmd_j, _ = _with_pallas(use_pallas, lambda: jmfm.mfm_apply(
        params, jnp.asarray(x), jcfg, key=key, train=False))

    cfg = MFMConfig.from_dict(jcfg.to_dict())
    decoded_p, mmd_p, _ = mfm.mfm_apply(
        from_numpy(jax.tree.map(np.asarray, params)), torch.from_numpy(x),
        cfg, train=False, mmd_noise=torch.from_numpy(np.array(noise)))
    assert len(decoded_p) == 4
    for p, j in zip(decoded_p, decoded_j):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(float(mmd_p), float(mmd_j), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_eval_forward_matches_jax(use_pallas):
    _compare(CFG, t=6, n=4, use_pallas=use_pallas)


def test_eval_forward_matches_jax_at_full_width():
    # best_acc_mosi_config widths, n = 4, the JAX scan path
    _compare(jax_best(), t=20, n=4, use_pallas=False)


def test_config_copy_matches_jax():
    assert best_acc_mosi_config().to_dict() == jax_best().to_dict()
    cfg = MFMConfig.from_dict({**CFG.to_dict(), "unknown_key": 1})
    assert cfg.to_dict() == CFG.to_dict()
    assert (cfg.d_total, cfg.last_mfn_size) == (CFG.d_total,
                                                CFG.last_mfn_size)
    assert cfg.replace(memsize=9).memsize == 9 and cfg.memsize == 6


def test_init_tree_matches_jax():
    port = mfm.mfm_init(torch.Generator().manual_seed(0),
                        MFMConfig.from_dict(CFG.to_dict()))
    ref = jmfm.mfm_init(jax.random.PRNGKey(0), CFG)
    shapes_p = {k: tuple(v.shape) for k, v in to_state_dict(port).items()}
    shapes_j = {k: tuple(v.shape) for k, v in to_state_dict(
        jax.tree.map(np.asarray, ref)).items()}
    assert shapes_p == shapes_j


def test_module_state_dict_and_forward():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    model = mfm.MFM(cfg, seed=4, device="cpu")
    ref = jmfm.mfm_init(jax.random.PRNGKey(0), CFG)
    assert set(model.state_dict()) == set(
        to_state_dict(jax.tree.map(np.asarray, ref)))
    assert "enc.encoder_l.lstm.wx" in model.state_dict()
    x = torch.randn(5, 3, cfg.d_total, generator=torch.Generator()
                    .manual_seed(0))
    noise = torch.randn(mfm.mmd_noise_shape(cfg, 3))
    with torch.no_grad():
        out_m = model(x, mmd_noise=noise)
        out_f = mfm.mfm_apply(model.tree(), x, cfg, mmd_noise=noise)
    for a, b in zip(out_m[0] + [out_m[1]], out_f[0] + [out_f[1]]):
        assert torch.equal(a, b)
    # same seed, same weights; the params move with the module
    again = mfm.MFM(cfg, seed=4, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k])
    # train mode: dropout from the generator, gradients to every parameter
    model.train()
    out_t = model(x, generator=torch.Generator().manual_seed(1),
                  mmd_noise=noise)
    again = model(x, generator=torch.Generator().manual_seed(1),
                  mmd_noise=noise)
    assert torch.equal(out_t[0][0], again[0][0])
    (sum(torch.sum(d) for d in out_t[0]) + out_t[1]).backward()
    assert all(p.grad is not None for p in model.parameters())


def test_eval_is_deterministic_per_generator_seed():
    cfg = MFMConfig.from_dict(CFG.to_dict())
    params = mfm.mfm_init(torch.Generator().manual_seed(1), cfg)
    x = torch.randn(4, 2, cfg.d_total)
    runs = [mfm.mfm_apply(params, x, cfg,
                          generator=torch.Generator().manual_seed(0))
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0][3], runs[1][0][3])
    with pytest.raises(ValueError, match="Generator or mmd_noise"):
        mfm.mfm_apply(params, x, cfg)


def test_registry():
    assert get_model("mfm") == (mfm.mfm_init, mfm.mfm_apply)
    assert get_model("kl") == (mfm.mfm_kl_init, mfm.mfm_kl_apply)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_model("mfn")
    with pytest.raises(ValueError, match="unknown model type"):
        get_model("nope")


def test_convert_round_trip_is_a_plain_tree_map():
    ref = jax.tree.map(np.asarray, jmfm.mfm_init(jax.random.PRNGKey(3), CFG))
    port = from_numpy(ref)
    back = to_numpy(port)
    flat_ref, flat_back = to_state_dict(ref), to_state_dict(back)
    assert list(flat_ref) == list(flat_back)
    for k in flat_ref:
        np.testing.assert_array_equal(flat_ref[k], flat_back[k])
    assert to_state_dict(from_state_dict(to_state_dict(port))).keys() == \
        to_state_dict(port).keys()
