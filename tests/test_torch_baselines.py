"""The port's missing-modality baselines ``s2s`` and ``bm`` against the JAX
package's on the same parameters, inputs and random draws.

- each model's init tree and registry entry;
- its eval forward and its train forward with every draw injected (the
  three MMD samples and the three dropout masks, rebuilt from the JAX
  package's keys);
- the ``"s2s"`` and ``"bm"`` losses' values and gradients against
  ``jax.grad`` (``bm`` for regression and for three classes), and their
  eval functions.

The JAX package runs the encoders and decoders through ``lax.scan``; the
port runs them through the fused kernels' plain versions (``multi_lstm``
over inputs of three widths, ``decoder_lstm`` over three cells).
Tolerances: rtol 1e-5 / atol 1e-6, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.models.baselines as jbase
from factorized_tpu import train as jtrain
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu_torch import train
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import baselines, get_model

TOL = dict(rtol=1e-5, atol=1e-6)
TYPES = ("s2s", "bm")

# the small config of tests/test_torch_ablations.py, every dropout site of
# the baselines active
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    zy_to_fy_dropout=0.5, zl_to_fl_dropout=0.2,
    za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7, missing=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(model_type, **kw):
    jcfg = CFG.replace(model_type=model_type, **kw)
    return jcfg, MFMConfig.from_dict(jcfg.to_dict())


def _params(model_type, seed=0, **kw):
    jcfg, _ = _cfgs(model_type, **kw)
    return jax_get_model(model_type)[0](jax.random.PRNGKey(seed), jcfg)


def _mask(key, rate, shape):
    """``core.dropout``'s scaled keep-mask for ``key``, or None at rate 0."""
    if rate <= 0.0:
        return None
    keep = 1.0 - rate
    bern = np.array(jax.random.bernoulli(key, keep, shape))
    return torch.from_numpy(bern.astype(np.float32) * np.float32(1.0 / keep))


def _noise(key, d, n):
    return torch.from_numpy(np.array(jax.random.normal(key, (n, d))))


def _draws(model_type, key, n, train=True, cfg=CFG):
    """Every draw the JAX apply of ``model_type`` makes from ``key``: its
    ``subkeys(key, 4)``, the first split three ways for the MMD samples,
    the other three for the dropout sites (eval: the MMD samples
    alone)."""
    k = jax.random.split(key, 4)
    km = jax.random.split(k[0], 3)
    c = cfg
    if model_type == "s2s":
        draws = {"mmd_noise": [_noise(km[0], c.zv_size, n),
                               _noise(km[1], c.za_size, n),
                               _noise(km[2], c.zl_size, n)]}
        if train:
            draws["zf_masks"] = [
                _mask(k[1], c.zl_to_fl_dropout, (n, c.fl_size)),
                _mask(k[2], c.za_to_fa_dropout, (n, c.fa_size)),
                _mask(k[3], c.zv_to_fv_dropout, (n, c.fv_size))]
        return draws
    draws = {"mmd_noise": [_noise(km[j], c.zy_size, n) for j in range(3)]}
    if train:
        draws["y_masks"] = [_mask(k[j], c.zy_to_fy_dropout, (n, c.fy_size))
                            for j in (1, 2, 3)]
    return draws


def _x(t, n, seed):
    return np.random.default_rng(seed).normal(
        size=(t, n, CFG.d_total)).astype(np.float32)


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **TOL)


def _outputs(out):
    """An apply's result as a flat list: the reconstructions or heads,
    then the MMD."""
    return [o[0] if isinstance(o, list) else o for o in out]


# ----------------------------------------------------------- the models

@pytest.mark.parametrize("model_type", TYPES)
def test_init_tree_and_registry_match_jax(model_type):
    _, cfg = _cfgs(model_type)
    ref = to_state_dict(jax.tree.map(np.asarray, _params(model_type)))
    init, apply_fn = get_model(model_type)
    port = to_state_dict(init(torch.Generator().manual_seed(0), cfg))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    names = {"s2s": "seq2seq", "bm": "basic_missing"}[model_type]
    assert (init, apply_fn) == (getattr(baselines, f"{names}_init"),
                                getattr(baselines, f"{names}_apply"))
    assert (jax_get_model(model_type)[0]
            is getattr(jbase, f"{names}_init"))


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("model_type", TYPES)
def test_forward_matches_jax(model_type, train_mode):
    jcfg, cfg = _cfgs(model_type)
    t, n = 6, 4
    params = _params(model_type)
    x = _x(t, n, 1)
    key = jax.random.PRNGKey(2)
    want = jax_get_model(model_type)[1](params, jnp.asarray(x), jcfg,
                                        key=key, train=train_mode)
    with torch.no_grad():
        got = get_model(model_type)[1](
            from_numpy(jax.tree.map(np.asarray, params)),
            torch.from_numpy(x), cfg, train=train_mode,
            **_draws(model_type, key, n, train_mode))
    assert len(got) == len(want) == 4
    if model_type == "s2s":
        assert all(len(g) == 1 for g in got[:3])
    for k, (p, j) in enumerate(zip(_outputs(got), _outputs(want))):
        assert tuple(p.shape) == j.shape, k
        _close(p, j, f"out[{k}]")


@pytest.mark.parametrize("model_type,kw", [
    ("s2s", {}),
    ("bm", {}),
    ("bm", dict(task="classification", output_dim=3)),
], ids=["s2s", "bm", "bm_classes"])
def test_loss_grads_match_jax(model_type, kw):
    jcfg, cfg = _cfgs(model_type, **kw)
    t, n = 6, 4
    params = _params(model_type, seed=3, **kw)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(t, n, CFG.d_total)).astype(np.float32)
    y = (rng.integers(0, 3, size=(n,)).astype(np.int32)
         if kw else rng.normal(size=(n,)).astype(np.float32))
    key = jax.random.PRNGKey(5)
    loss_j = jtrain.make_loss_fn(jax_get_model(model_type)[1], jcfg,
                                 model_type)
    (lj, tj), gj = jax.value_and_grad(
        lambda p: loss_j(p, jnp.asarray(x), jnp.asarray(y), key),
        has_aux=True)(params)

    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    loss_p = train.make_loss_fn(get_model(model_type)[1], cfg, model_type)
    # the JAX loss splits its key once and hands the first half to apply
    lp, tp = loss_p(tree, torch.from_numpy(x), torch.from_numpy(y),
                    draws=_draws(model_type, jax.random.split(key)[0], n))
    lp.backward()
    _close(lp, float(lj), "loss")
    _close(tp, float(tj), "tracked")
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    assert set(flat_j) == set(flat)
    for name, leaf in flat.items():
        grad = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        _close(grad, flat_j[name], name)


@pytest.mark.parametrize("model_type,kw", [
    ("s2s", {}),
    ("bm", {}),
    ("bm", dict(task="classification", output_dim=3)),
], ids=["s2s", "bm", "bm_classes"])
def test_eval_fn_matches_jax(model_type, kw):
    """The validation number: ``s2s`` the three reconstruction MSEs
    without the MMD, ``bm`` the l-missing head's label loss."""
    jcfg, cfg = _cfgs(model_type, **kw)
    params = _params(model_type, seed=6, **kw)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 5, CFG.d_total)).astype(np.float32)
    y = (rng.integers(0, 3, size=(5,)).astype(np.int32)
         if kw else rng.normal(size=(5,)).astype(np.float32))
    want = jtrain.make_eval_fn(jax_get_model(model_type)[1], jcfg,
                               model_type)(params, jnp.asarray(x),
                                           jnp.asarray(y),
                                           jax.random.PRNGKey(8))
    program = train.TrainProgram(get_model(model_type)[1], cfg, model_type)
    got = program.evaluate(from_numpy(jax.tree.map(np.asarray, params)),
                           torch.from_numpy(x), torch.from_numpy(y),
                           torch.Generator().manual_seed(0))
    _close(got, float(want), "valid")


@pytest.mark.parametrize("model_type", TYPES)
def test_train_draws_come_from_the_generator(model_type):
    _, cfg = _cfgs(model_type)
    init, apply_fn = get_model(model_type)
    params = init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(5, 3, cfg.d_total)

    def run(seed):
        return _outputs(apply_fn(params, x, cfg, train=True,
                                 generator=torch.Generator().manual_seed(
                                     seed)))

    same, other = run(0), run(1)
    assert all(torch.equal(a, b) for a, b in zip(same, run(0)))
    assert not torch.equal(same[0], other[0])
    with pytest.raises(ValueError, match="Generator"):
        apply_fn(params, x, cfg, train=True)
    # the eval forward draws the MMD samples alone
    with pytest.raises(ValueError, match="mmd_noise"):
        apply_fn(params, x, cfg)
    widths = ((cfg.zv_size, cfg.za_size, cfg.zl_size)
              if model_type == "s2s" else (cfg.zy_size,) * 3)
    apply_fn(params, x, cfg, mmd_noise=[torch.randn(3, w) for w in widths])
