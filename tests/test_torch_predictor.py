"""The ``predictor`` command's baselines and the flat SGD against the JAX
package's.

- ``eflstm``, ``mfn_predictor`` (the registry's ``mfn``) and
  ``self_attention``: the init trees, the eval forward and the train
  forward with every draw injected (the masks rebuilt from the JAX
  package's keys), and the task loss's gradients against ``jax.grad``
  from the JAX init (``convert.from_numpy``), for regression and for
  three classes; tolerances rtol 1e-5 / atol 1e-6, float32;
- ``FlatSGD`` against ``optax.flatten(optax.trace(0.9))`` followed by
  ``p - lr * u``: the same parameters and trace bit for bit over a few
  steps with an lr change between them, and its ``state_dict``
  round-trip into another optimizer's buffers;
- ``best_mfn_mosi_config`` equal to the JAX package's.

The JAX package runs these recurrences through ``lax.scan``; the port
runs them through the fused kernels' plain versions (``multi_lstm`` of
one cell, the encode with no encoder cell)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import factorized_tpu.models.baselines as jbase
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import best_mfn_mosi_config as jax_best_mfn
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.models.common import mfn_drops
from factorized_tpu.ops import losses as jlosses
from factorized_tpu_torch import train
from factorized_tpu_torch.config import MFMConfig, best_mfn_mosi_config
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import baselines, get_model
from factorized_tpu_torch.ops import losses

TOL = dict(rtol=1e-5, atol=1e-6)
KINDS = ("eflstm", "mfn", "self_attention")
H, DROP = 8, 0.5

# the small config of tests/test_torch_ablations.py, every dropout site of
# the MFN and its out head active
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    att1_shape=8, att2_shape=7, gamma1_shape=9, gamma2_shape=8,
    att1_drop=0.5, att2_drop=0.2, gamma1_drop=0.3, gamma2_drop=0.6,
    out_shape=7, out_drop=0.5, model_type="mfn")
CLASSES = dict(task="classification", output_dim=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(**kw):
    jcfg = CFG.replace(**kw)
    return jcfg, MFMConfig.from_dict(jcfg.to_dict())


def _jax_init(kind, jcfg, seed=0):
    key = jax.random.PRNGKey(seed)
    d, t = jcfg.d_total, jcfg.seqlength
    if kind == "mfn":
        return jax_get_model("mfn")[0](key, jcfg)
    if kind == "eflstm":
        return jbase.eflstm_init(key, d, H, jcfg.output_dim)
    return jbase.self_attention_init(key, d, H, t, jcfg.output_dim)


def _port_init(kind, cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if kind == "mfn":
        return get_model("mfn")[0](gen, cfg)
    if kind == "eflstm":
        return baselines.eflstm_init(gen, cfg.d_total, H, cfg.output_dim)
    return baselines.self_attention_init(gen, cfg.d_total, H, cfg.seqlength,
                                         cfg.output_dim)


def _mask(key, rate, shape):
    """``core.dropout``'s scaled keep-mask for ``key``, or None at rate 0."""
    if rate <= 0.0:
        return None
    keep = 1.0 - rate
    bern = np.array(jax.random.bernoulli(key, keep, shape))
    return torch.from_numpy(bern.astype(np.float32) * np.float32(1.0 / keep))


def _mfn_masks(key, t, n, cfg):
    """The MFN's (t, n, att1 + att2 + gamma1 + gamma2) masks of the JAX
    scan path's draws: ``split(key, t * 4)`` reshaped (t, 4), site j of
    step i drawn from key (i, j); all ones at a rate-0 site."""
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


def _draws(kind, key, n, cfg):
    """Every draw the JAX apply of ``kind`` makes from ``key`` in train
    mode: for ``mfn`` its ``subkeys(key, 2)``, the MFN's per-step masks
    from the first and the out head's from the second; else the one mask
    after ``relu(fc1)`` from the key itself."""
    if kind == "mfn":
        k = jax.random.split(key, 2)
        return {"encode_masks": _mfn_masks(k[0], cfg.seqlength, n, cfg),
                "out_mask": _mask(k[1], cfg.out_drop, (n, cfg.out_shape))}
    return {"mask": _mask(key, DROP, (n, H))}


def _jax_logits(kind, params, x, jcfg, key, train_mode):
    """The JAX apply over the time-major x (``self_attention`` batch-major,
    as the JAX trainer hands it)."""
    if kind == "mfn":
        return jax_get_model("mfn")[1](params, x, jcfg, key=key,
                                       train=train_mode)
    if kind == "eflstm":
        return jbase.eflstm_apply(params, x, DROP, key=key, train=train_mode)
    return jbase.self_attention_apply(params, jnp.transpose(x, (1, 0, 2)),
                                      DROP, key=key, train=train_mode)


def _port_logits(kind, params, x, cfg, train_mode, draws):
    if kind == "mfn":
        return baselines.mfn_predictor_apply(params, x, cfg,
                                             train=train_mode, **draws)
    if kind == "eflstm":
        return baselines.eflstm_apply(params, x, DROP, train=train_mode,
                                      **draws)
    return baselines.self_attention_apply(params, x.transpose(0, 1), DROP,
                                          train=train_mode, **draws)


def _x(t, n, d, seed):
    return np.random.default_rng(seed).normal(size=(t, n, d)).astype(
        np.float32)


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **TOL)


# ----------------------------------------------------------- the models

@pytest.mark.parametrize("kind", KINDS)
def test_init_trees_match_jax(kind):
    jcfg, cfg = _cfgs()
    ref = to_state_dict(jax.tree.map(np.asarray, _jax_init(kind, jcfg)))
    port = to_state_dict(_port_init(kind, cfg))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
    if kind == "self_attention":
        bound = 1.0 / np.sqrt(cfg.seqlength)
        assert float(port["alpha"].abs().max()) <= bound


def test_registry_holds_mfn_alone():
    assert get_model("mfn") == (baselines.mfn_predictor_init,
                                baselines.mfn_predictor_apply)
    assert jax_get_model("mfn")[0] is jbase.mfn_predictor_init
    for kind in ("eflstm", "self_attention"):
        with pytest.raises(ValueError, match="unknown model type"):
            get_model(kind)


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind, train_mode):
    jcfg, cfg = _cfgs()
    t, n = cfg.seqlength, 5
    params = _jax_init(kind, jcfg, seed=1)
    x = _x(t, n, cfg.d_total, 2)
    key = jax.random.PRNGKey(3)
    want = _jax_logits(kind, params, jnp.asarray(x), jcfg, key, train_mode)
    with torch.no_grad():
        got = _port_logits(kind, from_numpy(jax.tree.map(np.asarray, params)),
                           torch.from_numpy(x), cfg, train_mode,
                           _draws(kind, key, n, cfg) if train_mode else {})
    assert tuple(got.shape) == want.shape == (n, 1)
    _close(got, want, "logits")


@pytest.mark.parametrize("task", ["regression", "classes"])
@pytest.mark.parametrize("kind", KINDS)
def test_task_loss_grads_match_jax(kind, task):
    """The task loss of ``train_predictor`` (L1 of the squeezed logits, or
    cross-entropy over three classes) and its gradients, train mode."""
    jcfg, cfg = _cfgs(**(CLASSES if task == "classes" else {}))
    t, n = cfg.seqlength, 6
    params = _jax_init(kind, jcfg, seed=4)
    rng = np.random.default_rng(5)
    x = _x(t, n, cfg.d_total, 6)
    y = (rng.integers(0, 3, size=(n,)).astype(np.int32)
         if task == "classes" else rng.normal(size=(n,)).astype(np.float32))
    key = jax.random.PRNGKey(7)

    def jloss(p):
        out = _jax_logits(kind, p, jnp.asarray(x), jcfg, key, True)
        if task == "classes":
            return jlosses.cross_entropy_loss(out, jnp.asarray(y))
        return jlosses.l1_loss(jnp.squeeze(out, 1), jnp.asarray(y))

    lj, gj = jax.value_and_grad(jloss)(params)
    tree = from_numpy(jax.tree.map(np.asarray, params))
    flat = to_state_dict(tree)
    for v in flat.values():
        v.requires_grad_()
    out = _port_logits(kind, tree, torch.from_numpy(x), cfg, True,
                       _draws(kind, key, n, cfg))
    lp = (losses.cross_entropy_loss(out, torch.from_numpy(y))
          if task == "classes"
          else losses.l1_loss(out.squeeze(1), torch.from_numpy(y)))
    lp.backward()
    _close(lp, float(lj), "loss")
    flat_j = to_state_dict(jax.tree.map(np.asarray, gj))
    assert set(flat_j) == set(flat)
    for name, leaf in flat.items():
        _close(leaf.grad, flat_j[name], name)


@pytest.mark.parametrize("kind", KINDS)
def test_predictor_draws_have_the_shapes_the_apply_reads(kind):
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(8)
    draws = baselines.predictor_draws(kind, cfg, 5, gen, h=H, drop=DROP)
    params = _port_init(kind, cfg)
    x = torch.from_numpy(_x(cfg.seqlength, 5, cfg.d_total, 9))
    with torch.no_grad():
        out = _port_logits(kind, params, x, cfg, True, draws)
    assert tuple(out.shape) == (5, 1) and torch.isfinite(out).all()
    if kind == "mfn":
        assert tuple(draws["encode_masks"].shape) == (
            cfg.seqlength, 5, 8 + 7 + 9 + 8)
        assert tuple(draws["out_mask"].shape) == (5, cfg.out_shape)
    else:
        assert tuple(draws["mask"].shape) == (5, H)


# ------------------------------------------------------------- FlatSGD

def _sgd_fixture():
    rng = np.random.default_rng(10)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}}

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.normal(size=v).astype(np.float32)
                for k, v in tree.items()}

    return draw(shapes), [draw(shapes) for _ in range(5)]


# a scheduler step between steps 3 and 4
LRS = (0.01, 0.01, 0.01, 0.005, 0.005)


def _sgd_steps(optimizer, tree, grads, lrs):
    for g, lr in zip(grads, lrs):
        for leaf, gl in zip(train.leaves(tree), train.leaves(from_numpy(g))):
            leaf.grad.copy_(gl)
        optimizer.set_lr(lr)
        optimizer.step()


def test_flat_sgd_matches_optax_trace_bit_for_bit():
    p0, grads = _sgd_fixture()
    opt = optax.flatten(optax.trace(decay=0.9))
    pj = jax.tree.map(jnp.asarray, p0)
    state = opt.init(pj)
    for g, lr in zip(grads, LRS):
        u, state = opt.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = jax.tree.map(lambda p, u_: p - np.float32(lr) * u_, pj, u)

    tree = from_numpy(p0)
    optimizer = train.make_optimizer(tree, LRS[0], "sgd", 0.9)
    assert isinstance(optimizer, train.FlatSGD)
    assert not hasattr(optimizer, "count")
    _sgd_steps(optimizer, tree, grads, LRS)
    want = to_state_dict(jax.tree.map(np.asarray, pj))
    got = to_state_dict(tree)
    for name in want:
        np.testing.assert_array_equal(got[name].detach().numpy(), want[name],
                                      err_msg=name)
    # optax.flatten keeps the trace as one vector in the leaves' order
    np.testing.assert_array_equal(optimizer.trace.numpy(),
                                  np.asarray(state.trace))
    assert float(optimizer.lr) == np.float32(LRS[-1])


def test_flat_sgd_state_dict_round_trip():
    p0, grads = _sgd_fixture()
    tree = from_numpy(p0)
    optimizer = train.make_optimizer(tree, LRS[0], "sgd")
    _sgd_steps(optimizer, tree, grads[:3], LRS[:3])
    sd = optimizer.state_dict()
    assert set(sd) == {"state", "lr"} and set(sd["state"]) == {"trace"}

    other_tree = from_numpy(p0)
    other = train.make_optimizer(other_tree, 1.0, "sgd")
    addresses = [other.state.data_ptr(), other.trace.data_ptr(),
                 other.lr.data_ptr()]
    other.load_state_dict(sd, params=tree)
    assert addresses == [other.state.data_ptr(), other.trace.data_ptr(),
                         other.lr.data_ptr()]
    assert torch.equal(other.state, optimizer.state)
    assert float(other.lr) == float(optimizer.lr)
    # both go on alike
    _sgd_steps(optimizer, tree, grads[3:], LRS[3:])
    _sgd_steps(other, other_tree, grads[3:], LRS[3:])
    assert torch.equal(other.state, optimizer.state)
    with pytest.raises(ValueError, match="trace"):
        other.load_state_dict({"state": {"trace": torch.zeros(3)},
                               "lr": 0.1})


def test_make_optimizer_refuses_an_unknown_name():
    tree = from_numpy({"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unknown optimizer 'rmsprop'"):
        train.make_optimizer(tree, 0.1, "rmsprop")


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("kind", ["mae", "acc"])
def test_best_mfn_mosi_config_equals_jax(kind):
    assert best_mfn_mosi_config(kind).to_dict() == \
        jax_best_mfn(kind).to_dict()
    assert best_mfn_mosi_config(kind, batchsize=16).batchsize == 16
    with pytest.raises(ValueError, match="'mae' or 'acc'"):
        best_mfn_mosi_config("f1")
