"""The port's primitives, LSTMs and block-diagonal packing against the
JAX package's, on seeded numpy inputs (float32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorized_tpu.ops import core as jcore
from factorized_tpu.ops import fused as jfused
from factorized_tpu.ops import lstm as jlstm
from factorized_tpu_torch.convert import from_numpy
from factorized_tpu_torch.ops import core, fused, lstm

TOL = dict(rtol=2e-4, atol=1e-5)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def test_lstm_step():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(5, 7)).astype(np.float32)
    gates = rng.normal(size=(5, 28)).astype(np.float32)
    h_p, c_p = lstm.lstm_step(torch.from_numpy(c), torch.from_numpy(gates))
    h_j, c_j = jlstm.lstm_step(jnp.asarray(c), jnp.asarray(gates))
    close(h_p, h_j)
    close(c_p, c_j)


def test_linear_and_mlp2():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    lin = np_tree(jcore.linear_init(jax.random.PRNGKey(0), 9, 4))
    close(core.linear_apply(from_numpy(lin), torch.from_numpy(x)),
          jcore.linear_apply(lin, jnp.asarray(x)))
    mlp = np_tree(jcore.mlp2_init(jax.random.PRNGKey(1), 9, 11, 3))
    close(core.mlp2_apply(from_numpy(mlp), torch.from_numpy(x), drop=0.5,
                          train=False),
          jcore.mlp2_apply(mlp, jnp.asarray(x), drop=0.5, train=False))


def test_dropout_semantics():
    x = torch.ones(2000)
    g = torch.Generator().manual_seed(0)
    assert core.dropout(x, 0.5, False) is x          # eval: identity
    assert core.dropout(x, 0.0, True, g) is x        # rate 0: identity
    assert torch.equal(core.dropout(x, 1.0, True, g), torch.zeros(2000))
    assert torch.equal(core.dropout(x, 1.5, True, g), torch.zeros(2000))
    y = core.dropout(x, 0.25, True, g)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.68 < kept.float().mean() < 0.82
    with pytest.raises(ValueError, match="Generator"):
        core.dropout(x, 0.25, True)
    # the JAX package agrees on the deterministic cases
    xj = jnp.ones(7)
    assert np.array_equal(np.asarray(jcore.dropout(None, xj, 1.0, True)),
                          core.dropout(torch.ones(7), 1.0, True).numpy())


def test_uniform_fan_in_bounds_and_seed():
    w1 = core.uniform_fan_in(torch.Generator().manual_seed(3), (64, 32), 16)
    w2 = core.uniform_fan_in(torch.Generator().manual_seed(3), (64, 32), 16)
    assert torch.equal(w1, w2)
    assert w1.abs().max() <= 0.25 and w1.abs().max() > 0.2


H_DIMS = [3, 5, 2]


def _cells(rng, d_in):
    return [rng.normal(size=(d, 4 * h)).astype(np.float32)
            for d, h in zip(d_in, H_DIMS)]


@pytest.mark.parametrize("name", ["blockdiag", "gate_major_blockdiag",
                                  "gate_major_bias", "repack_gate_major"])
def test_packing(name):
    rng = np.random.default_rng(2)
    if name == "blockdiag":
        mats = [rng.normal(size=(r, c)).astype(np.float32)
                for r, c in ((2, 3), (4, 1), (3, 2))]
        args = ([m for m in mats], [3, 1, 2])
    elif name == "gate_major_blockdiag":
        args = (_cells(rng, [4, 6, 3]), H_DIMS)
    elif name == "gate_major_bias":
        args = ([rng.normal(size=(4 * h,)).astype(np.float32)
                 for h in H_DIMS], H_DIMS)
    else:
        args = ([rng.normal(size=(3, 2, 4 * h)).astype(np.float32)
                 for h in H_DIMS], H_DIMS)
    port = getattr(fused, name)([torch.from_numpy(a) for a in args[0]],
                                args[1])
    ref = getattr(jfused, name)([jnp.asarray(a) for a in args[0]], args[1])
    assert tuple(port.shape) == ref.shape
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_hoist_and_split_heads():
    rng = np.random.default_rng(3)
    cell = np_tree(jlstm.lstm_cell_init(jax.random.PRNGKey(4), 6, 5))
    x = rng.normal(size=(4, 3, 6)).astype(np.float32)
    close(fused.hoist_xproj(from_numpy(cell), torch.from_numpy(x)),
          jfused.hoist_xproj(cell, jnp.asarray(x)))
    h = rng.normal(size=(3, 10)).astype(np.float32)
    for p, j in zip(fused.split_heads(torch.from_numpy(h), H_DIMS),
                    jfused.split_heads(jnp.asarray(h), H_DIMS)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_lstm_scan_and_encoder_apply():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 4, 6)).astype(np.float32)
    enc = np_tree(jlstm.encoder_init(jax.random.PRNGKey(5), 6, 5))
    all_p, h_p, c_p = lstm.lstm_scan(from_numpy(enc)["lstm"],
                                     torch.from_numpy(x))
    all_j, h_j, c_j = jlstm.lstm_scan(enc["lstm"], jnp.asarray(x))
    close(all_p, all_j)
    close(h_p, h_j)
    close(c_p, c_j)
    close(lstm.encoder_apply(from_numpy(enc), torch.from_numpy(x)),
          jlstm.encoder_apply(enc, jnp.asarray(x)))


@pytest.mark.parametrize("t", [1, 6])
def test_decoder_apply(t):
    rng = np.random.default_rng(6)
    hT = rng.normal(size=(4, 5)).astype(np.float32)
    dec = np_tree(jlstm.decoder_init(jax.random.PRNGKey(6), 5, 3))
    close(lstm.decoder_apply(from_numpy(dec), torch.from_numpy(hT), t),
          jlstm.decoder_apply(dec, jnp.asarray(hT), t))


def test_cell_init_tree_matches_jax():
    port = lstm.lstm_cell_init(torch.Generator().manual_seed(0), 6, 5)
    ref = jlstm.lstm_cell_init(jax.random.PRNGKey(0), 6, 5)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}
