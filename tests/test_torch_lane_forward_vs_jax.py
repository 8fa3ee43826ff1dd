"""The recurrences' forward over lanes against the JAX package on the CPU:
``cuda_lstm.decoder_lstm_lanes_plain`` and ``multi_lstm_lanes_plain`` (the
yardsticks the lane kernels of ``csrc/lstm_fwd.cu`` are held to on the
card, and the CPU route of the ``*_fwd_lanes`` wrappers and of
``torch.func.vmap``) against ``jax.vmap`` of ``pallas_lstm``'s
``decoder_lstm`` and ``multi_lstm`` and of their forwards with residuals
(``_decoder_fwd``, ``_multi_lstm_fwd``), the Pallas kernels in interpret
mode as the JAX package's own tests run them on the CPU.

K = 3 lanes of small fused cells (gate-major, block-diagonal recurrent
weights), t = 5, n = 4, inputs made from a numpy seed; each lane its own
operands, or with the weights and the bias shared by every lane (a lane
stride of 0 on the card). Tolerance: rtol 1e-5 / atol 1e-6, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorized_tpu.ops import pallas_lstm
from factorized_tpu_torch.ops import cuda_lstm

TOL = dict(rtol=1e-5, atol=1e-6)
K, T, N = 3, 5, 4
DEC_DIMS, MULTI_DIMS = [6, 3, 3], [4, 2, 5]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _block_diagonal(rng, dims, lanes):
    """``lanes`` gate-major block-diagonal recurrent weights (lanes, H,
    4H) over the fused cells ``dims``: cell m's rows feed only its own
    units' columns of each gate."""
    H = sum(dims)
    w = np.zeros((lanes, H, 4 * H), np.float32)
    o = 0
    for h in dims:
        for q in range(4):
            w[:, o:o + h, q * H + o:q * H + o + h] = rng.normal(
                scale=0.5, size=(lanes, h, h))
        o += h
    return w


def _lanes(arrays, shared):
    """Each numpy array as the torch operand of K lanes: its own lanes,
    or the first lane's expanded to K (stride 0) where it is in
    ``shared``; and the JAX operands and in_axes (None: shared)."""
    torch_ops, jax_ops, axes = [], [], []
    for name, a in arrays.items():
        if name in shared:
            torch_ops.append(torch.from_numpy(a[0]).expand(K, *a.shape[1:]))
            jax_ops.append(jnp.asarray(a[0]))
            axes.append(None)
        else:
            torch_ops.append(torch.from_numpy(a))
            jax_ops.append(jnp.asarray(a))
            axes.append(0)
    return torch_ops, jax_ops, tuple(axes)


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               **TOL)


SHARED = {"own": (), "shared_weights": ("w", "b")}


@pytest.mark.parametrize("shared", sorted(SHARED))
def test_the_decoder_forward_over_lanes_matches_jax(shared):
    """allh, allc and the gates of K decoder recurrences (t - 1 steps from
    each lane's (h0, c0), slot 0 the state and zero gates) against
    ``jax.vmap`` of ``_decoder_fwd``; allh against ``jax.vmap`` of
    ``decoder_lstm``; the lane wrapper's CPU route and the ``torch.func.
    vmap`` route bit for bit the plain version's."""
    rng = np.random.default_rng(23)
    H = sum(DEC_DIMS)
    arrays = {"h0": rng.normal(scale=0.5, size=(K, N, H)).astype(np.float32),
              "c0": rng.normal(scale=0.5, size=(K, N, H)).astype(np.float32),
              "w": _block_diagonal(rng, DEC_DIMS, K),
              "b": rng.normal(scale=0.5,
                              size=(K, 1, 4 * H)).astype(np.float32)}
    (h0, c0, wsum, b), jops, axes = _lanes(arrays, SHARED[shared])
    want_allh, (_, _, allh, allc, gates) = jax.vmap(
        lambda *a: pallas_lstm._decoder_fwd(*a, T), in_axes=axes)(*jops)
    got = cuda_lstm.decoder_lstm_lanes_plain(h0, c0, wsum, b, T)
    for g, w in zip(got, (allh, allc, gates)):
        assert g.shape == (K, T, N, w.shape[-1])
        _close(g, w)
    _close(got[0], jax.vmap(lambda *a: pallas_lstm.decoder_lstm(*a, T),
                            in_axes=axes)(*jops))
    _close(got[0], want_allh)
    for g, w in zip(cuda_lstm.decoder_lstm_fwd_lanes(h0, c0, wsum, b, T,
                                                     DEC_DIMS), got):
        assert torch.equal(g, w)
    dims = tuple(0 if a == 0 else None for a in axes)
    ops = [x if d == 0 else x[0] for x, d in zip((h0, c0, wsum, b), dims)]
    vmapped = torch.func.vmap(
        lambda *a: cuda_lstm.decoder_lstm(*a, T, DEC_DIMS),
        in_dims=dims)(*ops)
    assert torch.equal(vmapped, got[0])


@pytest.mark.parametrize("shared", sorted(SHARED))
@pytest.mark.parametrize("with_res", [False, True], ids=["eval", "train"])
def test_the_encoder_cells_forward_over_lanes_matches_jax(shared, with_res):
    """h_last of K fused encoder-cell recurrences (t steps from a zero
    state over each lane's input projections) against ``jax.vmap`` of
    ``multi_lstm`` (eval) or, with allh, allc and the gates, of
    ``_multi_lstm_fwd`` (train); the lane wrapper's CPU route and the
    ``torch.func.vmap`` route bit for bit the plain version's."""
    rng = np.random.default_rng(29 + with_res)
    H = sum(MULTI_DIMS)
    arrays = {"xp": rng.normal(size=(K, T, N, 4 * H)).astype(np.float32),
              "w": _block_diagonal(rng, MULTI_DIMS, K)}
    (xp, wh), jops, axes = _lanes(arrays, SHARED[shared])
    got = cuda_lstm.multi_lstm_lanes_plain(xp, wh, with_res)
    if with_res:
        h_last, (_, allh, allc, gates) = jax.vmap(
            pallas_lstm._multi_lstm_fwd, in_axes=axes)(*jops)
        for g, w in zip(got, (h_last, allh, allc, gates)):
            _close(g, w)
        assert got[3].shape == (K, T, N, 4 * H)
    else:
        assert got.shape == (K, N, H)
        _close(got, jax.vmap(pallas_lstm.multi_lstm, in_axes=axes)(*jops))
    wrapped = cuda_lstm.multi_lstm_fwd_lanes(xp, wh, MULTI_DIMS, with_res)
    for g, w in zip(wrapped if with_res else (wrapped,),
                    got if with_res else (got,)):
        assert torch.equal(g, w)
    dims = tuple(0 if a == 0 else None for a in axes)
    ops = [x if d == 0 else x[0] for x, d in zip((xp, wh), dims)]
    vmapped = torch.func.vmap(
        lambda *a: cuda_lstm.multi_lstm(*a, MULTI_DIMS), in_dims=dims)(*ops)
    assert torch.equal(vmapped, got[0] if with_res else got)
