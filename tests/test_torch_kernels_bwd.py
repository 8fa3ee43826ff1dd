"""The plain versions of the port's training kernels against the JAX
package's Pallas kernels (interpret mode on the CPU): the train forward of
the fused encode with masks and residuals, the encode backward, the
decoder backward, and their ``torch.autograd.Function``s.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: forward rtol 2e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 2e-5 (as tests/test_pallas_mfn.py), float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.ops.fused as jfused
from factorized_tpu.ops import pallas_lstm, pallas_mfn
from factorized_tpu_torch.ops import _build, cuda_lstm, cuda_mfn

FWD = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)

# the small config of tests/test_torch_kernels.py: encoders 6/4/5, MFN
# 6/5/4, mem 6, every MLP 8 wide
ENC_H, MFN_H, MEM, S = [6, 4, 5], [6, 5, 4], 6, 8
H_DIMS = ENC_H + MFN_H
DEC_H = [9, 8, 7]
SIZES = (S, S, S, S)


def _encode_inputs(seed, t=6, n=4, rate=0.5):
    """(xp, masks, weights, z_tot) as numpy; masks from the JAX
    package's make_dropout_masks at ``rate`` on every site."""
    rng = np.random.default_rng(seed)
    H = sum(H_DIMS)
    z_tot = sum(ENC_H)
    m2 = 2 * (H - z_tot)

    def w(*shape, scale=0.4):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    wh = np.array(jfused.gate_major_blockdiag(
        [w(h, 4 * h) for h in H_DIMS], H_DIMS))
    weights = {
        "wh": wh, "a1w1": w(m2, S), "a1b1": w(1, S), "a1w2": w(S, m2),
        "a1b2": w(1, m2), "a2w1": w(m2, S), "a2b1": w(1, S),
        "a2w2": w(S, MEM), "a2b2": w(1, MEM), "gw1": w(m2 + MEM, 2 * S),
        "gb1": w(1, 2 * S), "g1w2": w(S, MEM), "g1b2": w(1, MEM),
        "g2w2": w(S, MEM), "g2b2": w(1, MEM),
    }
    xp = w(t, n, 4 * H, scale=1.0)
    masks = np.array(pallas_mfn.make_dropout_masks(
        jax.random.PRNGKey(seed), t, n, SIZES, (rate,) * 4))
    return xp, masks, weights, z_tot


def _cotangents(seed, n, H, mem):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, H)).astype(np.float32),
            rng.normal(size=(n, mem)).astype(np.float32))


def _decoder_inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    H = sum(DEC_H)
    wsum = np.array(jfused.gate_major_blockdiag(
        [(0.4 * rng.normal(size=(h, 4 * h))).astype(np.float32)
         for h in DEC_H], DEC_H))
    b = rng.normal(size=(1, 4 * H)).astype(np.float32)
    h0 = np.tanh(rng.normal(size=(n, H))).astype(np.float32)
    c0 = rng.normal(size=(n, H)).astype(np.float32)
    return h0, c0, wsum, b


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


# ------------------------------------------------------- train forward

@pytest.mark.parametrize("t", [1, 6])
def test_train_forward_plain_matches_pallas(t):
    xp, masks, weights, z_tot = _encode_inputs(0, t=t)
    ref = pallas_mfn._fwd_call(jnp.asarray(xp), jnp.asarray(masks),
                               _j(weights), z_tot, True, with_res=True)
    port = cuda_mfn.mfm_encode_res_plain(
        torch.from_numpy(xp), torch.from_numpy(masks), _t(weights), z_tot)
    assert len(port) == len(ref) == 6
    for p, r in zip(port, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r, FWD)
    _, R = cuda_mfn.res_layout(weights)
    assert R == pallas_mfn._res_layout(weights)[1]
    # the forward without residuals gives the same two outputs
    h, mem = cuda_mfn.mfm_encode(torch.from_numpy(xp), _t(weights), z_tot,
                                 H_DIMS, torch.from_numpy(masks))
    assert torch.equal(h, port[0]) and torch.equal(mem, port[1])


def test_dropout_masks_layout_and_scale():
    g = torch.Generator().manual_seed(0)
    m = cuda_mfn.make_dropout_masks(g, 5, 64, (8, 6, 4, 10),
                                    (0.5, 0.0, 0.25, 1.0))
    assert m.shape == (5, 64, 28) and m.dtype == torch.float32
    a1, a2, g1, g2 = m.split([8, 6, 4, 10], dim=2)
    assert set(a1.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(a2, torch.ones_like(a2))        # rate 0: all ones
    assert set(g1.unique().tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    assert torch.equal(g2, torch.zeros_like(g2))       # rate 1: all zeros
    assert 0.4 < float((a1 > 0).float().mean()) < 0.6
    again = cuda_mfn.make_dropout_masks(torch.Generator().manual_seed(0), 5,
                                        64, (8, 6, 4, 10),
                                        (0.5, 0.0, 0.25, 1.0))
    assert torch.equal(m, again)


# ------------------------------------------------------ encode backward

def _residuals(xp, masks, weights, z_tot):
    return pallas_mfn._fwd_call(jnp.asarray(xp), jnp.asarray(masks),
                                _j(weights), z_tot, True, with_res=True)


@pytest.mark.parametrize("t", [1, 6])
def test_encode_bwd_plain_matches_pallas(t):
    xp, masks, weights, z_tot = _encode_inputs(1, t=t)
    _, _, allh, allc, allmem, res = _residuals(xp, masks, weights, z_tot)
    dh, dmem = _cotangents(2, xp.shape[1], sum(H_DIMS), MEM)
    dxp_j, dw_j = pallas_mfn._bwd_call(
        jnp.asarray(xp), _j(weights), allh, allc, allmem, res,
        jnp.asarray(dh), jnp.asarray(dmem), z_tot)
    dxp_p, dw_p = cuda_mfn.mfm_encode_bwd_plain(
        torch.from_numpy(xp), _t(weights),
        *[torch.from_numpy(np.array(a)) for a in (allh, allc, allmem,
                                                    res)],
        torch.from_numpy(dh), torch.from_numpy(dmem), z_tot)
    _close(dxp_p, dxp_j, GRAD)
    assert set(dw_p) == set(dw_j) == set(cuda_mfn.W_NAMES)
    for k in cuda_mfn.W_NAMES:
        assert tuple(dw_p[k].shape) == dw_j[k].shape, k
        _close(dw_p[k], dw_j[k], GRAD)


def test_encode_bwd_plain_matches_jax_grad():
    xp, masks, weights, z_tot = _encode_inputs(3)
    dh, dmem = _cotangents(4, xp.shape[1], sum(H_DIMS), MEM)

    def loss(xp_, w_):
        h, mem = pallas_mfn.mfm_encode_pallas(xp_, jnp.asarray(masks), w_,
                                              z_tot, True)
        return jnp.sum(h * dh) + jnp.sum(mem * dmem)

    g_xp, g_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), _j(weights))

    x_t, m_t, w_t = torch.from_numpy(xp), torch.from_numpy(masks), \
        _t(weights)
    _, _, allh, allc, allmem, res = cuda_mfn.mfm_encode_res_plain(
        x_t, m_t, w_t, z_tot)
    dxp, dw = cuda_mfn.mfm_encode_bwd_plain(
        x_t, w_t, allh, allc, allmem, res, torch.from_numpy(dh),
        torch.from_numpy(dmem), z_tot)
    _close(dxp, g_xp, GRAD)
    for k in cuda_mfn.W_NAMES:
        _close(dw[k], g_w[k], GRAD)


def test_encode_bwd_plain_matches_torch_autograd():
    """The hand-derived backward against autograd of the plain forward,
    in float64: a derivation error shows far above rounding."""
    xp, masks, weights, z_tot = _encode_inputs(5)
    dh, dmem = _cotangents(6, xp.shape[1], sum(H_DIMS), MEM)
    x = torch.from_numpy(xp).double().requires_grad_()
    w = {k: torch.from_numpy(v).double().requires_grad_()
         for k, v in weights.items()}
    m = torch.from_numpy(masks).double()
    ch, cm = torch.from_numpy(dh).double(), torch.from_numpy(dmem).double()
    h, mem, allh, allc, allmem, res = cuda_mfn.mfm_encode_res_plain(
        x, m, w, z_tot)
    (torch.sum(h * ch) + torch.sum(mem * cm)).backward()
    with torch.no_grad():
        dxp, dw = cuda_mfn.mfm_encode_bwd_plain(
            x, w, allh, allc, allmem, res, ch, cm, z_tot)
    torch.testing.assert_close(dxp, x.grad, rtol=1e-9, atol=1e-12)
    for k in cuda_mfn.W_NAMES:
        torch.testing.assert_close(dw[k], w[k].grad, rtol=1e-9, atol=1e-12)


def test_encode_bwd_steps_and_reduction_split():
    """The reverse pass's deltas and the reduction over them compose to
    the backward, and the cotangent of h_last alone or of mem_last alone
    goes through ``MFMEncode`` (a None cotangent is zeros)."""
    xp, masks, weights, z_tot = _encode_inputs(7)
    x_t, m_t, w_t = torch.from_numpy(xp), torch.from_numpy(masks), \
        _t(weights)
    _, _, allh, allc, allmem, res = cuda_mfn.mfm_encode_res_plain(
        x_t, m_t, w_t, z_tot)
    dh, dmem = (torch.from_numpy(a) for a in
                _cotangents(8, xp.shape[1], sum(H_DIMS), MEM))
    dxp, deltas = cuda_mfn.mfm_encode_bwd_steps_plain(
        x_t, w_t, allh, allc, allmem, res, dh, dmem, z_tot)
    assert deltas.shape == (xp.shape[0], xp.shape[1],
                            cuda_mfn.delta_layout(weights)[1])
    dw = cuda_mfn.mfm_encode_dw_plain(allc, allmem, res, deltas, w_t, z_tot)
    full_dxp, full_dw = cuda_mfn.mfm_encode_bwd(
        x_t, w_t, allh, allc, allmem, res, dh, dmem, z_tot, H_DIMS)
    assert torch.equal(dxp, full_dxp)
    for k in cuda_mfn.DW_NAMES:
        assert torch.equal(dw[k], full_dw[k])

    xr = x_t.clone().requires_grad_()
    wr = {k: v.clone().requires_grad_() for k, v in w_t.items()}
    h_last, _ = cuda_mfn.encode(xr, wr, z_tot, H_DIMS, m_t)
    torch.sum(h_last * dh).backward()
    want_dxp, want_dw = cuda_mfn.mfm_encode_bwd(
        x_t, w_t, allh, allc, allmem, res, dh, torch.zeros_like(dmem),
        z_tot, H_DIMS)
    torch.testing.assert_close(xr.grad, want_dxp)
    for k in cuda_mfn.W_NAMES:
        torch.testing.assert_close(wr[k].grad, want_dw[k].reshape(
            wr[k].shape))


def test_encode_function_matches_jax_custom_vjp_without_masks():
    """``MFMEncode`` with masks None (every rate 0) against ``jax.grad``
    through ``mfm_encode_pallas`` in eval mode, the path the JAX model
    takes when no dropout rate is active."""
    xp, _, weights, z_tot = _encode_inputs(9)
    dh, dmem = _cotangents(10, xp.shape[1], sum(H_DIMS), MEM)

    def loss(xp_, w_):
        h, mem = pallas_mfn.mfm_encode_pallas(
            xp_, jnp.zeros((1, 1, 1), jnp.float32), w_, z_tot, False)
        return jnp.sum(h * dh) + jnp.sum(mem * dmem)

    g_xp, g_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), _j(weights))
    x = torch.from_numpy(xp).requires_grad_()
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in weights.items()}
    h, mem = cuda_mfn.encode(x, w, z_tot, H_DIMS)
    (torch.sum(h * torch.from_numpy(dh))
     + torch.sum(mem * torch.from_numpy(dmem))).backward()
    _close(x.grad, g_xp, GRAD)
    for k in cuda_mfn.W_NAMES:
        _close(w[k].grad, g_w[k], GRAD)


def test_encode_without_grad_writes_no_residuals(monkeypatch):
    xp, masks, weights, z_tot = _encode_inputs(11)
    called = []
    monkeypatch.setattr(cuda_mfn, "mfm_encode_res_plain",
                        lambda *a: called.append(a))
    with torch.no_grad():
        cuda_mfn.encode(torch.from_numpy(xp).requires_grad_(), _t(weights),
                        z_tot, H_DIMS, torch.from_numpy(masks))
    assert not called


# ----------------------------------------------------- decoder backward

@pytest.mark.parametrize("t", [2, 7])
def test_decoder_bwd_plain_matches_pallas(t):
    h0, c0, wsum, b = _decoder_inputs(12)
    args = [jnp.asarray(a) for a in (h0, c0, wsum, b)]
    allh, allc, gates = pallas_lstm._dec_fwd_call(*args, t)
    dallh = np.random.default_rng(13).normal(
        size=allh.shape).astype(np.float32)
    ref = pallas_lstm._dec_bwd_call(args[2], gates, allc, jnp.asarray(dallh))
    port = cuda_lstm.decoder_lstm_bwd_plain(
        torch.from_numpy(wsum), torch.from_numpy(np.array(gates)),
        torch.from_numpy(np.array(allc)), torch.from_numpy(dallh))
    for p, r in zip(port, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r, GRAD)
    # the wrapper routes a CPU tensor to the plain version, uncounted
    before = cuda_lstm.BWD_LAUNCHES
    got = cuda_lstm.decoder_lstm_bwd(
        torch.from_numpy(wsum), torch.from_numpy(np.array(gates)),
        torch.from_numpy(np.array(allc)), torch.from_numpy(dallh), DEC_H)
    for g, p in zip(got, port):
        assert torch.equal(g, p)
    assert cuda_lstm.BWD_LAUNCHES == before


@pytest.mark.parametrize("t", [1, 2, 7])
def test_decoder_function_matches_jax_decoder_bwd(t):
    h0, c0, wsum, b = _decoder_inputs(14)
    args = [jnp.asarray(a) for a in (h0, c0, wsum, b)]
    allh_j, res = pallas_lstm._decoder_fwd(*args, t)
    dallh = np.random.default_rng(15).normal(
        size=allh_j.shape).astype(np.float32)
    ref = pallas_lstm._decoder_bwd(t, res, jnp.asarray(dallh))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (h0, c0, wsum, b)]
    allh = cuda_lstm.decoder_lstm(*leaves, t, DEC_H)
    _close(allh, allh_j, FWD)
    torch.sum(allh * torch.from_numpy(dallh)).backward()
    for leaf, r in zip(leaves, ref):
        assert tuple(leaf.grad.shape) == r.shape
        _close(leaf.grad, r, GRAD)


def test_decoder_function_matches_torch_autograd():
    h0, c0, wsum, b = _decoder_inputs(16)
    dallh = torch.from_numpy(np.random.default_rng(17).normal(
        size=(5, h0.shape[0], h0.shape[1])).astype(np.float32))
    a = [torch.from_numpy(x).requires_grad_() for x in (h0, c0, wsum, b)]
    torch.sum(cuda_lstm.decoder_lstm_plain(*a, 5)[0] * dallh).backward()
    f = [torch.from_numpy(x).requires_grad_() for x in (h0, c0, wsum, b)]
    torch.sum(cuda_lstm.DecoderLSTM.apply(*f, 5, DEC_H) * dallh).backward()
    for x, y in zip(a, f):
        torch.testing.assert_close(y.grad, x.grad, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ wrappers

def test_bwd_wrappers_route_cpu_to_plain_uncounted():
    xp, masks, weights, z_tot = _encode_inputs(18)
    x_t, m_t, w_t = torch.from_numpy(xp), torch.from_numpy(masks), \
        _t(weights)
    before = (cuda_mfn.LAUNCHES, cuda_mfn.BWD_LAUNCHES,
              cuda_mfn.DW_LAUNCHES)
    outs = cuda_mfn.mfm_encode_res(x_t, m_t, w_t, z_tot, H_DIMS)
    for g, w in zip(outs, cuda_mfn.mfm_encode_res_plain(x_t, m_t, w_t,
                                                        z_tot)):
        assert torch.equal(g, w)
    dh, dmem = (torch.from_numpy(a) for a in
                _cotangents(19, xp.shape[1], sum(H_DIMS), MEM))
    dxp, dw = cuda_mfn.mfm_encode_bwd(x_t, w_t, *outs[2:], dh, dmem, z_tot,
                                      H_DIMS)
    want_dxp, want_dw = cuda_mfn.mfm_encode_bwd_plain(
        x_t, w_t, *outs[2:], dh, dmem, z_tot)
    assert torch.equal(dxp, want_dxp)
    assert all(torch.equal(dw[k], want_dw[k]) for k in cuda_mfn.W_NAMES)
    assert (cuda_mfn.LAUNCHES, cuda_mfn.BWD_LAUNCHES,
            cuda_mfn.DW_LAUNCHES) == before


def test_bwd_wrappers_reject_bad_arguments():
    xp, masks, weights, z_tot = _encode_inputs(20)
    x_t, m_t, w_t = torch.from_numpy(xp), torch.from_numpy(masks), \
        _t(weights)
    with pytest.raises(ValueError, match="masks must be"):
        cuda_mfn.mfm_encode_res(x_t, m_t[:, :, :-1].contiguous(), w_t, z_tot,
                                H_DIMS)
    with pytest.raises(TypeError, match="masks must be float32"):
        cuda_mfn.mfm_encode(x_t, w_t, z_tot, H_DIMS, m_t.double())
    outs = cuda_mfn.mfm_encode_res(x_t, m_t, w_t, z_tot, H_DIMS)
    dh, dmem = (torch.from_numpy(a) for a in
                _cotangents(21, xp.shape[1], sum(H_DIMS), MEM))
    with pytest.raises(ValueError, match="res must be"):
        cuda_mfn.mfm_encode_bwd(x_t, w_t, *outs[2:5], outs[5][..., :-1]
                                .contiguous(), dh, dmem, z_tot, H_DIMS)
    with pytest.raises(ValueError, match="dmemlast must be contiguous"):
        cuda_mfn.mfm_encode_bwd(x_t, w_t, *outs[2:], dh,
                                torch.zeros(MEM, xp.shape[1]).T, z_tot,
                                H_DIMS)
    meta = [a.to("meta") for a in outs[2:]]
    with pytest.raises(ValueError, match="no kernel"):
        cuda_mfn.mfm_encode_bwd(
            x_t.to("meta"), {k: v.to("meta") for k, v in w_t.items()},
            *meta, dh.to("meta"), dmem.to("meta"), z_tot, H_DIMS)

    h0, c0, wsum, b = (torch.from_numpy(a) for a in _decoder_inputs(22))
    allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, 4)
    with pytest.raises(ValueError, match="t >= 2"):
        cuda_lstm.decoder_lstm_bwd(wsum, gates[:1], allc[:1], allh[:1],
                                   DEC_H)
    with pytest.raises(ValueError, match="gates must be"):
        cuda_lstm.decoder_lstm_bwd(wsum, gates[:, :, :-4].contiguous(), allc,
                                   allh, DEC_H)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_lstm.decoder_lstm_bwd(wsum.to("meta"), gates.to("meta"),
                                   allc.to("meta"), allh.to("meta"), DEC_H)


def test_new_sources_join_the_build():
    names = {p.name for p in _build.sources()}
    assert {"mfm_encode_bwd.cu", "lstm_bwd.cu"} <= names
