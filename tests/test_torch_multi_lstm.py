"""The port's fused encoder-cell recurrence (``cuda_lstm.multi_lstm``)
against the JAX package's ``pallas_lstm.multi_lstm``: the plain versions
of the forward (eval and train variants) and of the backward against the
Pallas kernels in interpret mode, ``MultiLSTM`` against ``jax.grad`` of
``fused_lstm_scan`` on its Pallas and its scan path and against torch
autograd of the plain forward in float64, and the wrappers' routing and
checks.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: forward rtol 2e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 2e-5 (as tests/test_pallas_mfn.py), float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.ops.fused as jfused
from factorized_tpu.ops import pallas_lstm
from factorized_tpu_torch.ops import _build, cuda_lstm, fused
from factorized_tpu_torch.ops.lstm import recurrent_weight_grad

FWD = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)

# four cells as kl_ef fuses them (three encoders and the early-fusion
# one), six as missing fuses its surrogates, at small widths
CELLS = {"kl_ef": ([8, 4, 5, 17], [6, 4, 5, 15]),
         "missing": ([12, 13, 9, 12, 13, 9], [5, 4, 6, 5, 5, 5])}


def _cells(seed, kind):
    """Per-cell weights {'wx', 'wh', 'b'} as numpy."""
    rng = np.random.default_rng(seed)
    d_dims, h_dims = CELLS[kind]
    return [{"wx": (0.4 * rng.normal(size=(d, 4 * h))).astype(np.float32),
             "wh": (0.4 * rng.normal(size=(h, 4 * h))).astype(np.float32),
             "b": (0.2 * rng.normal(size=(4 * h,))).astype(np.float32)}
            for d, h in zip(d_dims, h_dims)]


def _inputs(seed, kind, t=6, n=4):
    """(xp, wh, h_dims) as numpy: gate-major projections and the
    block-diagonal recurrent weight, packed by the JAX package."""
    rng = np.random.default_rng(seed)
    _, h_dims = CELLS[kind]
    H = sum(h_dims)
    wh = np.array(jfused.gate_major_blockdiag(
        [(0.4 * rng.normal(size=(h, 4 * h))).astype(np.float32)
         for h in h_dims], h_dims))
    xp = rng.normal(size=(t, n, 4 * H)).astype(np.float32)
    return xp, wh, h_dims


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _with_pallas(flag, fn):
    old = jfused.USE_PALLAS
    jfused.USE_PALLAS = flag
    try:
        return fn()
    finally:
        jfused.USE_PALLAS = old


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("kind", ["kl_ef", "missing"])
@pytest.mark.parametrize("t", [1, 6])
def test_forward_plain_matches_pallas(t, kind):
    xp, wh, h_dims = _inputs(0, kind, t=t)
    (h_j,) = pallas_lstm._enc_fwd_call(jnp.asarray(xp), jnp.asarray(wh),
                                       with_res=False)
    res_j = pallas_lstm._enc_fwd_call(jnp.asarray(xp), jnp.asarray(wh))
    x_t, w_t = torch.from_numpy(xp), torch.from_numpy(wh)
    h_p = cuda_lstm.multi_lstm_plain(x_t, w_t)
    _close(h_p, h_j, FWD)
    res_p = cuda_lstm.multi_lstm_plain(x_t, w_t, with_res=True)
    assert len(res_p) == len(res_j) == 4
    for p, r in zip(res_p, res_j):
        assert tuple(p.shape) == r.shape
        _close(p, r, FWD)
    assert torch.equal(res_p[0], h_p)


# --------------------------------------------------------------- backward

@pytest.mark.parametrize("kind", ["kl_ef", "missing"])
@pytest.mark.parametrize("t", [1, 6])
def test_backward_plain_matches_pallas(t, kind):
    xp, wh, h_dims = _inputs(1, kind, t=t)
    _, _, allc, gates = pallas_lstm._enc_fwd_call(jnp.asarray(xp),
                                                  jnp.asarray(wh))
    dh = np.random.default_rng(2).normal(
        size=(xp.shape[1], sum(h_dims))).astype(np.float32)
    ref = pallas_lstm._enc_bwd_call(gates, jnp.asarray(wh), allc,
                                    jnp.asarray(dh))
    port = cuda_lstm.multi_lstm_bwd_plain(
        torch.from_numpy(np.array(gates)), torch.from_numpy(wh),
        torch.from_numpy(np.array(allc)), torch.from_numpy(dh))
    assert tuple(port.shape) == ref.shape == xp.shape
    _close(port, ref, GRAD)


@pytest.mark.parametrize("t", [1, 6])
def test_function_matches_jax_custom_vjp(t):
    xp, wh, h_dims = _inputs(3, "kl_ef", t=t)
    dh = np.random.default_rng(4).normal(
        size=(xp.shape[1], sum(h_dims))).astype(np.float32)
    h_j, res = pallas_lstm._multi_lstm_fwd(jnp.asarray(xp), jnp.asarray(wh))
    dxp_j, dwh_j = pallas_lstm._multi_lstm_bwd(res, jnp.asarray(dh))
    x = torch.from_numpy(xp).requires_grad_()
    w = torch.from_numpy(wh).requires_grad_()
    h = cuda_lstm.multi_lstm(x, w, h_dims)
    _close(h, h_j, FWD)
    torch.sum(h * torch.from_numpy(dh)).backward()
    _close(x.grad, dxp_j, GRAD)
    _close(w.grad, dwh_j, GRAD)
    if t == 1:
        assert not torch.any(w.grad)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas", "scan"])
@pytest.mark.parametrize("kind", ["kl_ef", "missing"])
def test_fused_lstm_scan_grads_match_jax(kind, use_pallas):
    """``fused.fused_lstm_scan`` and its gradients to the per-cell weights
    and the inputs against ``jax.grad`` of the JAX package's."""
    cells = _cells(5, kind)
    rng = np.random.default_rng(6)
    t, n = 5, 3
    xs = [rng.normal(size=(t, n, c["wx"].shape[0])).astype(np.float32)
          for c in cells]
    cts = [rng.normal(size=(n, c["wh"].shape[0])).astype(np.float32)
           for c in cells]

    def loss_j(cells_, xs_):
        hs = jfused.fused_lstm_scan(cells_, xs_)
        return sum(jnp.sum(h * c) for h, c in zip(hs, cts))

    grad = jax.grad(loss_j, argnums=(0, 1))
    gc_j, gx_j = _with_pallas(use_pallas, lambda: grad(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in cells],
        [jnp.asarray(x) for x in xs]))
    hs_j = _with_pallas(use_pallas, lambda: jfused.fused_lstm_scan(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in cells],
        [jnp.asarray(x) for x in xs]))

    cells_p = [{k: torch.from_numpy(v).requires_grad_() for k, v in c.items()}
               for c in cells]
    xs_p = [torch.from_numpy(x).requires_grad_() for x in xs]
    hs_p = fused.fused_lstm_scan(cells_p, xs_p)
    for h_p, h_j in zip(hs_p, hs_j):
        _close(h_p, h_j, FWD)
    sum(torch.sum(h * torch.from_numpy(c)) for h, c in zip(hs_p, cts)) \
        .backward()
    for c_p, c_j in zip(cells_p, gc_j):
        for k in ("wx", "wh", "b"):
            _close(c_p[k].grad, c_j[k], GRAD)
    for x_p, x_j in zip(xs_p, gx_j):
        _close(x_p.grad, x_j, GRAD)


@pytest.mark.parametrize("t", [1, 5])
def test_function_matches_torch_autograd(t):
    """The hand-derived backward against autograd of the plain forward,
    in float64: a derivation error shows far above rounding."""
    xp, wh, h_dims = _inputs(7, "missing", t=t)
    dh = torch.from_numpy(np.random.default_rng(8).normal(
        size=(xp.shape[1], sum(h_dims))))
    a = [torch.from_numpy(v).double().requires_grad_() for v in (xp, wh)]
    h, allh, allc, gates = cuda_lstm.multi_lstm_plain(*a, with_res=True)
    torch.sum(h * dh).backward()
    with torch.no_grad():
        dxp = cuda_lstm.multi_lstm_bwd_plain(gates, a[1], allc, dh)
        dwh = recurrent_weight_grad(allh, dxp)
    torch.testing.assert_close(dxp, a[0].grad, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(dwh, a[1].grad, rtol=1e-9, atol=1e-12)
    # and the Function in float32 against autograd in float32
    f = [torch.from_numpy(v).requires_grad_() for v in (xp, wh)]
    torch.sum(cuda_lstm.MultiLSTM.apply(*f, h_dims) * dh.float()).backward()
    for x, y in zip(a, f):
        torch.testing.assert_close(y.grad, x.grad.float(), rtol=1e-5,
                                   atol=1e-6)


def test_recurrent_weight_grad():
    rng = np.random.default_rng(9)
    allh = torch.from_numpy(rng.normal(size=(4, 3, 5)))
    dg = torch.from_numpy(rng.normal(size=(4, 3, 20)))
    want = sum(allh[i - 1].T @ dg[i] for i in range(1, 4))
    torch.testing.assert_close(recurrent_weight_grad(allh, dg), want)
    assert torch.equal(recurrent_weight_grad(allh[:1], dg[:1]),
                       torch.zeros(5, 20, dtype=torch.float64))


# ------------------------------------------------------------- wrappers

def test_wrappers_route_cpu_to_plain_uncounted():
    xp, wh, h_dims = _inputs(10, "kl_ef")
    x_t, w_t = torch.from_numpy(xp), torch.from_numpy(wh)
    before = (cuda_lstm.MULTI_LAUNCHES, cuda_lstm.MULTI_BWD_LAUNCHES)
    assert torch.equal(cuda_lstm.multi_lstm_fwd(x_t, w_t, h_dims),
                       cuda_lstm.multi_lstm_plain(x_t, w_t))
    outs = cuda_lstm.multi_lstm_fwd(x_t, w_t, h_dims, with_res=True)
    for g, w in zip(outs, cuda_lstm.multi_lstm_plain(x_t, w_t, True)):
        assert torch.equal(g, w)
    dh = torch.ones_like(outs[0])
    assert torch.equal(
        cuda_lstm.multi_lstm_bwd(outs[3], w_t, outs[2], dh, h_dims),
        cuda_lstm.multi_lstm_bwd_plain(outs[3], w_t, outs[2], dh))
    assert (cuda_lstm.MULTI_LAUNCHES, cuda_lstm.MULTI_BWD_LAUNCHES) == before


def test_without_grad_no_residuals_are_written(monkeypatch):
    xp, wh, h_dims = _inputs(11, "missing")
    seen = []
    plain = cuda_lstm.multi_lstm_plain

    def spy(x, w, with_res=False):
        seen.append(with_res)
        return plain(x, w, with_res)

    monkeypatch.setattr(cuda_lstm, "multi_lstm_plain", spy)
    x = torch.from_numpy(xp).requires_grad_()
    with torch.no_grad():
        cuda_lstm.multi_lstm(x, torch.from_numpy(wh), h_dims)
    cuda_lstm.multi_lstm(torch.from_numpy(xp), torch.from_numpy(wh), h_dims)
    assert seen == [False, False]
    cuda_lstm.multi_lstm(x, torch.from_numpy(wh), h_dims)
    assert seen[-1] is True


def test_wrappers_reject_bad_arguments():
    xp, wh, h_dims = _inputs(12, "kl_ef")
    x_t, w_t = torch.from_numpy(xp), torch.from_numpy(wh)
    with pytest.raises(ValueError, match="do not sum"):
        cuda_lstm.multi_lstm_fwd(x_t, w_t, h_dims[:-1])
    with pytest.raises(ValueError, match="xp must be"):
        cuda_lstm.multi_lstm_fwd(x_t[..., :-1], w_t, h_dims)
    with pytest.raises(ValueError, match="wh must be"):
        cuda_lstm.multi_lstm_fwd(x_t, w_t[:-1].contiguous(), h_dims)
    with pytest.raises(TypeError, match="wh must be float32"):
        cuda_lstm.multi_lstm_fwd(x_t, w_t.double(), h_dims)
    with pytest.raises(ValueError, match="wh must be contiguous"):
        cuda_lstm.multi_lstm_fwd(x_t, w_t.T.contiguous().T, h_dims)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_lstm.multi_lstm_fwd(x_t.to("meta"), w_t.to("meta"), h_dims)
    _, _, allc, gates = cuda_lstm.multi_lstm_plain(x_t, w_t, with_res=True)
    dh = torch.zeros(xp.shape[1], sum(h_dims))
    with pytest.raises(ValueError, match="gates must be"):
        cuda_lstm.multi_lstm_bwd(gates[:-1].contiguous(), w_t, allc, dh,
                                 h_dims)
    with pytest.raises(ValueError, match="dhlast is on"):
        cuda_lstm.multi_lstm_bwd(gates, w_t, allc, dh.to("meta"), h_dims)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_lstm.multi_lstm_bwd(gates.to("meta"), w_t.to("meta"),
                                 allc.to("meta"), dh.to("meta"), h_dims)


def test_new_sources_join_the_build():
    names = {p.name for p in _build.sources()}
    assert {"lstm_fwd.cu", "lstm_bwd.cu"} <= names
