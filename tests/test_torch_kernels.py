"""The plain versions of the port's CUDA kernels against the JAX
package's Pallas kernels (interpret mode on the CPU), and the wrappers'
CPU routing, argument checks and build errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.ops.fused as jfused
from factorized_tpu.ops import pallas_lstm, pallas_mfn
from factorized_tpu_torch.ops import _build, cuda_lstm, cuda_mfn

TOL = dict(rtol=2e-4, atol=1e-5)

# the small config of tests/test_pallas_mfn.py: encoders 6/4/5, MFN
# 6/5/4, mem 6, every MLP 8 wide
ENC_H, MFN_H, MEM, S = [6, 4, 5], [6, 5, 4], 6, 8
H_DIMS = ENC_H + MFN_H
DEC_H = [9, 8, 7]


@pytest.fixture
def force_pallas():
    old = jfused.USE_PALLAS
    jfused.USE_PALLAS = True
    yield
    jfused.USE_PALLAS = old


def _encode_inputs(seed, t=6, n=4):
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
    return xp, weights, z_tot


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


def _torch(weights):
    return {k: torch.from_numpy(v) for k, v in weights.items()}


def test_encode_plain_matches_pallas(force_pallas):
    xp, weights, z_tot = _encode_inputs(0)
    h_j, mem_j = pallas_mfn.mfm_encode_pallas(
        jnp.asarray(xp), jnp.zeros((1, 1, 1), jnp.float32),
        {k: jnp.asarray(v) for k, v in weights.items()}, z_tot, False)
    h_p, mem_p = cuda_mfn.mfm_encode_plain(torch.from_numpy(xp),
                                           _torch(weights), z_tot)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(mem_p.numpy(), np.asarray(mem_j), **TOL)


@pytest.mark.parametrize("t", [2, 7])
def test_decoder_plain_matches_pallas(force_pallas, t):
    h0, c0, wsum, b = _decoder_inputs(1)
    args = [jnp.asarray(a) for a in (h0, c0, wsum, b)]
    ref = pallas_lstm._dec_fwd_call(*args, t)     # (allh, allc, gates)
    port = cuda_lstm.decoder_lstm_plain(
        *[torch.from_numpy(a) for a in (h0, c0, wsum, b)], t)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(
        cuda_lstm.decoder_lstm(*[torch.from_numpy(a)
                                 for a in (h0, c0, wsum, b)], t, DEC_H),
        np.asarray(pallas_lstm.decoder_lstm(*args, t)), **TOL)


def test_cpu_tensors_take_the_plain_version_uncounted():
    xp, weights, z_tot = _encode_inputs(2)
    before = (cuda_mfn.LAUNCHES, cuda_lstm.LAUNCHES)
    got = cuda_mfn.mfm_encode(torch.from_numpy(xp), _torch(weights), z_tot,
                              H_DIMS)
    want = cuda_mfn.mfm_encode_plain(torch.from_numpy(xp), _torch(weights),
                                     z_tot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    h0, c0, wsum, b = (torch.from_numpy(a) for a in _decoder_inputs(3))
    for g, w in zip(cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, 5, DEC_H),
                    cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, 5)):
        assert torch.equal(g, w)
    assert (cuda_mfn.LAUNCHES, cuda_lstm.LAUNCHES) == before


def test_encode_wrapper_rejects_bad_arguments():
    xp, weights, z_tot = _encode_inputs(4)
    x, w = torch.from_numpy(xp), _torch(weights)
    with pytest.raises(TypeError, match="float32"):
        cuda_mfn.mfm_encode(x.double(), w, z_tot, H_DIMS)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mfn.mfm_encode(x.transpose(0, 1), w, z_tot, H_DIMS)
    with pytest.raises(ValueError, match="sum to H"):
        cuda_mfn.mfm_encode(x, w, z_tot, H_DIMS[:-1])
    with pytest.raises(ValueError, match="cell boundary"):
        cuda_mfn.mfm_encode(x, w, z_tot + 1, H_DIMS)
    bad = dict(w, a2w2=w["a2w2"][:, :-1].contiguous())
    with pytest.raises(ValueError, match="a2b2 must be"):
        cuda_mfn.mfm_encode(x, bad, z_tot, H_DIMS)
    # a tensor on neither the CPU nor a CUDA card has no route
    meta = {k: v.to("meta") for k, v in w.items()}
    with pytest.raises(ValueError, match="no kernel"):
        cuda_mfn.mfm_encode(x.to("meta"), meta, z_tot, H_DIMS)


def test_decoder_wrapper_rejects_bad_arguments():
    h0, c0, wsum, b = (torch.from_numpy(a) for a in _decoder_inputs(5))
    with pytest.raises(ValueError, match="t must be"):
        cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, 0, DEC_H)
    with pytest.raises(ValueError, match="wsum must be"):
        cuda_lstm.decoder_lstm_fwd(h0, c0, wsum[:, :-4].contiguous(), b, 3,
                                   DEC_H)
    with pytest.raises(ValueError, match="is on"):
        cuda_lstm.decoder_lstm_fwd(h0, c0.to("meta"), wsum, b, 3, DEC_H)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_lstm.decoder_lstm_fwd(*(a.to("meta") for a in (h0, c0, wsum, b)),
                                   3, DEC_H)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_library_is_named_by_its_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert {p.name for p in _build.sources()} >= {"mfm_encode_fwd.cu",
                                                  "lstm_fwd.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
