"""The data flow of the redesigned backward kernels, held on the CPU.

``cuda_mfn.mfm_encode_bwd_passes_plain`` splits the encode's reverse pass
as ``csrc/mfm_encode_bwd.cu`` does (the gates of every step at once, the
memory carry's chain, the attention branch of every step at once, one
chain per LSTM cell) and ``cuda_lstm.decoder_lstm_bwd_cells_plain`` splits
the decoder's backward into one chain per cell, as
``csrc/decoder_lstm_bwd.cu`` does. Each must give what the step-for-step
plain versions give, and what the JAX package's Pallas kernels give in
interpret mode. The launchers' ctypes signatures are held against the C
prototypes, and their fit gate against a refused launch, with the kernel
call faked: there is no card here.

Inputs are made from a seed with numpy. Tolerances: the split against the
step-for-step version atol 1e-5 (the same products summed in another
grouping), against JAX rtol 1e-3 / atol 2e-5 (as
tests/test_torch_kernels_bwd.py), float32."""

import contextlib
import ctypes
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorized_tpu.ops.fused as jfused
from factorized_tpu.ops import pallas_lstm, pallas_mfn
from factorized_tpu_torch.ops import _build, cuda_lstm, cuda_mfn

SPLIT = dict(rtol=0.0, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)

# encoders 6/4/5, MFN 6/5/4 (z_tot 15), mem 6, every MLP 8 wide
ENC_H, MFN_H, MEM, S = [6, 4, 5], [6, 5, 4], 6, 8
H_DIMS = ENC_H + MFN_H
Z_TOT = sum(ENC_H)
DEC_H = [9, 8, 7]
N = 3


@functools.lru_cache(maxsize=None)
def _encode_case(seed, t):
    """Numpy (xp, weights), the JAX forward's residuals and the
    cotangents; cached, so treat as read-only."""
    rng = np.random.default_rng(seed)
    H = sum(H_DIMS)
    m2 = 2 * (H - Z_TOT)

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
    xp = w(t, N, 4 * H, scale=1.0)
    masks = np.array(pallas_mfn.make_dropout_masks(
        jax.random.PRNGKey(seed), t, N, (S,) * 4, (0.5,) * 4))
    fwd = pallas_mfn._fwd_call(jnp.asarray(xp), jnp.asarray(masks),
                               {k: jnp.asarray(v) for k, v in
                                weights.items()}, Z_TOT, True, with_res=True)
    dh = rng.normal(size=(N, H)).astype(np.float32)
    dmem = rng.normal(size=(N, MEM)).astype(np.float32)
    return xp, weights, [np.array(a) for a in fwd[2:]], dh, dmem


def _torch(xp, weights, res, dh, dmem, layout="cat"):
    """The case as torch tensors, the residuals in ``layout``."""
    allh, allc, allmem, cat = (torch.from_numpy(a) for a in res)
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    if layout == "split":
        cat = tuple(cuda_mfn.res_fields(cat, w)[nm].contiguous()
                    for nm in cuda_mfn.RES_NAMES)
    return (torch.from_numpy(xp), w, allh, allc, allmem, cat,
            torch.from_numpy(dh), torch.from_numpy(dmem))


@pytest.mark.parametrize("t", [1, 4, 5])
@pytest.mark.parametrize("layout", ["cat", "split"])
@pytest.mark.parametrize("variant", ["stream", "recompute_att", "two_step"])
def test_passes_match_the_steps(t, layout, variant):
    args = _torch(*_encode_case(t, t), layout)
    recompute = variant == "recompute_att"
    got = cuda_mfn.mfm_encode_bwd_passes_plain(*args, Z_TOT, H_DIMS,
                                               recompute_att=recompute)
    if variant == "two_step":
        if t % 2:
            with pytest.raises(ValueError, match="even t"):
                cuda_mfn.mfm_encode_bwd_two_step_plain(*args, Z_TOT)
            return
        want = cuda_mfn.mfm_encode_bwd_two_step_plain(*args, Z_TOT)
    else:
        want = cuda_mfn.mfm_encode_bwd_steps_plain(
            *args, Z_TOT, recompute_att=recompute)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **SPLIT)


@pytest.mark.parametrize("t", [1, 4, 5])
@pytest.mark.parametrize("recompute", [False, True])
def test_passes_match_pallas(t, recompute):
    """The split, with the weight-gradient reduction over its deltas,
    against the JAX package's ``_bwd_call`` (interpret mode)."""
    xp, weights, res, dh, dmem = _encode_case(10 + t, t)
    dxp_j, dw_j = pallas_mfn._bwd_call(
        jnp.asarray(xp), {k: jnp.asarray(v) for k, v in weights.items()},
        *[jnp.asarray(a) for a in res], jnp.asarray(dh), jnp.asarray(dmem),
        Z_TOT)
    x, w, allh, allc, allmem, cat, ch, cm = _torch(xp, weights, res, dh, dmem)
    dxp, deltas = cuda_mfn.mfm_encode_bwd_passes_plain(
        x, w, allh, allc, allmem, cat, ch, cm, Z_TOT, H_DIMS,
        recompute_att=recompute)
    np.testing.assert_allclose(dxp.numpy(), np.asarray(dxp_j), **GRAD)
    dw = cuda_mfn.mfm_encode_dw_plain(allc, allmem, cat, deltas, w, Z_TOT)
    for k in cuda_mfn.DW_NAMES:
        np.testing.assert_allclose(dw[k].numpy(), np.asarray(dw_j[k]),
                                   **GRAD)


@pytest.mark.parametrize("t", [2, 5, 7])
def test_decoder_cells_match_the_whole(t):
    rng = np.random.default_rng(30 + t)
    H = sum(DEC_H)
    wsum = np.array(jfused.gate_major_blockdiag(
        [(0.4 * rng.normal(size=(h, 4 * h))).astype(np.float32)
         for h in DEC_H], DEC_H))
    b = rng.normal(size=(1, 4 * H)).astype(np.float32)
    h0 = np.tanh(rng.normal(size=(N, H))).astype(np.float32)
    c0 = rng.normal(size=(N, H)).astype(np.float32)
    args = [jnp.asarray(a) for a in (h0, c0, wsum, b)]
    allh, allc, gates = pallas_lstm._dec_fwd_call(*args, t)
    dallh = rng.normal(size=allh.shape).astype(np.float32)
    ref = pallas_lstm._dec_bwd_call(args[2], gates, allc, jnp.asarray(dallh))
    tensors = (torch.from_numpy(wsum), torch.from_numpy(np.array(gates)),
               torch.from_numpy(np.array(allc)), torch.from_numpy(dallh))
    got = cuda_lstm.decoder_lstm_bwd_cells_plain(*tensors, DEC_H)
    whole = cuda_lstm.decoder_lstm_bwd_plain(*tensors)
    for g, w, r in zip(got, whole, ref):
        assert g.shape == w.shape == r.shape
        torch.testing.assert_close(g, w, **SPLIT)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD)


# ------------------------------------------- launchers, the call faked

def _prototype(name):
    """The C parameter kinds of ``name``: 'int', 'int*', 'ptr*' (an
    array of pointers) or 'ptr', from its extern "C" definition."""
    for src in _build.sources():
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{",
                      src.read_text(), re.S)
        if m:
            break
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" not in param:
            kinds.append("int")
        elif param.startswith(("const int*", "int*")):
            kinds.append("int*")
        elif "* const*" in param:
            kinds.append("ptr*")
        else:
            kinds.append("ptr")
    return kinds


def _kind(argtype):
    if argtype is ctypes.c_int:
        return "int"
    if argtype is ctypes.c_void_p:
        return "ptr"
    if argtype is ctypes.POINTER(ctypes.c_int):
        return "int*"
    if argtype is ctypes.POINTER(ctypes.c_void_p):
        return "ptr*"
    raise AssertionError(argtype)


@pytest.fixture
def fake_card(monkeypatch):
    """Fakes the library call: records each call's argtypes and arguments
    and, when ``refuse`` is set, fills the call's ``need`` array as a
    launch past the card's shared memory does. CPU tensors stand in for
    the card's."""
    calls, state = [], {"refuse": None}

    def kernel(name, argtypes, restype=ctypes.c_int):
        def fn(*args):
            calls.append((name, list(argtypes), args))
            if state["refuse"] is not None:
                for k, v in enumerate(state["refuse"]):
                    args[-2][k] = v
                return 1
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for module, counter in ((cuda_mfn, "BWD_LAUNCHES"),
                            (cuda_lstm, "BWD_LAUNCHES")):
        monkeypatch.setattr(module, counter, getattr(module, counter))
    return calls, state


def _launch_encode(variant="stream"):
    x, w, allh, allc, allmem, cat, ch, cm = _torch(*_encode_case(40, 4))
    return cuda_mfn._launch_bwd(x, w, allh, allc, allmem, cat, ch, cm,
                                Z_TOT, H_DIMS, variant)


def _launch_decoder():
    t, H = 4, sum(DEC_H)
    g = torch.Generator().manual_seed(41)
    return cuda_lstm._launch_bwd(
        torch.randn(H, 4 * H, generator=g), torch.randn(t, N, 4 * H,
                                                        generator=g),
        torch.randn(t, N, H, generator=g), torch.randn(t, N, H, generator=g),
        DEC_H)


@pytest.mark.parametrize("name,launch", [("mfm_encode_bwd", _launch_encode),
                                         ("decoder_lstm_bwd",
                                          _launch_decoder)])
def test_launchers_match_the_c_prototypes(fake_card, name, launch):
    calls, _ = fake_card
    launch()
    (called, argtypes, args), = calls
    assert called == name
    assert [_kind(a) for a in argtypes] == _prototype(name)
    assert len(args) == len(argtypes)


def test_encode_launcher_passes_its_knobs(fake_card, monkeypatch):
    calls, _ = fake_card
    monkeypatch.setattr(cuda_mfn, "BWD_THREADS", 256)
    _launch_encode("two_step")
    args = calls[0][2]
    # the variant and the threads precede need and stream
    assert list(args[-4:-2]) == [cuda_mfn.BWD_VARIANTS.index("two_step"),
                                 256]


@pytest.mark.parametrize("variant", cuda_mfn.BWD_VARIANTS)
def test_encode_launcher_carves_its_scratch(fake_card, variant):
    """The gates (t, n, 4H), dcstar and datt (t, n, M2), and att for the
    recompute-att variant, lie one after another in one buffer."""
    calls, _ = fake_card
    _launch_encode(variant)
    args = calls[0][2]
    t, n, H = 4, N, sum(H_DIMS)
    m2 = 2 * (H - Z_TOT)
    gates, dcstar, datt, att = args[20:24]
    assert dcstar - gates == 4 * t * n * 4 * H
    assert datt - dcstar == 4 * t * n * m2
    if variant == "recompute_att":
        assert att - datt == 4 * t * n * m2
    else:
        assert att is None


@pytest.mark.parametrize("name,launch,module,need", [
    ("mfm_encode_bwd", _launch_encode, cuda_mfn, (4, 240960, 232448)),
    ("decoder_lstm_bwd", _launch_decoder, cuda_lstm, (1, 240000, 232448))])
def test_a_refused_fit_raises_and_counts_nothing(fake_card, name, launch,
                                                 module, need):
    """The error names what the kernel reported: the bytes a block needs
    and the card's limit."""
    _, state = fake_card
    state["refuse"] = need
    before = module.BWD_LAUNCHES
    with pytest.raises(ValueError, match=f"{need[1]} bytes of shared memory"
                       f" a block, past the card's {need[2]}"):
        launch()
    assert module.BWD_LAUNCHES == before
