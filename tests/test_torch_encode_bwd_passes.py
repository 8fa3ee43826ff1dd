"""The data flow of the redesigned kernels, held on the CPU.

``cuda_mfn.mfm_encode_bwd_passes_plain`` splits the encode's reverse pass
as ``csrc/mfm_encode_bwd.cu`` does (the gates of every step at once, the
memory carry's chain, the attention branch of every step at once, one
chain per LSTM cell); ``cuda_mfn.mfm_encode_fwd_passes_plain`` splits the
forward as ``csrc/mfm_encode_fwd.cu`` does (one chain per LSTM cell, the
attention branch of every step at once, the memory's chain); and
``cuda_lstm.decoder_lstm_bwd_cells_plain`` and
``multi_lstm_bwd_cells_plain`` split the recurrences' backward into one
chain per cell, as ``csrc/lstm_bwd.cu`` does, the dh product of a cell on
a thread-block cluster formed as ``cell_dh_split_plain`` forms it. Each
must give what the step-for-step plain versions give, and what the JAX
package's Pallas kernels give in interpret mode. The launchers' ctypes
signatures are held against the C prototypes, and their fit gate against
a refused launch and a chain planned to read its weights from L2, with
the kernel call faked: there is no card here.

Inputs are made from a seed with numpy. Tolerances: the split against the
step-for-step version atol 1e-5 (the same products summed in another
grouping), against JAX forward rtol 2e-4 / atol 1e-5 and gradients rtol
1e-3 / atol 2e-5 (as tests/test_torch_kernels.py and
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
from factorized_tpu_torch import perf_probe
from factorized_tpu_torch.ops import _build, cuda_lstm, cuda_mfn

SPLIT = dict(rtol=0.0, atol=1e-5)
FWD = dict(rtol=2e-4, atol=1e-5)
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


@functools.lru_cache(maxsize=None)
def _forward_case(seed, t, masked):
    """Numpy (xp, weights, masks) and the JAX forward's outputs (h_last,
    mem_last, allh, allc, allmem, the residuals in one buffer); all-ones
    masks when not ``masked``."""
    xp, weights, _, _, _ = _encode_case(seed, t)
    S4 = (S,) * 4
    masks = (np.array(pallas_mfn.make_dropout_masks(
        jax.random.PRNGKey(seed + 100), t, N, S4, (0.5,) * 4)) if masked
        else np.ones((t, N, 4 * S), np.float32))
    fwd = pallas_mfn._fwd_call(jnp.asarray(xp), jnp.asarray(masks),
                               {k: jnp.asarray(v) for k, v in
                                weights.items()}, Z_TOT, True, with_res=True)
    return xp, weights, masks, [np.array(a) for a in fwd]


@pytest.mark.parametrize("t", [1, 4, 5])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("layout", [None, "cat", "split"])
def test_forward_passes_match_the_steps_and_pallas(t, masked, layout):
    """The forward's three passes, eval (no residuals) and train in both
    layouts, with and without masks, against the step-for-step plain
    versions and the JAX package's ``_fwd_call`` (interpret mode)."""
    xp, weights, masks, ref = _forward_case(20 + t, t, masked)
    x, m = torch.from_numpy(xp), torch.from_numpy(masks)
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    if layout is None:
        got = cuda_mfn.mfm_encode_fwd_passes_plain(
            x, w, Z_TOT, H_DIMS, m if masked else None)
        want = cuda_mfn.mfm_encode_plain(x, w, Z_TOT, m if masked else None)
        ref = ref[:2]
    else:
        got = cuda_mfn.mfm_encode_fwd_passes_plain(x, w, Z_TOT, H_DIMS, m,
                                                   True, layout)
        want = cuda_mfn.mfm_encode_res_plain(x, m, w, Z_TOT, layout)
        if layout == "split":
            got = (*got[:5], torch.cat(got[5], dim=2))
            want = (*want[:5], torch.cat(want[5], dim=2))
    assert len(got) == len(want) == len(ref)
    for g, s, r in zip(got, want, ref):
        assert g.shape == s.shape == r.shape
        torch.testing.assert_close(g, s, **SPLIT)
        np.testing.assert_allclose(g.numpy(), r, **FWD)


@pytest.mark.parametrize("h_dims", [[6, 4, 5, 15], [12, 13, 9], [120, 8]],
                         ids=["kl_ef", "missing", "past_one_block"])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_multi_cells_match_the_whole_and_pallas(h_dims, cluster):
    """One chain per cell, each cell's dh product split as a cluster of
    ``cluster`` blocks forms it, against the whole and ``_enc_bwd_call``
    (interpret mode); [120, 8] holds a cell past one block's shared
    memory."""
    rng = np.random.default_rng(sum(h_dims) + cluster)
    t, H = 3, sum(h_dims)
    wh = np.array(jfused.gate_major_blockdiag(
        [(0.4 * rng.normal(size=(h, 4 * h))).astype(np.float32)
         for h in h_dims], h_dims))
    xp = rng.normal(size=(t, N, 4 * H)).astype(np.float32)
    _, _, allc, gates = pallas_lstm._enc_fwd_call(jnp.asarray(xp),
                                                  jnp.asarray(wh))
    dh = rng.normal(size=(N, H)).astype(np.float32)
    ref = pallas_lstm._enc_bwd_call(gates, jnp.asarray(wh), allc,
                                    jnp.asarray(dh))
    tensors = (torch.from_numpy(np.array(gates)), torch.from_numpy(wh),
               torch.from_numpy(np.array(allc)), torch.from_numpy(dh))
    got = cuda_lstm.multi_lstm_bwd_cells_plain(*tensors, h_dims, cluster)
    torch.testing.assert_close(got, cuda_lstm.multi_lstm_bwd_plain(*tensors),
                               **SPLIT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


@pytest.mark.parametrize("h", [5, 8, 120])
@pytest.mark.parametrize("cluster", [2, 4])
def test_gate_split_partials_add_to_the_whole(h, cluster):
    """A cluster's blocks hold runs of the fewest multiple of 4 gate
    columns that cover the cell's 4h; their partial dh, added in rank
    order, are the whole product."""
    kc = cuda_lstm.cluster_columns(h, cluster)
    assert kc % 4 == 0 and kc - 4 < 4 * h / cluster <= kc
    assert cuda_lstm.cluster_columns(h, 1) == 4 * h
    rng = np.random.default_rng(h * cluster)
    dg = torch.from_numpy(rng.normal(size=(N, 4 * h)).astype(np.float32))
    wcell = torch.from_numpy(rng.normal(size=(h, 4 * h)).astype(np.float32))
    # sums of 4h unit-normal products, of size up to 30 at h = 120, in
    # another grouping: a relative tolerance as well
    torch.testing.assert_close(cuda_lstm.cell_dh_split_plain(dg, wcell,
                                                             cluster),
                               dg @ wcell.T, rtol=1e-5, atol=1e-5)


# ------------------------------------------- launchers, the call faked

def _prototype(name):
    """The C parameter kinds of ``name``: 'int', 'int*', 'i64', 'i64*',
    'ptr*' (an array of pointers) or 'ptr', from its extern "C"
    definition."""
    for src in _build.sources():
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{",
                      src.read_text(), re.S)
        if m:
            break
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if param.removeprefix("const ").startswith("long long"):
            kinds.append("i64*" if "*" in param else "i64")
        elif "*" not in param:
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
    if argtype is ctypes.c_longlong:
        return "i64"
    if argtype is ctypes.POINTER(ctypes.c_longlong):
        return "i64*"
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
    calls, state = [], {"refuse": None, "clusters": (1, 1)}

    def kernel(name, argtypes, restype=ctypes.c_int):
        def fn(*args):
            calls.append((name, list(argtypes), args))
            if state["refuse"] is not None:
                for k, v in enumerate(state["refuse"]):
                    args[-2][k] = v
                return 1
            args[-2][4], args[-2][5] = state["clusters"]
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for module, counter in ((cuda_mfn, "BWD_LAUNCHES"),
                            (cuda_mfn, "LAUNCHES"),
                            (cuda_lstm, "BWD_LAUNCHES"),
                            (cuda_lstm, "MULTI_BWD_LAUNCHES"),
                            (cuda_lstm, "LAUNCHES"),
                            (cuda_lstm, "MULTI_LAUNCHES")):
        monkeypatch.setattr(module, counter, getattr(module, counter))
    for module in (cuda_mfn, cuda_lstm):
        monkeypatch.setattr(module, "CLUSTERS", {})
        monkeypatch.setattr(module, "L2_LAUNCHES", {})
        monkeypatch.setattr(module, "SCRATCH_LAUNCHES", {})
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


def _launch_forward(layout="cat"):
    xp, weights, masks, _ = _forward_case(42, 4, True)
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    return cuda_mfn._launch_fwd(torch.from_numpy(xp),
                                torch.from_numpy(masks), w, Z_TOT, H_DIMS,
                                layout)


def _launch_multi():
    t, H = 4, sum(DEC_H)
    g = torch.Generator().manual_seed(43)
    return cuda_lstm._launch_multi_bwd(
        torch.randn(t, N, 4 * H, generator=g),
        torch.randn(H, 4 * H, generator=g),
        torch.randn(t, N, H, generator=g), torch.randn(N, H, generator=g),
        DEC_H)


def _launch_decoder_fwd():
    t, H = 4, sum(DEC_H)
    g = torch.Generator().manual_seed(44)
    return cuda_lstm._launch(
        torch.randn(N, H, generator=g), torch.randn(N, H, generator=g),
        torch.randn(H, 4 * H, generator=g), torch.randn(1, 4 * H, generator=g),
        t, DEC_H)


def _launch_multi_fwd(with_res):
    t, H = 4, sum(DEC_H)
    g = torch.Generator().manual_seed(45)
    return cuda_lstm._launch_multi(torch.randn(t, N, 4 * H, generator=g),
                                   torch.randn(H, 4 * H, generator=g),
                                   DEC_H, with_res)


LAUNCHERS = [("mfm_encode_bwd", _launch_encode, cuda_mfn, "BWD_LAUNCHES"),
             ("decoder_lstm_bwd", _launch_decoder, cuda_lstm,
              "BWD_LAUNCHES"),
             ("mfm_encode_fwd", _launch_forward, cuda_mfn, "LAUNCHES"),
             ("multi_lstm_bwd", _launch_multi, cuda_lstm,
              "MULTI_BWD_LAUNCHES"),
             ("decoder_lstm_fwd", _launch_decoder_fwd, cuda_lstm,
              "LAUNCHES"),
             ("multi_lstm_fwd", functools.partial(_launch_multi_fwd, False),
              cuda_lstm, "MULTI_LAUNCHES"),
             ("multi_lstm_fwd", functools.partial(_launch_multi_fwd, True),
              cuda_lstm, "MULTI_LAUNCHES")]
LAUNCHER_IDS = ["mfm_encode_bwd", "decoder_lstm_bwd", "mfm_encode_fwd",
                "multi_lstm_bwd", "decoder_lstm_fwd", "multi_lstm_fwd_eval",
                "multi_lstm_fwd_train"]


@pytest.mark.parametrize("name,launch", [case[:2] for case in LAUNCHERS],
                         ids=LAUNCHER_IDS)
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
    # the variant, the threads and the chains' rows (one lane's: the
    # two-step variant's only ones) precede the lanes (one, no lane axis),
    # the lane strides, fit and stream
    assert list(args[-8:-3]) == [cuda_mfn.BWD_VARIANTS.index("two_step"),
                                 256, cuda_mfn.BWD_MEM_ROWS,
                                 cuda_mfn.BWD_CELL_ROWS, 1]


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


def test_forward_launcher_passes_its_rows(fake_card, monkeypatch):
    """Without a lane axis the chains' rows are the source's one-lane
    constants, chosen there by whether residuals are written: with and
    without them the call passes the cell widths, the threads and 0 for
    each chain's rows (the LSTM chains', the memory chain's) before the
    lanes (one), the lane strides, fit and stream."""
    calls, _ = fake_card
    monkeypatch.setattr(cuda_mfn, "THREADS", 256)
    _launch_forward(None)
    _launch_forward("split")
    for _, argtypes, args in calls:
        assert [_kind(k) for k in argtypes[-8:]] == [
            "int*", "int", "int", "int", "int", "i64*", "int*", "ptr"]
        assert list(args[-7:-3]) == [256, 0, 0, 1]


@pytest.mark.parametrize("macro", sorted(perf_probe.ROW_SWEEPS))
def test_row_sweep_macros_are_the_sources_constants(macro):
    """Each row count the sweep overrides is one macro of one source, a
    default that a -D flag replaces, and that default is one of the
    values the sweep times."""
    found = [int(m.group(1)) for src in _build.sources()
             for m in re.finditer(rf"#ifndef {macro}\n#define {macro} (\d+)\n"
                                  rf"#endif", src.read_text())]
    assert len(found) == 1
    assert found[0] in perf_probe.ROW_SWEEPS[macro]


@pytest.mark.parametrize("name,launch,module,counter", LAUNCHERS,
                         ids=LAUNCHER_IDS)
def test_launchers_record_their_clusters(fake_card, name, launch, module,
                                         counter):
    """The clusters the kernel reports it launched its chains on are kept
    by the wrapper, one per chain."""
    _, state = fake_card
    state["clusters"] = (2, 4)
    before = getattr(module, counter)
    launch()
    assert getattr(module, counter) == before + 1
    assert module.CLUSTERS[name] in ((2, 4), 2)
    assert module.L2_LAUNCHES == {}


@pytest.mark.parametrize("name,launch,module,counter", LAUNCHERS,
                         ids=LAUNCHER_IDS)
@pytest.mark.parametrize("plans", [(0, 0), (0, 1), (1, 0)])
def test_a_chain_past_a_cluster_of_8_reads_from_l2_and_is_counted(
        fake_card, name, launch, module, counter, plans):
    """Where the kernel's plan, made from the widths before the launch,
    reads a chain's weights from L2 (plan 0), the wrapper records the plan,
    counts the launch in its counter and in ``L2_LAUNCHES``, and nothing
    raises; a one-chain kernel reports its chain in the first slot."""
    _, state = fake_card
    state["clusters"] = plans
    before = getattr(module, counter)
    launch()
    assert getattr(module, counter) == before + 1
    recorded = module.CLUSTERS[name]
    assert recorded in (plans, plans[0])
    l2 = 0 in (recorded if isinstance(recorded, tuple) else (recorded,))
    assert module.L2_LAUNCHES == ({name: 1} if l2 else {})


@pytest.mark.parametrize("name,launch,module,counter", LAUNCHERS,
                         ids=LAUNCHER_IDS)
def test_a_chain_past_a_blocks_state_gets_its_scratch_and_is_counted(
        monkeypatch, fake_card, name, launch, module, counter):
    """Where a chain's plan keeps its per-row state in device memory, the
    launcher asks for that scratch (``NEED_SCRATCH``, its floats in the
    need argument) and launches nothing; the wrapper calls it once more
    with a scratch of that size, records the plan and counts the launch
    once, in its counter and in ``SCRATCH_LAUNCHES``."""
    calls = []

    def kernel(kname, argtypes, restype=ctypes.c_int):
        at = argtypes.index(ctypes.POINTER(ctypes.c_longlong))

        def fn(*args):
            calls.append((args[at - 2], args[at - 1]))
            args[at]._obj.value = 1000
            if args[at - 1] < 1000:
                return cuda_lstm.NEED_SCRATCH
            args[-2][4], args[-2][5] = cuda_lstm.SCRATCH, 1
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", kernel)
    empty = torch.empty
    sizes = []

    def recording_empty(*shape, **kw):
        out = empty(*shape, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    before = getattr(module, counter)
    launch()
    assert [c[1] for c in calls] == [0, 1000]
    assert calls[0][0] is None and calls[1][0] is not None
    assert 1000 in sizes
    assert getattr(module, counter) == before + 1
    plan = module.CLUSTERS[name]
    assert plan in ((cuda_lstm.SCRATCH, 1), cuda_lstm.SCRATCH)
    assert module.SCRATCH_LAUNCHES == {name: 1}
    assert module.L2_LAUNCHES == {}


@pytest.mark.parametrize("name,launch,module,counter,need", [
    ("mfm_encode_bwd", _launch_encode, cuda_mfn, "BWD_LAUNCHES",
     (4, 240960, 232448, 0)),
    ("decoder_lstm_bwd", _launch_decoder, cuda_lstm, "BWD_LAUNCHES",
     (1, 240000, 232448, 0)),
    ("mfm_encode_fwd", _launch_forward, cuda_mfn, "LAUNCHES",
     (3, 262144, 232448, 0)),
    ("multi_lstm_bwd", _launch_multi, cuda_lstm, "MULTI_BWD_LAUNCHES",
     (1, 250000, 232448, 0)),
    ("decoder_lstm_fwd", _launch_decoder_fwd, cuda_lstm, "LAUNCHES",
     (1, 245000, 232448, 0)),
    ("multi_lstm_fwd", functools.partial(_launch_multi_fwd, True),
     cuda_lstm, "MULTI_LAUNCHES", (1, 255000, 232448, 0))],
    ids=LAUNCHER_IDS[:5] + ["multi_lstm_fwd"])
def test_a_refused_fit_raises_and_counts_nothing(fake_card, name, launch,
                                                 module, counter, need):
    """A refusal the launcher reports (no width reaches one since the
    chains' scratch plan; the launchers keep the gate) raises, naming what
    it reported: the bytes a block needs, the card's limit, and the
    widths."""
    _, state = fake_card
    state["refuse"] = need
    before = getattr(module, counter)
    with pytest.raises(ValueError, match=f"{need[1]} bytes of shared memory"
                       f" a block, past the card's {need[2]}, even with its"
                       f" weights read from L2: .*cells"):
        launch()
    assert getattr(module, counter) == before
    assert name not in module.CLUSTERS
    assert module.L2_LAUNCHES == {}


# ------------------------------------------ the weight-gradient kernel

def _dw_case(t, n, widths, seed=50):
    """Random operands of the weight-gradient kernel as torch tensors on
    the CPU: (weights, allc, allmem, res, deltas); ``widths`` (H, z_tot,
    mem, s1, s2, s3, s4)."""
    H, z_tot, mem, s1, s2, s3, s4 = widths
    m2 = 2 * (H - z_tot)
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    weights = {"wh": draw(H, 4 * H), "a1w1": draw(m2, s1),
               "a1b1": draw(1, s1), "a1w2": draw(s1, m2),
               "a1b2": draw(1, m2), "a2w1": draw(m2, s2),
               "a2b1": draw(1, s2), "a2w2": draw(s2, mem),
               "a2b2": draw(1, mem), "gw1": draw(m2 + mem, s3 + s4),
               "gb1": draw(1, s3 + s4), "g1w2": draw(s3, mem),
               "g1b2": draw(1, mem), "g2w2": draw(s4, mem),
               "g2b2": draw(1, mem)}
    return (weights, draw(t, n, H), draw(t, n, mem),
            draw(t, n, cuda_mfn.res_layout(weights)[1]),
            draw(t, n, cuda_mfn.delta_layout(weights)[1]))


@pytest.fixture
def fake_dw(monkeypatch):
    """Fakes the weight-gradient kernel's library call: records its
    argtypes and arguments and reports 16-byte copies."""
    calls = []

    def kernel(name, argtypes, restype=ctypes.c_int):
        def fn(*args):
            calls.append((name, list(argtypes), args))
            args[-2][0] = 16
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_mfn, "DW_LAUNCHES", cuda_mfn.DW_LAUNCHES)
    monkeypatch.setattr(cuda_mfn, "DW_PLAN", {})
    return calls


def test_weight_gradient_launcher_fills_one_buffer(fake_dw):
    """The 14 gradients are contiguous views of one buffer, each shaped
    like its weight, one after another in ``DW_NAMES`` order (the order
    in which the kernel writes them); the call passes that buffer, the
    cluster size ``dw_cluster`` picks and the C prototype's arguments."""
    widths = (30, 15, 6, 8, 8, 8, 8)
    weights, allc, allmem, res, deltas = _dw_case(4, N, widths)
    before = cuda_mfn.DW_LAUNCHES
    got = cuda_mfn._launch_dw(weights, allc, allmem, res, deltas, widths[1])
    (name, argtypes, args), = fake_dw
    assert name == "mfm_encode_dw"
    assert [_kind(a) for a in argtypes] == _prototype(name)
    assert len(args) == len(argtypes)
    assert list(got) == list(cuda_mfn.DW_NAMES)
    at = args[6]  # out, after allc, allmem, the table and delta
    for k in cuda_mfn.DW_NAMES:
        g = got[k]
        assert g.shape == weights[k].shape and g.is_contiguous(), k
        assert g.data_ptr() == at, k
        at += 4 * g.numel()
    assert len({g.untyped_storage().data_ptr() for g in got.values()}) == 1
    assert got["g2b2"].untyped_storage().nbytes() == at - args[6]
    # the cluster, then the lanes (one) and their strides, copy, stream
    assert args[-5] == cuda_mfn.dw_cluster(weights, 4 * N)
    assert args[-4] == 1
    assert cuda_mfn.DW_LAUNCHES == before + 1
    assert cuda_mfn.DW_PLAN == {"cluster": args[-5], "copy_bytes": 16}


@pytest.mark.parametrize("widths,t,n,cluster", [
    ((632, 120, 400, 128, 128, 256, 256), 20, 32, 1),
    ((15, 6, 6, 8, 8, 8, 8), 5, 20, 2),
    ((320, 120, 64, 128, 128, 128, 128), 20, 32, 4),
    ((15, 6, 6, 8, 8, 8, 8), 20, 32, 8),
    ((320, 120, 64, 128, 128, 128, 128), 1, 1, 1),
    ((320, 120, 64, 128, 128, 128, 128), 1, 32, 1)],
    ids=["widest", "small-100-rows", "main", "small", "one-row",
         "one-step"])
def test_weight_gradient_cluster_size(widths, t, n, cluster):
    """The smallest S of 1, 2, 4, 8 whose S x tiles reaches DW_BLOCKS,
    doubled only while each slice keeps a chunk of rows: the main path's
    80 tiles of 64 x 64 take S = 4, the widest encode's 350 one block
    each, and K = t n under two chunks one block."""
    weights = _dw_case(1, 1, widths)[0]
    assert cuda_mfn.dw_cluster(weights, t * n) == cluster


@pytest.mark.parametrize("name,value", [("kDwTile", cuda_mfn.DW_TILE),
                                        ("kDwChunk", cuda_mfn.DW_CHUNK)])
def test_weight_gradient_tile_is_the_sources(name, value):
    """The tile and chunk that ``dw_cluster`` plans with are the kernel's
    constants in ``csrc/mfm_encode_bwd.cu``."""
    src = (_build.CSRC / "mfm_encode_bwd.cu").read_text()
    assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(value)]


@pytest.mark.parametrize("t", [1, 3])
def test_weight_gradients_at_unequal_odd_widths_match_pallas(t):
    """``mfm_encode_dw_plain`` on the plain reverse pass's deltas against
    the JAX package's ``_bwd_call`` (interpret mode) at widths whose
    residual and delta columns start at odd offsets: MLPs 7, 9, 5 and 3
    wide, mem 5."""
    s1, s2, s3, s4, mem = 7, 9, 5, 3, 5
    rng = np.random.default_rng(60 + t)
    H = sum(H_DIMS)
    m2 = 2 * (H - Z_TOT)

    def w(*shape, scale=0.4):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    weights = {
        "wh": np.array(jfused.gate_major_blockdiag(
            [w(h, 4 * h) for h in H_DIMS], H_DIMS)),
        "a1w1": w(m2, s1), "a1b1": w(1, s1), "a1w2": w(s1, m2),
        "a1b2": w(1, m2), "a2w1": w(m2, s2), "a2b1": w(1, s2),
        "a2w2": w(s2, mem), "a2b2": w(1, mem), "gw1": w(m2 + mem, s3 + s4),
        "gb1": w(1, s3 + s4), "g1w2": w(s3, mem), "g1b2": w(1, mem),
        "g2w2": w(s4, mem), "g2b2": w(1, mem)}
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    xp = w(t, N, 4 * H, scale=1.0)
    masks = np.array(pallas_mfn.make_dropout_masks(
        jax.random.PRNGKey(t), t, N, (s1, s2, s3, s4), (0.5,) * 4))
    res = [np.array(a) for a in pallas_mfn._fwd_call(
        jnp.asarray(xp), jnp.asarray(masks), jw, Z_TOT, True,
        with_res=True)[2:]]
    dh, dmem = w(N, H, scale=1.0), w(N, mem, scale=1.0)
    _, dw_j = pallas_mfn._bwd_call(jnp.asarray(xp), jw,
                                   *[jnp.asarray(a) for a in res],
                                   jnp.asarray(dh), jnp.asarray(dmem), Z_TOT)
    x, wt, allh, allc, allmem, cat, ch, cm = _torch(xp, weights, res, dh,
                                                    dmem)
    _, deltas = cuda_mfn.mfm_encode_bwd_steps_plain(x, wt, allh, allc,
                                                    allmem, cat, ch, cm,
                                                    Z_TOT)
    assert cuda_mfn.delta_layout(wt)[0]["dq2"][0] % 2 == 1
    dw = cuda_mfn.mfm_encode_dw_plain(allc, allmem, cat, deltas, wt, Z_TOT)
    for k in cuda_mfn.DW_NAMES:
        assert tuple(dw[k].shape) == dw_j[k].shape, k
        np.testing.assert_allclose(dw[k].numpy(), np.asarray(dw_j[k]),
                                   **GRAD)
