"""The lane plans of the kernels that take lanes by stride, plain
arithmetic on the CPU: ``cuda_mfn.bwd_plan`` (the rows a block of the
reverse pass's memory chain and LSTM chains), ``cuda_mfn.dw_cluster``
(the cluster of the weight gradients), ``cuda_mfn.fwd_plan`` (the encode
forward's LSTM chains and memory chain, train and eval),
``cuda_lstm.chain_fwd_plan`` (the decoders' and the encoder cells' chain
forward, train and eval) and ``cuda_lstm.chain_bwd_plan`` (their chain
backward), the launches their launchers count, and the rows they pass,
the kernel call faked (there is no card here) and its arguments held to
the launcher's ctypes types. On the card the plans take
what the card holds at once from the CUDA occupancy calculator
(``cuda_lstm.chain_wave`` over each kernel's ``*_wave`` entry point);
here each test hands them a stand-in, and ``tests/test_torch_cuda.py``
holds the plans against the card's own occupancy."""

import contextlib
import functools
import ctypes
import math
import re
import types

import pytest
import torch

from factorized_tpu_torch.config import best_acc_mosi_config
from factorized_tpu_torch.ops import _build, cuda_lstm, cuda_mfn

LANES = (1, 2, 4, 8, 16, 32, 64)
CFG = best_acc_mosi_config()
# the encode's fused cells at best_acc_mosi_config: the encoders' LSTMs,
# then the MFN's
H_DIMS = [CFG.zl_size, CFG.za_size, CFG.zv_size, *CFG.h_dims]
H, Z_TOT = sum(H_DIMS), CFG.zl_size + CFG.za_size + CFG.zv_size
MEM, N, T = CFG.memsize, CFG.batchsize, CFG.seqlength
S1, S2, S3, S4 = (CFG.att1_shape, CFG.att2_shape, CFG.gamma1_shape,
                  CFG.gamma2_shape)


def _weights(lanes=0):
    m2 = 2 * (H - Z_TOT)
    shapes = {"wh": (H, 4 * H), "a1w1": (m2, S1), "a1b1": (1, S1),
              "a1w2": (S1, m2), "a1b2": (1, m2), "a2w1": (m2, S2),
              "a2b1": (1, S2), "a2w2": (S2, MEM), "a2b2": (1, MEM),
              "gw1": (m2 + MEM, S3 + S4), "gb1": (1, S3 + S4),
              "g1w2": (S3, MEM), "g1b2": (1, MEM), "g2w2": (S4, MEM),
              "g2b2": (1, MEM)}
    lead = (lanes,) if lanes else ()
    return {k: torch.zeros(lead + s) for k, s in shapes.items()}


def _bytes(chain, R, C):
    """A chain's shared memory a block at R rows on a cluster of C."""
    if chain == "memory_chain":
        return cuda_mfn._mem_bwd_bytes(MEM, S3 + S4, C, R,
                                       cuda_mfn.BWD_THREADS)
    return cuda_lstm.cell_chain_bytes(H_DIMS, R, cuda_mfn.BWD_THREADS,
                                      cuda_mfn.BWD_CELL_OP_WIDTH, C)


# stand-ins for what the card holds at once: 132 SMs, each holding one
# block, or as many as 228 KB of shared memory allow, or fewer for the
# wider row counts (as registers may have it)
WAVES = {
    "one_a_sm": lambda chain, R, plan, smem: 132,
    "by_shared_memory": lambda chain, R, plan, smem: 132 * min(
        4, 233472 // (smem + 1024)),
    "fewer_for_more_rows": lambda chain, R, plan, smem: 132 * (
        4 if R <= 2 else 2 if R <= 4 else 1),
}


def _plan(K, n=N, wave=WAVES["by_shared_memory"]):
    return cuda_mfn.bwd_plan(H_DIMS, S3, S4, MEM, n, K, wave)


def test_the_main_widths_are_the_ones_measured():
    """The encode the plans below are made for: 6 cells, 320 units."""
    assert H_DIMS == [32, 8, 80, 88, 64, 48] and (MEM, S3, S4) == (64, 128,
                                                                   128)


@pytest.mark.parametrize("K", LANES)
def test_one_lane_keeps_todays_rows_and_slices(K):
    """One lane takes the measured one-lane rows (the memory chain 1 row a
    block, the LSTM chains 2) at any batch, the training batch of 32 and
    the 128 of the ``best_mfn_mosi_config`` runs alike, and asks the card
    nothing; the weight gradients' cluster of 4 is the same at every K,
    so every lane sums in the one-lane order."""
    def unasked(*args):
        raise AssertionError(f"one lane asked for a wave: {args}")

    for n in (1, 32, 128, 1000):
        for lanes in (0, 1):
            one = _plan(lanes, n, unasked)
            assert one["memory_chain"]["rows"] == cuda_mfn.BWD_MEM_ROWS == 1
            assert one["lstm_chains"]["rows"] == cuda_mfn.BWD_CELL_ROWS == 2
            assert one["lstm_chains"]["waves"] is None
    assert cuda_mfn.dw_cluster(_weights(), T * N) == 4
    assert cuda_mfn.dw_cluster(_weights(K), T * N) == 4


def _waves(chain, R, K, chains, wave):
    """(chain plan, waves, blocks, wave) of a chain at R rows over K
    lanes, what the card holds at once given by ``wave``."""
    plan = cuda_lstm.chain_plan(lambda C: _bytes(chain, R, C))
    smem = 0 if plan == cuda_lstm.SCRATCH else _bytes(chain, R, plan)
    held = wave(chain, R, plan, smem)
    blocks = K * math.ceil(N / R) * chains * max(plan, 1)
    return plan, math.ceil(blocks / held), blocks, held


@pytest.mark.parametrize("K", LANES)
def test_the_chains_blocks_stay_within_the_waves_the_plan_aims_at(K):
    """Each chain's blocks are K x row tiles x chains x the cluster, and
    they take the fewest waves of what the card holds at once (whatever
    the card reports for each row count, plan and shared memory) that any
    row count of the one-lane order of summation reaches, one wave
    wherever one is reachable; the smallest such count. One lane takes
    the first count."""
    chains = {"memory_chain": 1, "lstm_chains": len(H_DIMS)}
    counts = {"memory_chain": cuda_mfn.BWD_MEM_ROW_COUNTS,
              "lstm_chains": cuda_mfn.BWD_CELL_ROW_COUNTS}
    for name, wave in WAVES.items():
        for chain, p in _plan(K, wave=wave).items():
            if K == 1:
                assert p["rows"] == counts[chain][0], name
                continue
            first = _waves(chain, counts[chain][0], K, chains[chain],
                           wave)[0]
            plan, waves, blocks, held = _waves(chain, p["rows"], K,
                                               chains[chain], wave)
            assert (p["plan"], p["waves"], p["blocks"], p["wave"]) == (
                plan, waves, blocks, held), name
            assert plan == first  # the one-lane order of summation
            reach = {R: _waves(chain, R, K, chains[chain], wave)
                     for R in counts[chain]}
            reach = {R: w[1] for R, w in reach.items() if w[0] == first}
            assert waves == min(reach.values()), name
            assert p["rows"] == min(R for R, w in reach.items()
                                    if w == waves), name


@pytest.mark.parametrize("K", LANES)
@pytest.mark.parametrize("n", [1, 5, 32, 100])
def test_the_rows_tile_the_batch(K, n):
    """R divides the padded rows the row tiles cover, which hold the
    batch with less than one tile to spare."""
    for wave in WAVES.values():
        for p in _plan(K, n, wave).values():
            R, padded = p["rows"], p["padded_rows"]
            assert padded % R == 0 and padded == p["row_tiles"] * R
            assert n <= padded < n + R


def test_no_count_that_sums_in_another_order_is_taken():
    """At the main widths 16 rows of an LSTM chain pass one block's
    shared memory and would take a cluster of 2, which sums dh in
    another order: no lane count takes them, however many blocks the card
    holds; likewise a memory chain past a block at its first count keeps
    its cluster."""
    at16 = cuda_lstm.chain_plan(lambda C: cuda_lstm.cell_chain_bytes(
        H_DIMS, 16, cuda_mfn.BWD_THREADS, cuda_mfn.BWD_CELL_OP_WIDTH, C))
    assert at16 == 2
    for wave in WAVES.values():
        for K in LANES:
            assert _plan(K, wave=wave)["lstm_chains"]["rows"] != 16
        wide = cuda_mfn.bwd_plan(H_DIMS, 600, 600, 128, N, 32,
                                 wave)["memory_chain"]
        assert wide["plan"] == cuda_mfn.bwd_plan(
            H_DIMS, 600, 600, 128, N, 1, wave)["memory_chain"]["plan"]


@pytest.mark.parametrize("K", LANES)
def test_the_weight_gradients_blocks(K):
    """K x tiles x S blocks, S one lane's cluster at every K (one slice
    of each tile's rows a block of the cluster): the smallest whose S x
    80 tiles reach ``DW_BLOCKS``, each slice a full chunk of rows."""
    w = _weights(K)
    tiles = sum(math.ceil(w[k].shape[-2] / cuda_mfn.DW_TILE)
                * math.ceil(w[k].shape[-1] / cuda_mfn.DW_TILE)
                for k in ("a1w1", "a1w2", "a2w1", "a2w2", "gw1", "g1w2",
                          "g2w2"))
    assert tiles == 80
    S = cuda_mfn.dw_cluster(w, T * N)
    assert S == cuda_mfn.dw_cluster(_weights(), T * N) == 4
    assert S * tiles >= cuda_mfn.DW_BLOCKS > S // 2 * tiles
    assert T * N >= 2 * S * cuda_mfn.DW_CHUNK


def test_the_row_counts_are_the_sources():
    """The counts the plan chooses among are the ones the source
    instantiates."""
    src = (_build.CSRC / "mfm_encode_bwd.cu").read_text()
    for name, counts in (("kMemRowCounts", cuda_mfn.BWD_MEM_ROW_COUNTS),
                         ("kCellRowCounts", cuda_mfn.BWD_CELL_ROW_COUNTS)):
        m = re.search(rf"constexpr int {name}\[\] = \{{([\d, ]+)\}};", src)
        assert tuple(int(v) for v in m.group(1).split(",")) == counts


# the argument types of each faked library function
ARGTYPES = {}
# the wave queries' chains, by C entry point
EXPORTS = dict(cuda_lstm.WAVE_EXPORTS.values())
# the plans and wave queries cached across calls
CACHED = (cuda_mfn._bwd_plan, cuda_mfn._fwd_plan, cuda_lstm._chain_bwd_plan,
          cuda_lstm._chain_fwd_plan, cuda_lstm._chain_wave)


@pytest.fixture
def fake_library(monkeypatch):
    """The kernels' library faked: each call recorded, its arguments
    converted by ctypes to the launcher's declared types (a wrong type
    raises, as the real call would), fit and copy reported as a launch on
    one block and 16-byte copies. CPU tensors stand in for the card's."""
    calls = []

    def kernel(name, argtypes, restype=ctypes.c_int):
        ARGTYPES[name] = list(argtypes)
        typed = ctypes.CFUNCTYPE(restype, *argtypes)(lambda *a: 0)

        def fn(*args):
            typed(*args)
            calls.append((name, args))
            if name in EXPORTS:
                args[-1][0] = WAVES["by_shared_memory"](
                    EXPORTS[name][args[0]], *args[1:3], args[4])
                return 0
            if name == "mfm_encode_dw":
                args[-2][0] = 16
            else:
                args[-2][4] = args[-2][5] = 1
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for cached in CACHED:
        cached.cache_clear()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for module, names in (
            (cuda_mfn, ("LAUNCHES", "BWD_LAUNCHES", "DW_LAUNCHES",
                        "CLUSTERS", "L2_LAUNCHES", "SCRATCH_LAUNCHES",
                        "BWD_PLAN", "DW_PLAN", "FWD_PLAN")),
            (cuda_lstm, ("LAUNCHES", "MULTI_LAUNCHES", "BWD_LAUNCHES",
                         "MULTI_BWD_LAUNCHES", "CLUSTERS", "L2_LAUNCHES",
                         "SCRATCH_LAUNCHES", "FWD_PLAN", "BWD_PLAN",
                         "LANE_LAUNCHES"))):
        for name in names:
            value = getattr(module, name)
            monkeypatch.setattr(module, name,
                                value if isinstance(value, int) else {})
    yield calls
    for cached in CACHED:
        cached.cache_clear()


@pytest.mark.parametrize("K", [2, 8, 9, 32])
def test_each_lane_kernel_counts_one_launch_a_call(fake_library, K):
    """The reverse pass and the weight gradients over K lanes: one launch
    each, counted once, and the chains' rows of ``bwd_plan`` passed; the
    recurrences' forward, the decoders' and the encoder cells', one launch
    a call too, at any K."""
    t, n = 2, 3
    w = _weights(K)
    m2 = w["a1w1"].shape[1]
    R = cuda_mfn.res_layout({k: v[0] for k, v in w.items()})[1]
    D = cuda_mfn.delta_layout({k: v[0] for k, v in w.items()})[1]
    z = torch.zeros
    before = (cuda_mfn.BWD_LAUNCHES, cuda_mfn.DW_LAUNCHES)
    dxp, deltas = cuda_mfn._launch_bwd(
        z(K, t, n, 4 * H), w, z(K, t, n, H), z(K, t, n, H), z(K, t, n, MEM),
        z(K, t, n, R), z(K, n, H), z(K, n, MEM), Z_TOT, H_DIMS, lanes=K)
    assert deltas.shape == (K, t, n, D) and m2 == 2 * (H - Z_TOT)
    cuda_mfn._launch_dw(w, z(K, t, n, H), z(K, t, n, MEM), z(K, t, n, R),
                        deltas, Z_TOT, K)
    assert (cuda_mfn.BWD_LAUNCHES, cuda_mfn.DW_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert cuda_lstm.LANE_LAUNCHES == {"mfm_encode_bwd": 1,
                                       "mfm_encode_dw": 1}
    asked = [args for name, args in fake_library
             if name == "mfm_encode_bwd_wave"]
    (bname, bargs), (dname, dargs) = [c for c in fake_library
                                      if c[0] != "mfm_encode_bwd_wave"]
    plan = _plan(K, n)
    # the variant, the threads, the two chains' rows, the lanes
    assert list(bargs[-8:-3]) == [0, cuda_mfn.BWD_THREADS,
                                  plan["memory_chain"]["rows"],
                                  plan["lstm_chains"]["rows"], K]
    assert cuda_mfn.BWD_PLAN == plan
    # the card was asked, once for each row count and chain, for the
    # chain's instantiation at the launch's threads and shared memory
    expect = []
    for c, (chain, counts) in enumerate((
            ("memory_chain", cuda_mfn.BWD_MEM_ROW_COUNTS),
            ("lstm_chains", cuda_mfn.BWD_CELL_ROW_COUNTS))):
        for R in counts:
            p = cuda_lstm.chain_plan(lambda C: _bytes(chain, R, C))
            if p == cuda_lstm.chain_plan(lambda C: _bytes(chain, counts[0],
                                                          C)):
                smem = 0 if p == cuda_lstm.SCRATCH else _bytes(chain, R, p)
                expect.append([c, R, p, cuda_mfn.BWD_THREADS, smem])
    assert [list(a[:5]) for a in asked] == expect
    assert list(dargs[-5:-3]) == [cuda_mfn.dw_cluster(w, t * n), K]
    Hd, Hm = sum(DEC_DIMS), sum(MULTI_DIMS["m_b"])
    cuda_lstm._launch(z(K, n, Hd), z(K, n, Hd), z(K, Hd, 4 * Hd),
                      z(K, 4 * Hd), t, DEC_DIMS, K)
    cuda_lstm._launch_multi(z(K, t, n, 4 * Hm), z(K, Hm, 4 * Hm),
                            MULTI_DIMS["m_b"], True, K)
    assert (cuda_lstm.LAUNCHES, cuda_lstm.MULTI_LAUNCHES) == (1, 1)
    assert cuda_lstm.LANE_LAUNCHES == {
        "mfm_encode_bwd": 1, "mfm_encode_dw": 1, "decoder_lstm_fwd": 1,
        "multi_lstm_fwd": 1}


def test_the_wave_query_matches_its_c_prototype(fake_library):
    """``chain_wave`` calls ``mfm_encode_bwd_wave`` with the types of its
    C prototype and reads the blocks it writes."""
    cuda_mfn.chain_wave("lstm_chains", 4, 1, 1000)
    src = (_build.CSRC / "mfm_encode_bwd.cu").read_text()
    m = re.search(r'extern "C" int mfm_encode_bwd_wave\((.*?)\)\s*\{', src,
                  re.S)
    kinds = [" ".join(p.split()).rsplit(" ", 1)[0]
             for p in m.group(1).split(",")]
    assert kinds == ["int"] * 4 + ["long long", "int*"]
    assert ARGTYPES["mfm_encode_bwd_wave"] == (
        [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)])
    (name, args), = fake_library
    assert list(args[:5]) == [1, 4, 1, cuda_mfn.BWD_THREADS, 1000]
    assert cuda_mfn.chain_wave("lstm_chains", 4, 1, 1000) == 132 * 4
    assert len(fake_library) == 1  # asked once


# ------------------------------- the encode forward and the chain backward
#
# The forward's chains at the train (n = 32) and eval (n = 256) batches;
# the decoders' chain backward at best_acc_mosi_config's decoders (n = 32)
# and at missing's four stacked decodes (4n = 128); the encoder cells'
# backward at m_b's, kl_ef's (its 120-unit cell on a cluster of 2) and
# missing's widths
DEC_DIMS = [104, 24, 24]
MULTI_DIMS = {"m_b": [32, 8, 80], "kl_ef": [32, 8, 80, 120],
              "missing": [80, 8, 32, 32, 32, 32]}
FWD_CASES = [(True, 32), (False, 256)]
CHAIN_CASES = [(True, DEC_DIMS, 32), (True, DEC_DIMS, 128),
               (True, [104, 104, 104], 32)] + [
    (False, dims, 32) for dims in MULTI_DIMS.values()]
CHAIN_IDS = ["decoders", "decoders_4n", "m_a_decoders",
             *[f"multi_{m}" for m in MULTI_DIMS]]
# the recurrences' forward chains (csrc/lstm_fwd.cu): (decoder, train,
# cells, n); the decoders as above, the encoder cells train at n = 32 and
# eval at the serving batch of 256
FWD_CHAIN_CASES = [(True, True, dims, n) for _, dims, n in CHAIN_CASES[:3]] + [
    (False, train, dims, 32 if train else 256)
    for dims in MULTI_DIMS.values() for train in (True, False)]
FWD_CHAIN_IDS = CHAIN_IDS[:3] + [f"multi_{m}_{v}" for m in MULTI_DIMS
                                 for v in ("train", "eval")]


def _fwd_bytes(chain, R, C):
    """The forward's chain's shared memory a block at R rows on a cluster
    of C."""
    if chain == "memory_chain":
        return cuda_mfn._mem_fwd_bytes(MEM, S3, S4, C, R, cuda_mfn.THREADS)
    return cuda_lstm.fwd_chain_bytes(H_DIMS, R, cuda_mfn.THREADS, C)


def _chain_bytes(decoder, dims):
    threads = (cuda_lstm.BWD_THREADS if decoder
               else cuda_lstm.MULTI_BWD_THREADS)
    return lambda R, C: cuda_lstm.cell_chain_bytes(
        dims, R, threads, 7 if decoder else 6, C)


def _fwd_plan(K, n, train, wave=WAVES["by_shared_memory"]):
    return cuda_mfn.fwd_plan(H_DIMS, S3, S4, MEM, n, K, train, wave)


def _chain_plan(K, decoder, dims, n, wave=WAVES["by_shared_memory"]):
    return cuda_lstm.chain_bwd_plan(dims, n, K, decoder, wave)


def _chain_fwd_bytes(dims):
    return lambda R, C: cuda_lstm.fwd_chain_bytes(dims, R,
                                                  cuda_lstm.FWD_THREADS, C)


def _chain_fwd_plan(K, decoder, train, dims, n,
                    wave=WAVES["by_shared_memory"]):
    return cuda_lstm.chain_fwd_plan(dims, n, K, decoder, train, wave)


def _fwd_first(decoder, train):
    """One lane's rows of a forward chain."""
    if decoder:
        return cuda_lstm.DECODER_FWD_ROWS
    return cuda_lstm.MULTI_TRAIN_ROWS if train else cuda_lstm.MULTI_EVAL_ROWS


def _held_to(p, chain, K, n, chains, counts, first, bytes_at, wave):
    """A plan of ``cuda_lstm.rows_plan`` against the rule: one lane the
    one-lane count; more lanes the fewest waves of what ``wave`` says the
    card holds, among the counts of the one-lane plan, the smallest such
    count, with its blocks, wave and waves as they should be."""
    def plan_at(R):
        return cuda_lstm.chain_plan(lambda C: bytes_at(R, C))

    if K <= 1:
        assert p["rows"] == first and p["waves"] is None
        return
    reach = {}
    for R in counts:
        plan = plan_at(R)
        if plan != plan_at(first) and not (plan <= 0 and plan_at(first) <= 0):
            continue
        smem = 0 if plan == cuda_lstm.SCRATCH else bytes_at(R, plan)
        held = wave(chain, R, plan, smem)
        blocks = K * math.ceil(n / R) * chains * max(plan, 1)
        reach[R] = (plan, math.ceil(blocks / held), blocks, held)
    fewest = min(w[1] for w in reach.values())
    R = min(R for R, w in reach.items() if w[1] == fewest)
    assert p["rows"] == R
    assert (p["plan"], p["waves"], p["blocks"], p["wave"]) == reach[R]


@pytest.mark.parametrize("K", LANES)
def test_one_lane_keeps_todays_forward_and_chain_rows(K):
    """One lane takes the source's one-lane rows at any batch, asking the
    card nothing: the forward's LSTM chains and memory chain 2 / 1 rows a
    block with residuals (train) and 8 / 2 without (eval, serving), the
    decoders' chain forward 2 and backward 1, the encoder cells' chain
    forward 2 with residuals and 8 without, backward 2; so the one-model
    path, serving and ``Predictor`` do not move. At every K a plan keeps
    the cluster of the one-lane plan."""
    def unasked(*args):
        raise AssertionError(f"one lane asked for a wave: {args}")

    for n in (1, 32, 128, 256, 1000):
        for lanes in (0, 1):
            for train, rows in ((True, cuda_mfn.TRAIN_ROWS),
                                (False, cuda_mfn.EVAL_ROWS)):
                p = _fwd_plan(lanes, n, train, unasked)
                assert (p["lstm_chains"]["rows"],
                        p["memory_chain"]["rows"]) == rows
            for decoder, dims, _ in CHAIN_CASES:
                p = _chain_plan(lanes, decoder, dims, n, unasked)
                assert p["rows"] == (1 if decoder else 2)
            for decoder, train, dims, _ in FWD_CHAIN_CASES:
                p = _chain_fwd_plan(lanes, decoder, train, dims, n, unasked)
                assert p["rows"] == (2 if decoder or train else 8)
                assert p["rows"] == _fwd_first(decoder, train)
    assert cuda_mfn.TRAIN_ROWS == (2, 1) and cuda_mfn.EVAL_ROWS == (8, 2)
    assert (cuda_lstm.DECODER_BWD_ROWS, cuda_lstm.MULTI_BWD_ROWS) == (1, 2)
    assert (cuda_lstm.DECODER_FWD_ROWS, cuda_lstm.MULTI_TRAIN_ROWS,
            cuda_lstm.MULTI_EVAL_ROWS) == (2, 2, 8)
    for decoder, train, dims, n in FWD_CHAIN_CASES:
        assert (_chain_fwd_plan(K, decoder, train, dims, n)["plan"]
                == _chain_fwd_plan(1, decoder, train, dims, n)["plan"])
    for train, n in FWD_CASES:
        many, one = _fwd_plan(K, n, train), _fwd_plan(1, n, train)
        for chain in many:
            assert many[chain]["plan"] == one[chain]["plan"]
    for decoder, dims, n in CHAIN_CASES:
        assert (_chain_plan(K, decoder, dims, n)["plan"]
                == _chain_plan(1, decoder, dims, n)["plan"])


@pytest.mark.parametrize("K", [2, 3, 4, 8, 12, 16, 32])
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_the_forward_blocks_stay_within_the_waves_the_plan_aims_at(K, wave):
    """The forward's chains over K lanes, train at n = 32 and eval at n =
    256: the fewest waves of what the card holds at once among the
    instantiated counts of the one-lane plan, the smallest such count."""
    held = WAVES[wave]
    for train, n in FWD_CASES:
        cr, mr = cuda_mfn.TRAIN_ROWS if train else cuda_mfn.EVAL_ROWS
        p = _fwd_plan(K, n, train, held)
        _held_to(p["lstm_chains"], "lstm_chains", K, n, len(H_DIMS),
                 cuda_mfn.FWD_CELL_ROW_COUNTS, cr,
                 functools.partial(_fwd_bytes, "lstm_chains"), held)
        _held_to(p["memory_chain"], "memory_chain", K, n, 1,
                 cuda_mfn.FWD_MEM_ROW_COUNTS, mr,
                 functools.partial(_fwd_bytes, "memory_chain"), held)


@pytest.mark.parametrize("K", [2, 3, 4, 8, 12, 16, 32])
@pytest.mark.parametrize("case", CHAIN_CASES, ids=CHAIN_IDS)
def test_the_chain_backward_blocks_stay_within_the_waves_the_plan_aims_at(
        K, case):
    """The decoders' and the encoder cells' chain backward over K lanes,
    held to the same rule for every stand-in of the card."""
    decoder, dims, n = case
    for held in WAVES.values():
        _held_to(_chain_plan(K, decoder, dims, n, held),
                 "decoder_lstm_bwd" if decoder else "multi_lstm_bwd", K, n,
                 len(dims),
                 cuda_lstm.DECODER_BWD_ROW_COUNTS if decoder
                 else cuda_lstm.MULTI_BWD_ROW_COUNTS,
                 1 if decoder else 2, _chain_bytes(decoder, dims), held)


@pytest.mark.parametrize("K", [2, 3, 4, 8, 12, 16, 32])
@pytest.mark.parametrize("case", FWD_CHAIN_CASES, ids=FWD_CHAIN_IDS)
def test_the_chain_forward_rows_take_the_least_estimated_time(K, case):
    """The decoders' and the encoder cells' chain forward
    (csrc/lstm_fwd.cu) over K lanes, for every stand-in of the card: among
    the instantiated counts of the one-lane plan, the R of the least
    estimate (the smallest such R), the estimate the longer of the widest
    cell's block (a step's fixed cost plus its gates product's depth a
    thread times R) and all the blocks' sum over what the card holds at
    once."""
    decoder, train, dims, n = case
    first = _fwd_first(decoder, train)
    counts = (cuda_lstm.DECODER_FWD_ROW_COUNTS if decoder
              else cuda_lstm.MULTI_FWD_ROW_COUNTS)
    at = _chain_fwd_bytes(dims)
    base = cuda_lstm.chain_plan(lambda C: at(first, C))
    for held in WAVES.values():
        p = _chain_fwd_plan(K, decoder, train, dims, n, held)
        reach = {}
        for R in counts:
            plan = cuda_lstm.chain_plan(lambda C: at(R, C))
            if plan != base and not (plan <= 0 and base <= 0):
                continue
            smem = 0 if plan == cuda_lstm.SCRATCH else at(R, plan)
            wave = held("decoder_lstm_fwd" if decoder else "multi_lstm_fwd",
                        R, plan, smem)
            C = max(plan, 1)
            tiles = math.ceil(n / R)
            per = [cuda_lstm.FWD_STEP_COST
                   + cuda_lstm.fwd_depth(h, plan) * R for h in dims]
            reach[R] = (plan, max(max(per), K * tiles * C * sum(per) / wave),
                        K * tiles * len(dims) * C, wave)
        R = min(reach, key=lambda R: (reach[R][1], R))
        assert p["rows"] == R
        assert (p["plan"], p["cost"], p["blocks"], p["wave"]) == reach[R]
        assert p["waves"] == math.ceil(reach[R][2] / reach[R][3])


@pytest.mark.parametrize("h,C,depth", [
    (104, 1, 104), (24, 1, 6), (80, 1, 80), (32, 1, 8), (8, 1, 1),
    (120, 1, 120), (120, 2, 60), (80, 2, 40), (336, 1, 1008)])
def test_the_forward_depths_follow_the_tiles(h, C, depth):
    """A forward chain thread's multiply-adds a row and step: one column a
    thread for the 104-, 80- and 120-unit cells (416, 320 and 480 of 512
    threads), a column's depth split 4 ways for the 24-unit cell and 8
    ways for the 8-unit one; half a 120- or 80-unit cell's columns on each
    block of a cluster of 2, each split 2 ways; three columns a thread
    for a 336-unit cell."""
    assert cuda_lstm.fwd_depth(h, C) == depth


def test_the_forward_plan_takes_the_counts_measured_fastest():
    """With a stand-in of the card that holds blocks by their shared
    memory (as the H100 does), the estimate picks the counts PR 23's
    sweep measured fastest (PERF.md): the decoders 4 rows a block at K =
    8 and n = 32, then 8, and 8 over 4n rows; m_b's encoder cells 2 at K
    = 8 with residuals, then 8; kl_ef's 8. One pick is not the fastest:
    m_b's cells without residuals at n = 256 take 16 at K = 8 too (0.424
    ms there against 0.394 at 8 rows), as they do at K = 16 and 32."""
    held = WAVES["by_shared_memory"]
    picks = {(K, decoder, train, name): _chain_fwd_plan(
        K, decoder, train, dims, n, held)["rows"]
        for K in (8, 16, 32)
        for decoder, train, name, dims, n in (
            (True, True, "dec", DEC_DIMS, 32),
            (True, True, "dec4n", DEC_DIMS, 128),
            (False, True, "m_b", MULTI_DIMS["m_b"], 32),
            (False, False, "m_b", MULTI_DIMS["m_b"], 256),
            (False, True, "kl_ef", MULTI_DIMS["kl_ef"], 32),
            (False, False, "kl_ef", MULTI_DIMS["kl_ef"], 256))}
    want = {"dec": (4, 8, 8), "dec4n": (8, 8, 8), "kl_ef": (8, 8, 8)}
    for (K, decoder, train, name), R in picks.items():
        i = (8, 16, 32).index(K)
        if name == "m_b":
            assert R == ((2, 8, 8) if train else (16, 16, 16))[i]
        else:
            assert R == want[name][i]


@pytest.mark.parametrize("K", LANES)
@pytest.mark.parametrize("n", [1, 5, 32, 100, 256])
def test_the_forward_and_chain_rows_tile_the_batch(K, n):
    """Every plan's rows divide the padded rows its row tiles cover, which
    hold the batch with less than one tile to spare."""
    plans = [p for train in (True, False)
             for p in _fwd_plan(K, n, train).values()]
    plans += [_chain_plan(K, decoder, dims, n)
              for decoder, dims, _ in CHAIN_CASES]
    plans += [_chain_fwd_plan(K, decoder, train, dims, n)
              for decoder, train, dims, _ in FWD_CHAIN_CASES]
    for p in plans:
        R, padded = p["rows"], p["padded_rows"]
        assert padded % R == 0 and padded == p["row_tiles"] * R
        assert n <= padded < n + R


def test_no_forward_or_chain_count_that_sums_in_another_order_is_taken():
    """At the main widths the forward's memory chain at 16 rows passes
    one block and would take a cluster of 2, which sums in another order:
    no lane count takes it; the decoders' 104-unit cell has no backward
    count past 4 (8 rows do not fit beside its weights) and no forward
    count past 8 (16 would take a cluster of 2), nor ``m_b``'s 80-unit
    cell past 16; kl_ef's 120-unit cell keeps its cluster of 2 at every
    count it takes, both ways (16 forward rows would take 4)."""
    assert cuda_lstm.chain_plan(lambda C: _fwd_bytes("memory_chain", 16,
                                                     C)) == 2
    assert cuda_lstm.chain_plan(lambda C: _fwd_bytes("memory_chain", 8,
                                                     C)) == 1
    assert max(cuda_lstm.DECODER_BWD_ROW_COUNTS) == 4
    assert cuda_lstm.chain_plan(lambda C: _chain_bytes(True, DEC_DIMS)(
        8, C)) == 2
    kl = MULTI_DIMS["kl_ef"]
    assert _chain_plan(1, False, kl, N)["plan"] == 2
    fwd = {(tuple(dims), R): cuda_lstm.chain_plan(
        lambda C, d=dims, R=R: _chain_fwd_bytes(d)(R, C))
        for dims in (DEC_DIMS, MULTI_DIMS["m_b"], kl) for R in (8, 16, 32)}
    assert fwd[tuple(DEC_DIMS), 8] == 1 and fwd[tuple(DEC_DIMS), 16] == 2
    assert fwd[tuple(MULTI_DIMS["m_b"]), 16] == 1
    assert fwd[tuple(MULTI_DIMS["m_b"]), 32] > 1
    assert fwd[tuple(kl), 8] == 2 and fwd[tuple(kl), 16] == 4
    assert _chain_fwd_bytes(DEC_DIMS)(8, 1) == 219648
    assert _chain_fwd_bytes(DEC_DIMS)(16, 1) == 266240
    for wave in WAVES.values():
        for K in LANES:
            for train, n in FWD_CASES:
                assert _fwd_plan(K, n, train, wave)["memory_chain"][
                    "rows"] != 16
            assert _chain_plan(K, False, kl, N, wave)["plan"] == 2
            assert _chain_plan(K, True, DEC_DIMS, N, wave)["rows"] <= 4
            for train, n in ((True, N), (False, 256)):
                assert _chain_fwd_plan(K, False, train, kl, n,
                                       wave)["plan"] == 2
                assert _chain_fwd_plan(K, False, train, MULTI_DIMS["m_b"],
                                       n, wave)["rows"] <= 16
            assert _chain_fwd_plan(K, True, True, DEC_DIMS, N,
                                   wave)["rows"] <= 8


@pytest.mark.parametrize("source,name,counts", [
    ("mfm_encode_fwd.cu", "kCellRowCounts", cuda_mfn.FWD_CELL_ROW_COUNTS),
    ("mfm_encode_fwd.cu", "kMemRowCounts", cuda_mfn.FWD_MEM_ROW_COUNTS),
    ("lstm_bwd.cu", "kDecoderRowCounts", cuda_lstm.DECODER_BWD_ROW_COUNTS),
    ("lstm_bwd.cu", "kMultiRowCounts", cuda_lstm.MULTI_BWD_ROW_COUNTS),
    ("lstm_fwd.cu", "kDecoderFwdRowCounts",
     cuda_lstm.DECODER_FWD_ROW_COUNTS),
    ("lstm_fwd.cu", "kMultiFwdRowCounts", cuda_lstm.MULTI_FWD_ROW_COUNTS)])
def test_the_forward_and_chain_row_counts_are_the_sources(source, name,
                                                          counts):
    """The counts the new plans choose among are the ones each source
    instantiates, and one lane's counts are among them; for the
    recurrences' forward, one lane's counts are the source's defaults."""
    src = (_build.CSRC / source).read_text()
    m = re.search(rf"constexpr int {name}\[\] = \{{([\d, ]+)\}};", src)
    assert tuple(int(v) for v in m.group(1).split(",")) == counts
    assert list(counts) == sorted(counts)
    firsts = {"kCellRowCounts": (cuda_mfn.TRAIN_ROWS[0],
                                 cuda_mfn.EVAL_ROWS[0]),
              "kMemRowCounts": (cuda_mfn.TRAIN_ROWS[1],
                                cuda_mfn.EVAL_ROWS[1]),
              "kDecoderRowCounts": (cuda_lstm.DECODER_BWD_ROWS,),
              "kMultiRowCounts": (cuda_lstm.MULTI_BWD_ROWS,),
              "kDecoderFwdRowCounts": (cuda_lstm.DECODER_FWD_ROWS,),
              "kMultiFwdRowCounts": (cuda_lstm.MULTI_TRAIN_ROWS,
                                     cuda_lstm.MULTI_EVAL_ROWS)}[name]
    assert set(firsts) <= set(counts)
    if source == "lstm_fwd.cu":
        defaults = {m: int(v) for m, v in re.findall(
            r"#define (FTT_\w+_ROWS) (\d+)", src)}
        assert defaults == {"FTT_DECODER_FWD_ROWS": cuda_lstm.DECODER_FWD_ROWS,
                            "FTT_MULTI_EVAL_ROWS": cuda_lstm.MULTI_EVAL_ROWS,
                            "FTT_MULTI_TRAIN_ROWS": cuda_lstm.MULTI_TRAIN_ROWS}


def _encode_lanes(K, t, n):
    z = torch.zeros
    w = _weights(K)
    S = S1 + S2 + S3 + S4
    return z(K, t, n, 4 * H), z(K, t, n, S), w


@pytest.mark.parametrize("K", [1, 2, 8, 9, 32])
def test_the_forward_and_chain_backward_count_one_launch_a_call(
        fake_library, K):
    """The encode forward (train and eval), the decoders' and the encoder
    cells' chain forward (the encoder cells' train and eval) and backward
    over K lanes: one launch each, counted once, in ``LANE_LAUNCHES`` too;
    the rows each plan chose passed (0 for one lane, the source's own
    counts) and recorded in ``FWD_PLAN`` and ``BWD_PLAN``."""
    t, n = 2, 3
    xp, masks, w = _encode_lanes(K, t, n)
    for train in (True, False):
        before = cuda_mfn.LAUNCHES
        cuda_mfn._launch_fwd(xp, masks if train else None, w, Z_TOT, H_DIMS,
                             "cat" if train else None, K)
        assert cuda_mfn.LAUNCHES == before + 1
        plan = _fwd_plan(K, n, train)
        assert cuda_mfn.FWD_PLAN == plan
        args = fake_library[-1][1]
        want = [plan[c]["rows"] if K > 1 else 0
                for c in ("lstm_chains", "memory_chain")]
        # the threads, the two chains' rows, the lanes
        assert list(args[-7:-3]) == [cuda_mfn.THREADS, *want, K]
    z = torch.zeros
    Hd, Hm = sum(DEC_DIMS), sum(MULTI_DIMS["kl_ef"])
    cuda_lstm._launch_bwd(z(K, 4 * Hd, Hd).transpose(1, 2).contiguous(),
                          z(K, t, n, 4 * Hd), z(K, t, n, Hd),
                          z(K, t, n, Hd), DEC_DIMS, K)
    dec_args = fake_library[-1][1]
    cuda_lstm._launch_multi_bwd(z(K, t, n, 4 * Hm), z(K, Hm, 4 * Hm),
                                z(K, t, n, Hm), z(K, n, Hm),
                                MULTI_DIMS["kl_ef"], K)
    multi_args = fake_library[-1][1]
    assert (cuda_lstm.BWD_LAUNCHES, cuda_lstm.MULTI_BWD_LAUNCHES) == (1, 1)
    for args, decoder, dims, name, threads in (
            (dec_args, True, DEC_DIMS, "decoder_lstm_bwd",
             cuda_lstm.BWD_THREADS),
            (multi_args, False, MULTI_DIMS["kl_ef"], "multi_lstm_bwd",
             cuda_lstm.MULTI_BWD_THREADS)):
        plan = _chain_plan(K, decoder, dims, n)
        assert cuda_lstm.BWD_PLAN[name] == plan
        # the threads, the rows, the lanes
        assert list(args[-6:-3]) == [threads, plan["rows"] if K > 1 else 0,
                                     K]
    cuda_lstm._launch(z(K, n, Hd), z(K, n, Hd), z(K, Hd, 4 * Hd),
                      z(K, 1, 4 * Hd), t, DEC_DIMS, K)
    fwd_args = [fake_library[-1][1]]
    for train in (True, False):
        cuda_lstm._launch_multi(z(K, t, n, 4 * Hm), z(K, Hm, 4 * Hm),
                                MULTI_DIMS["kl_ef"], train, K)
        fwd_args.append(fake_library[-1][1])
    assert (cuda_lstm.LAUNCHES, cuda_lstm.MULTI_LAUNCHES) == (1, 2)
    for args, decoder, train, name in (
            (fwd_args[0], True, True, "decoder_lstm_fwd"),
            (fwd_args[1], False, True, "multi_lstm_fwd"),
            (fwd_args[2], False, False, "multi_lstm_fwd")):
        dims = DEC_DIMS if decoder else MULTI_DIMS["kl_ef"]
        plan = _chain_fwd_plan(K, decoder, train, dims, n)
        # the rows, the lanes; the encoder cells' variant before them
        assert list(args[-5:-3]) == [plan["rows"] if K > 1 else 0, K]
        if not decoder:
            assert args[-6] == int(train)
        assert plan["rows"] == (_fwd_first(decoder, train) if K == 1
                                else plan["rows"])
    assert cuda_lstm.FWD_PLAN == {
        "decoder_lstm_fwd": _chain_fwd_plan(K, True, True, DEC_DIMS, n),
        "multi_lstm_fwd": _chain_fwd_plan(K, False, False,
                                          MULTI_DIMS["kl_ef"], n)}
    assert cuda_lstm.LANE_LAUNCHES == (
        {"mfm_encode_fwd": 2, "decoder_lstm_bwd": 1, "multi_lstm_bwd": 1,
         "decoder_lstm_fwd": 1, "multi_lstm_fwd": 2} if K else {})


@pytest.mark.parametrize("kernel,query,chain,threads", [
    ("mfm_encode_fwd_wave", lambda: cuda_mfn.fwd_chain_wave,
     "memory_chain", lambda: cuda_mfn.THREADS),
    ("lstm_chain_bwd_wave", lambda: cuda_lstm.lstm_bwd_wave,
     "decoder_lstm_bwd", lambda: cuda_lstm.BWD_THREADS),
    ("lstm_chain_bwd_wave", lambda: cuda_lstm.lstm_bwd_wave,
     "multi_lstm_bwd", lambda: cuda_lstm.MULTI_BWD_THREADS),
    ("lstm_chain_fwd_wave", lambda: cuda_lstm.lstm_fwd_wave,
     "decoder_lstm_fwd", lambda: cuda_lstm.FWD_THREADS),
    ("lstm_chain_fwd_wave", lambda: cuda_lstm.lstm_fwd_wave,
     "multi_lstm_fwd", lambda: cuda_lstm.FWD_THREADS)],
    ids=["fwd_memory_chain", "decoders", "encoder_cells", "decoders_fwd",
         "encoder_cells_fwd"])
def test_the_new_wave_queries_match_their_c_prototypes(
        fake_library, kernel, query, chain, threads):
    """``fwd_chain_wave``, ``lstm_bwd_wave`` and ``lstm_fwd_wave`` call
    their C entry points with the types of the prototypes, the chain's index, the rows, the
    plan, the wrapper's threads and the bytes, and read the blocks each
    writes; each asked once."""
    query()(chain, 4, 1, 1000)
    src = "\n".join(p.read_text() for p in _build.sources())
    m = re.search(rf'extern "C" int {kernel}\((.*?)\)\s*\{{', src, re.S)
    kinds = [" ".join(p.split()).rsplit(" ", 1)[0]
             for p in m.group(1).split(",")]
    assert kinds == ["int"] * 4 + ["long long", "int*"]
    assert ARGTYPES[kernel] == (
        [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)])
    (name, args), = fake_library
    assert name == kernel
    index = EXPORTS[kernel].index(chain)
    assert list(args[:5]) == [index, 4, 1, threads(), 1000]
    assert query()(chain, 4, 1, 1000) == 132 * 4
    assert len(fake_library) == 1
