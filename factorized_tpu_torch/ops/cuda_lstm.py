"""The fused LSTM recurrences, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions (port of
``ops/pallas_lstm.py``).

The autoregressive decoders: ``decoder_lstm_fwd`` launches
``csrc/lstm_fwd.cu`` and ``decoder_lstm_bwd`` launches
``csrc/lstm_bwd.cu`` (counted in ``LAUNCHES`` and
``BWD_LAUNCHES``); ``DecoderLSTM`` is the ``torch.autograd.Function`` over
the pair (JAX: the ``custom_vjp`` of ``decoder_lstm``), with ``dwsum`` and
``db`` a ``torch.matmul`` and a sum outside the kernels.

The fused encoder cells: ``multi_lstm_fwd`` launches ``csrc/lstm_fwd.cu``
and ``multi_lstm_bwd`` launches ``csrc/lstm_bwd.cu`` (counted in
``MULTI_LAUNCHES`` and ``MULTI_BWD_LAUNCHES``); ``MultiLSTM`` is the
Function over the pair (JAX: the ``custom_vjp`` of ``multi_lstm``), with
``dWh`` a ``torch.matmul`` outside the kernels.

Each direction is one kernel for both, ``csrc/lstm_fwd.cu`` and
``csrc/lstm_bwd.cu``: one block per (cell, row tile) with the cell's
diagonal blocks of the recurrent weight in shared memory. A cell past one
block's shared memory splits its gate columns over a thread-block cluster
of 2, 4 or 8 blocks, the smallest that fits; past 8 the chain reads the
weights in place from L2 (``CLUSTERS`` records each call's plan, 0 for
L2, and ``L2_LAUNCHES`` counts the launches that read from L2); where a
block's per-row state alone passes the card's shared memory too, the
chain keeps that state in a scratch of device memory (plan ``SCRATCH``,
counted in ``SCRATCH_LAUNCHES``; ``launch_chains`` allocates it). The
plan is made from the widths before the launch, and every width has one.
``decoder_lstm_bwd_cells_plain``,
``multi_lstm_bwd_cells_plain`` and ``cell_dh_split_plain`` are the
backward's data flow in plain PyTorch.

Every wrapper runs its plain version (``*_plain``) for CPU tensors and
launches its kernel for CUDA tensors; there is no other route. The JAX
package leaves the weight-gradient products to XLA, as the port leaves
them to ``torch.matmul``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from factorized_tpu_torch.ops import _build
from factorized_tpu_torch.ops.lstm import lstm_step, recurrent_weight_grad

LAUNCHES = 0
BWD_LAUNCHES = 0
MULTI_LAUNCHES = 0
MULTI_BWD_LAUNCHES = 0
# the launches of each kernel with a lane axis (``*_lanes`` wrappers and
# the lane route under ``torch.func.vmap``), by kernel; they are counted in
# the counters above too. Every kernel finds its lane's arrays by stride:
# one launch a pass for any number of lanes
LANE_LAUNCHES = {}
# threads per block of the backward chains at the training batch (n = 32),
# the fastest measured by perf_probe.py (PERF.md); the forward chains'
# threads are fixed in csrc/lstm_fwd.cu
BWD_THREADS = 512
MULTI_BWD_THREADS = 256
# the plan the last call of each wrapper ran its chain on: the
# thread-block cluster (1: one block), 0: the weights read from L2, or
# SCRATCH: with them the per-row state in device memory
CLUSTERS = {}
SCRATCH = -2
# launches of each wrapper whose chain read its weights from L2, and of
# those whose chain kept its state in device memory
L2_LAUNCHES = {}
SCRATCH_LAUNCHES = {}
# what a launcher returns, having launched nothing, while the scratch it
# was given is short of what a chain on SCRATCH takes
# (csrc/lstm_common.cuh's kNeedScratch)
NEED_SCRATCH = -1
# the launchers' scratch parameters: the device memory, its floats, and
# (host memory) the floats the launch takes
STATE_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.POINTER(ctypes.c_longlong)]


# ----------------------------------------------------------------- plans
# The launchers' plan arithmetic in Python (csrc/lstm_common.cuh's
# chain_plan over the byte counts of csrc/cell_fwd.cuh's fwd_chain_bytes
# and csrc/cell_bwd.cuh's cell_chain_bytes, at the sources' rows and
# threads), so that a chain's plan is known from the widths before any
# launch (benchprog.active_paths); chip_smoke.py step 24 holds it against
# the plans the launchers report in CLUSTERS. The shared memory a block
# may take (kMaxSmemBytes), the largest cluster, and the rows a block of
# one lane of csrc/lstm_fwd.cu (decoders; encoder cells train, eval) and
# csrc/lstm_bwd.cu (decoders, encoder cells) takes
MAX_SMEM_BYTES = 232448
MAX_CLUSTER = 8
FWD_THREADS = 512
DECODER_FWD_ROWS, MULTI_TRAIN_ROWS, MULTI_EVAL_ROWS = 2, 2, 8
# the forward chains take one of these row counts a block
# (csrc/lstm_fwd.cu: kDecoderFwdRowCounts, kMultiFwdRowCounts), chosen by
# chain_fwd_plan; one lane takes the counts above, the fastest measured
# (perf_probe.py rows)
DECODER_FWD_ROW_COUNTS, MULTI_FWD_ROW_COUNTS = (1, 2, 4, 8), (1, 2, 4, 8, 16)
# a forward chain step's cost beside its gates product (the barriers, the
# cell update, the next step's copies), in multiply-adds of the product a
# row, as fitted to the chains' device ms over lanes at every count
# (perf_probe.py lanes, PERF.md, PR 23); chain_fwd_plan's estimate
FWD_STEP_COST = 290
# the backward chains take one of these row counts a block
# (csrc/lstm_bwd.cu: kDecoderRowCounts, kMultiRowCounts), chosen by
# chain_bwd_plan; one lane takes DECODER_BWD_ROWS and MULTI_BWD_ROWS, the
# fastest measured at the training batch (perf_probe.py rows)
DECODER_BWD_ROW_COUNTS, MULTI_BWD_ROW_COUNTS = (1, 2, 4), (1, 2, 4, 8)
DECODER_BWD_ROWS, MULTI_BWD_ROWS = 1, 2
# the last call's plan of each forward and backward chain kernel
# (chain_fwd_plan, chain_bwd_plan)
FWD_PLAN, BWD_PLAN = {}, {}


def pad4(floats: int) -> int:
    """Floats rounded up to 16 bytes."""
    return (floats + 3) & ~3


def cell_cols(h: int, C: int) -> int:
    """The gate columns a block of a cluster of C holds of a cell of h."""
    return 4 * h if C == 1 else ((4 * h + C - 1) // C + 3) & ~3


def lanes_per_output(items: int, threads: int) -> int:
    ks = 32
    while ks > 1 and items * ks > threads:
        ks >>= 1
    return ks


def conflict_free_pitch(length: int, unit: int) -> int:
    if unit >= 32:
        return length
    p = length
    while p % unit or (p // unit) % 2 == 0:
        p += 1
    return p


def fwd_chain_bytes(h_dims, rows: int, threads: int, C: int) -> int:
    """A forward chain's shared memory a block on a cluster of C (0: the
    weights read from L2, the per-row state alone), the largest cell's."""
    CC = 1 if C == 0 else C
    most = 0
    for h in h_dims:
        kc = cell_cols(h, CC)
        kg = lanes_per_output(kc, threads)
        while kg > 1 and kg > h:
            kg >>= 1
        f = (h * kc + 2 * pad4(h * rows) + 2 * 4 * h * rows
             + (2 if CC > 1 else 1) * kg * kc * rows)
        most = max(most, f - (h * kc if C == 0 else 0))
    return 4 * most


def dg_floats(cols: int, rows: int) -> int:
    """The floats of a backward chain's gate gradients, ``cols`` columns
    of ``rows`` rows in groups of four columns, a group padded by four
    floats from 4 rows on (csrc/cell_bwd.cuh's dg_floats)."""
    return cols // 4 * (4 * rows + (4 if rows >= 4 else 0))


def cell_chain_bytes(h_dims, rows: int, threads: int, op_width: int,
                     C: int) -> int:
    """A backward chain's shared memory a block, likewise (``op_width``
    operand floats a row and unit)."""
    CC = 1 if C == 0 else C
    most = 0
    for h in h_dims:
        ks = lanes_per_output(h, threads)
        kc = cell_cols(h, CC)
        wp = conflict_free_pitch(kc, min(4 * ks, 32))
        f = (h * wp + 2 * pad4(h * rows) + dg_floats(CC * kc, rows)
             + 2 * rows * op_width * h
             + (2 * pad4(h * rows) if CC > 1 else 0))
        most = max(most, f - (h * wp if C == 0 else 0))
    return 4 * most


def chain_plan(bytes_at) -> int:
    """The smallest cluster whose blocks' bytes (``bytes_at(C)``) fit,
    else 0 (weights from L2) where the per-row state alone
    (``bytes_at(0)``) fits, else ``SCRATCH``."""
    C = 1
    while C <= MAX_CLUSTER:
        if bytes_at(C) <= MAX_SMEM_BYTES:
            return C
        C *= 2
    return 0 if bytes_at(0) <= MAX_SMEM_BYTES else SCRATCH


def decoder_plans(h_dims):
    """The plans of the decoder recurrence's forward and backward chains
    over the fused cells ``h_dims``, as ``CLUSTERS`` records them."""
    return {
        "decoder_lstm_fwd": chain_plan(lambda C: fwd_chain_bytes(
            h_dims, DECODER_FWD_ROWS, FWD_THREADS, C)),
        "decoder_lstm_bwd": chain_plan(lambda C: cell_chain_bytes(
            h_dims, DECODER_BWD_ROWS, BWD_THREADS, 7, C))}


def multi_plans(h_dims, train: bool = True):
    """The plans of the fused encoder cells' forward (train or eval rows)
    and, in training, backward chains."""
    rows = MULTI_TRAIN_ROWS if train else MULTI_EVAL_ROWS
    plans = {"multi_lstm_fwd": chain_plan(lambda C: fwd_chain_bytes(
        h_dims, rows, FWD_THREADS, C))}
    if train:
        plans["multi_lstm_bwd"] = chain_plan(lambda C: cell_chain_bytes(
            h_dims, MULTI_BWD_ROWS, MULTI_BWD_THREADS, 6, C))
    return plans


def rows_plan(chain, bytes_at, counts, n, lanes, chains, wave, first=None,
              cost=None):
    """A chain's rows a block over ``lanes`` lanes, chosen among ``counts``
    (ascending, the kernel's instantiated ones; ``bytes_at(R)(C)`` its
    shared memory a block at R rows on a cluster of C): one lane the
    one-lane count ``first`` (default ``counts[0]``) at any batch, asking
    the card nothing; more lanes the R whose blocks, lanes x ceil(n / R)
    row tiles x ``chains`` x the plan's cluster, take the fewest waves of
    what the card holds at once (``wave(chain, R, plan, smem_bytes)``) or,
    given ``cost(R, plan, blocks, held)``, the least of that estimate;
    the smallest such R, among the counts whose chain plan sums in the
    order of the one-lane count's (the same cluster; one block, weights
    from L2 or the scratch plan alike). {"rows", "plan", "row_tiles",
    "padded_rows", "blocks", "wave", "waves", "cost"} ("wave", "waves"
    and "cost" None for one lane, "cost" None without ``cost``)."""
    first = counts[0] if first is None else first
    base, best, best_key = chain_plan(bytes_at(first)), None, None
    for R in counts if lanes > 1 else (first,):
        at = bytes_at(R)
        plan = chain_plan(at)
        if plan != base and not (plan <= 0 and base <= 0):
            continue  # another cluster: another order of summation
        tiles = -(-n // R)
        blocks = lanes * tiles * chains * max(plan, 1)
        held = waves = estimate = None
        if lanes > 1:
            held = wave(chain, R, plan, 0 if plan == SCRATCH else at(plan))
            waves = -(-blocks // held)
            if cost is not None:
                estimate = cost(R, plan, blocks, held)
        key = waves if estimate is None else estimate
        if best is None or key < best_key:
            best_key = key
            best = {"rows": R, "plan": plan, "row_tiles": tiles,
                    "padded_rows": tiles * R, "blocks": blocks,
                    "wave": held, "waves": waves, "cost": estimate}
    return best


# the entry points that say what the card holds at once of a chain kernel,
# by kernel: the C function and its chains, in the order of its `chain`
# argument (csrc/mfm_encode_fwd.cu, csrc/mfm_encode_bwd.cu,
# csrc/lstm_fwd.cu, csrc/lstm_bwd.cu)
WAVE_EXPORTS = {
    "mfm_encode_fwd": ("mfm_encode_fwd_wave",
                       ("lstm_chains", "memory_chain")),
    "mfm_encode_bwd": ("mfm_encode_bwd_wave",
                       ("memory_chain", "lstm_chains")),
    "lstm_chain_fwd": ("lstm_chain_fwd_wave",
                       ("multi_lstm_fwd", "decoder_lstm_fwd")),
    "lstm_chain_bwd": ("lstm_chain_bwd_wave",
                       ("multi_lstm_bwd", "decoder_lstm_bwd")),
}


def chain_wave(kernel: str, chain: str, rows: int, plan: int, threads: int,
               smem_bytes: int) -> int:
    """The blocks of ``kernel``'s (a ``WAVE_EXPORTS`` key) ``chain`` at
    ``rows`` rows a block on chain plan ``plan``, ``threads`` threads and
    ``smem_bytes`` of dynamic shared memory that the current card holds at
    once: its SMs times what the CUDA occupancy calculator gives an SM for
    that instantiation, threads, shared memory and registers counted."""
    return _chain_wave(torch.cuda.current_device(), kernel, chain, rows,
                       plan, threads, smem_bytes)


@functools.lru_cache(maxsize=None)
def _chain_wave(device, kernel, chain, rows, plan, threads, smem_bytes):
    export, chains = WAVE_EXPORTS[kernel]
    fn = _build.kernel(export, [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)])
    held = (ctypes.c_int * 1)()
    with torch.cuda.device(device):
        err = fn(chains.index(chain), rows, plan, threads, smem_bytes, held)
    _build.check(err, f"{export} ({chain}, {rows} rows, plan {plan}, "
                      f"{smem_bytes} bytes)")
    return held[0]


def lstm_fwd_wave(chain: str, rows: int, plan: int, smem_bytes: int) -> int:
    """``chain_wave`` of the forward chain ``"decoder_lstm_fwd"`` or
    ``"multi_lstm_fwd"`` (eval and train alike) at ``FWD_THREADS``."""
    return chain_wave("lstm_chain_fwd", chain, rows, plan, FWD_THREADS,
                      smem_bytes)


def chain_fwd_plan(h_dims, n: int, lanes: int = 1, decoder: bool = True,
                   train: bool = True, wave=None):
    """The rows a block of the decoders' (``decoder``) or the encoder
    cells' forward chain over the fused cells ``h_dims`` and ``n`` batch
    rows, chosen from the lanes by ``rows_plan``: one lane
    ``DECODER_FWD_ROWS``, or ``MULTI_TRAIN_ROWS`` with residuals
    (``train``) and ``MULTI_EVAL_ROWS`` without; more lanes among
    ``DECODER_FWD_ROW_COUNTS`` or ``MULTI_FWD_ROW_COUNTS`` the least of
    ``fwd_chain_cost``'s estimate, a wave from ``wave`` (default
    ``lstm_fwd_wave``: the current card's occupancy). The launcher passes
    the rows."""
    return _chain_fwd_plan(tuple(h_dims), n, max(lanes, 1), decoder,
                           train, wave or lstm_fwd_wave)


@functools.lru_cache(maxsize=None)
def _chain_fwd_plan(h_dims, n, lanes, decoder, train, wave):
    def bytes_at(R):
        return lambda C: fwd_chain_bytes(h_dims, R, FWD_THREADS, C)

    def cost(R, plan, blocks, held):
        return fwd_chain_cost(h_dims, R, plan, blocks, held)

    if decoder:
        return rows_plan("decoder_lstm_fwd", bytes_at,
                         DECODER_FWD_ROW_COUNTS, n, lanes, len(h_dims),
                         wave, DECODER_FWD_ROWS, cost)
    return rows_plan("multi_lstm_fwd", bytes_at, MULTI_FWD_ROW_COUNTS, n,
                     lanes, len(h_dims), wave,
                     MULTI_TRAIN_ROWS if train else MULTI_EVAL_ROWS, cost)


def fwd_depth(h: int, C: int, threads: int = FWD_THREADS) -> int:
    """The multiply-adds of a forward chain's gates product that one
    thread of a block does a row and step on a cell of h units on a
    cluster of C: its items (a gate column's share of the depth) times
    each one's depth (csrc/cell_fwd.cuh's fwd_tile and cell_gates_fwd)."""
    kc = cell_cols(h, max(C, 1))
    kg = lanes_per_output(kc, threads)
    while kg > 1 and kg > h:
        kg >>= 1
    return -(-kg * kc // threads) * -(-h // kg)


def fwd_chain_cost(h_dims, R, plan, blocks, held) -> float:
    """A forward chain launch's estimated time over lanes, in steps of one
    multiply-add a row: each block's step ``FWD_STEP_COST`` plus its
    cell's ``fwd_depth`` times R, and the launch the longer of its widest
    cell's block and the blocks' sum over what the card holds at once
    (``held``; ``blocks`` spread evenly over the cells). So more rows a
    block pay only where the blocks fill more than the card at once: a
    row costs a block about as much at 8 rows as at 2 (PERF.md, PR 23)."""
    per = [FWD_STEP_COST + fwd_depth(h, plan) * R for h in h_dims]
    return max(max(per), blocks / len(h_dims) * sum(per) / held)


def lstm_bwd_wave(chain: str, rows: int, plan: int, smem_bytes: int) -> int:
    """``chain_wave`` of the backward chain ``"decoder_lstm_bwd"`` or
    ``"multi_lstm_bwd"`` at its wrapper's threads."""
    threads = BWD_THREADS if chain == "decoder_lstm_bwd" else \
        MULTI_BWD_THREADS
    return chain_wave("lstm_chain_bwd", chain, rows, plan, threads,
                      smem_bytes)


def chain_bwd_plan(h_dims, n: int, lanes: int = 1, decoder: bool = True,
                   wave=None):
    """The rows a block of the decoders' (``decoder``) or the encoder
    cells' backward chain over the fused cells ``h_dims`` and ``n`` batch
    rows, chosen from the lanes by ``rows_plan``: one lane
    ``DECODER_BWD_ROWS`` or ``MULTI_BWD_ROWS``, more lanes among
    ``DECODER_BWD_ROW_COUNTS`` or ``MULTI_BWD_ROW_COUNTS``, a wave from
    ``wave`` (default ``lstm_bwd_wave``: the current card's occupancy).
    The launcher passes the rows."""
    threads = BWD_THREADS if decoder else MULTI_BWD_THREADS
    return _chain_bwd_plan(tuple(h_dims), n, max(lanes, 1), decoder,
                           threads, wave or lstm_bwd_wave)


@functools.lru_cache(maxsize=None)
def _chain_bwd_plan(h_dims, n, lanes, decoder, threads, wave):
    def bytes_at(R):
        return lambda C: cell_chain_bytes(h_dims, R, threads,
                                          7 if decoder else 6, C)

    if decoder:
        return rows_plan("decoder_lstm_bwd", bytes_at,
                         DECODER_BWD_ROW_COUNTS, n, lanes, len(h_dims),
                         wave, DECODER_BWD_ROWS)
    return rows_plan("multi_lstm_bwd", bytes_at, MULTI_BWD_ROW_COUNTS, n,
                     lanes, len(h_dims), wave, MULTI_BWD_ROWS)


def count_lanes(name: str, lanes: int):
    """Count a lane launch of kernel ``name`` in ``LANE_LAUNCHES``."""
    if lanes:
        LANE_LAUNCHES[name] = LANE_LAUNCHES.get(name, 0) + 1


def lane_strides(tensors, lanes: int):
    """The launchers' ``lane_strides`` argument: each array's floats from
    one lane to the next (its leading dimension's stride, 0 where the
    lanes share it), all 0 without lanes; None stands for no array."""
    vals = [t.stride(0) if lanes and t is not None else 0 for t in tensors]
    return (ctypes.c_longlong * len(vals))(*vals)


LANE_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]


def launch_chains(fn, device, head, tail):
    """``fn(*head, state, floats, need, *tail)``: a launcher whose chains
    may keep their per-row state in device memory (plan ``SCRATCH``),
    called with no scratch and, where it asks for one (``NEED_SCRATCH``,
    nothing launched), again with a scratch of the floats it needs, on the
    current stream (the kernel is ordered before any later use of the
    memory). Returns the launcher's error code."""
    need = ctypes.c_longlong(0)
    err = fn(*head, None, 0, ctypes.byref(need), *tail)
    if err == NEED_SCRATCH:
        state = torch.empty(need.value, dtype=torch.float32, device=device)
        err = fn(*head, state.data_ptr(), need.value, ctypes.byref(need),
                 *tail)
    return err


def _check(h0, c0, wsum, b, t, h_dims):
    if h0.dim() != 2:
        raise ValueError(f"h0 must be (n, H), got {tuple(h0.shape)}")
    n, H = h0.shape
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    if sum(h_dims) != H:
        raise ValueError(f"h_dims {list(h_dims)} do not sum to H = {H}")
    want = {"h0": (n, H), "c0": (n, H), "wsum": (H, 4 * H), "b": (4 * H,)}
    for name, tensor in (("h0", h0), ("c0", c0), ("wsum", wsum), ("b", b)):
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if tensor.device != h0.device:
            raise ValueError(f"{name} is on {tensor.device}, h0 on "
                             f"{h0.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape, ok = tuple(tensor.shape), want[name]
        if shape != ok and not (name == "b" and shape == (1,) + ok):
            raise ValueError(f"{name} must be {ok}, got {shape}")


def _check_tensors(named, want, h_dims, H):
    """Each (name, tensor) of ``named`` float32, contiguous, shaped as
    ``want[name]`` and on the first one's device, which must have a route;
    the fused widths ``h_dims`` sum to the hidden width ``H``."""
    if sum(h_dims) != H:
        raise ValueError(f"h_dims {list(h_dims)} do not sum to H = {H}")
    first, device = named[0][0], named[0][1].device
    for name, tensor in named:
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, {first} on "
                             f"{device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(tensor.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(tensor.shape)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")


def decoder_lstm_fwd(h0, c0, wsum, b, t: int, h_dims):
    """From the state ``(h0, c0)`` after the latent-driven step 0, run
    t - 1 steps of ``gates = h @ wsum + b`` over the fused cells
    ``h_dims``. Returns ``(allh, allc, gates)``: (t, n, H), (t, n, H) and
    (t, n, 4H), slot 0 holding (h0, c0) and zero gates."""
    _check(h0, c0, wsum, b, t, h_dims)
    if h0.device.type == "cpu":
        return decoder_lstm_plain(h0, c0, wsum, b, t)
    if h0.device.type != "cuda":
        raise ValueError(f"no kernel for device {h0.device}")
    return _launch(h0, c0, wsum, b, t, h_dims)


def decoder_lstm(h0, c0, wsum, b, t: int, h_dims):
    """All hidden states (t, n, H); ``allh[0] == h0``. Through
    ``DecoderLSTM`` when a gradient is wanted; under ``torch.func.vmap``
    through the lane kernels (``VmapDecoderLSTM``)."""
    if batched(h0, c0, wsum, b):
        return VmapDecoderLSTM.apply(h0, c0, wsum, b, t, list(h_dims))
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (h0, c0, wsum, b)):
        return DecoderLSTM.apply(h0, c0, wsum, b, t, list(h_dims))
    return decoder_lstm_fwd(h0, c0, wsum, b, t, h_dims)[0]


def _launch(h0, c0, wsum, b, t, h_dims, lanes: int = 0):
    """The decoder forward's kernel; with ``lanes`` every operand has a
    leading lane dimension and one launch runs them all, the rows a block
    ``chain_fwd_plan``'s (one lane: the source's own count)."""
    global LAUNCHES
    n, H = h0.shape[-2:]
    fn = _build.kernel(
        "decoder_lstm_fwd",
        [ctypes.c_void_p] * 7 + STATE_ARGTYPES + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] + LANE_ARGTYPES
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lead = (lanes,) if lanes else ()

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32,
                           device=h0.device)

    allh, allc, gates = empty(t, n, H), empty(t, n, H), empty(t, n, 4 * H)
    operands = (h0, c0, wsum, b, allh, allc, gates)
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    fit = (ctypes.c_int * 6)()
    plan = chain_fwd_plan(h_dims, n, lanes, decoder=True)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch_chains(
            fn, h0.device, [x.data_ptr() for x in operands],
            [t, n, H, len(h_dims), dims, rows_arg(plan, lanes),
             max(lanes, 1), lane_strides(operands, lanes), fit, stream])
    _fit("decoder_lstm_fwd", fit, h_dims)
    _build.check(err, "decoder_lstm_fwd")
    LAUNCHES += 1
    count_lanes("decoder_lstm_fwd", lanes)
    _count_plans("decoder_lstm_fwd")
    FWD_PLAN["decoder_lstm_fwd"] = plan
    return allh, allc, gates


def decoder_lstm_plain(h0, c0, wsum, b, t: int):
    """The same function as the kernel in plain PyTorch: the scan branch
    of the JAX package's ``fused_decoder_scan`` as a Python loop, keeping
    the gates the kernel writes."""
    b = b.reshape(-1)
    allh, allc, gates = [h0], [c0], [h0.new_zeros((h0.shape[0], b.numel()))]
    h, c = h0, c0
    for _ in range(t - 1):
        g = h @ wsum + b
        h, c = lstm_step(c, g)
        allh.append(h)
        allc.append(c)
        gates.append(g)
    return torch.stack(allh), torch.stack(allc), torch.stack(gates)


# -------------------------------------------------------------- backward

def decoder_lstm_bwd(wsum, gates, allc, dallh, h_dims):
    """BPTT of the recurrence (JAX: ``_dec_bwd_call``), t >= 2: from the
    forward's ``gates`` and ``allc`` and the cotangent ``dallh`` of every
    hidden state, ``(dgates (t - 1, n, 4H), dh0, dc0)``; transition i's
    gate gradient sits in slot i - 1."""
    if allc.dim() != 3:
        raise ValueError(f"allc must be (t, n, H), got {tuple(allc.shape)}")
    t, n, H = allc.shape
    if t < 2:
        raise ValueError(f"the backward needs t >= 2, got {t}")
    _check_tensors(
        [("allc", allc), ("wsum", wsum), ("gates", gates), ("dallh", dallh)],
        {"wsum": (H, 4 * H), "gates": (t, n, 4 * H), "allc": (t, n, H),
         "dallh": (t, n, H)}, h_dims, H)
    if allc.device.type == "cpu":
        return decoder_lstm_bwd_plain(wsum, gates, allc, dallh)
    return _launch_bwd(wsum, gates, allc, dallh, h_dims)


def _launch_bwd(wsum, gates, allc, dallh, h_dims, lanes: int = 0):
    """The decoder backward's kernel; with ``lanes`` every operand has a
    leading lane dimension and one launch runs them all, the rows a block
    ``chain_bwd_plan``'s (one lane: the source's own count)."""
    global BWD_LAUNCHES
    t, n, H = allc.shape[-3:]
    fn = _build.kernel(
        "decoder_lstm_bwd",
        [ctypes.c_void_p] * 7 + STATE_ARGTYPES + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + LANE_ARGTYPES + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lead = (lanes,) if lanes else ()

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32,
                           device=allc.device)

    dgates, dh0, dc0 = empty(t - 1, n, 4 * H), empty(n, H), empty(n, H)
    operands = (gates, allc, dallh, wsum, dgates, dh0, dc0)
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    fit = (ctypes.c_int * 6)()
    plan = chain_bwd_plan(h_dims, n, lanes, decoder=True)
    with torch.cuda.device(allc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch_chains(
            fn, allc.device, [x.data_ptr() for x in operands],
            [t, n, H, len(h_dims), dims, BWD_THREADS, rows_arg(plan, lanes),
             max(lanes, 1), lane_strides(operands, lanes), fit, stream])
    _fit("decoder_lstm_bwd", fit, h_dims)
    _build.check(err, "decoder_lstm_bwd")
    BWD_LAUNCHES += 1
    count_lanes("decoder_lstm_bwd", lanes)
    _count_plans("decoder_lstm_bwd")
    BWD_PLAN["decoder_lstm_bwd"] = plan
    return dgates, dh0, dc0


def rows_arg(plan, lanes):
    """A launcher's rows argument: the plan's over lanes, 0 for one lane
    (the source's one-lane count, which a build may override:
    ``perf_probe.py rows``)."""
    return plan["rows"] if lanes > 1 else 0


def refusal(fit) -> str:
    """What a refused launch's ``fit`` array (``lstm_common.cuh``'s Fit)
    says: the bytes a block needs past the card's, and the plan at which
    it still did not fit (0: the weights read from L2). No width reaches a
    refusal since every chain has the ``SCRATCH`` plan; the launchers keep
    the gate against a pass that would pass the card's shared memory."""
    where = ("even with its weights read from L2" if fit[3] == 0
             else f"on a cluster of {fit[3]}")
    return (f"needs {fit[1]} bytes of shared memory a block, past the "
            f"card's {fit[2]}, {where}")


def _fit(name, fit, h_dims):
    """Raise ``ValueError`` for a launch the kernel refused before it
    started (``fit`` its ``lstm_common.cuh`` Fit array), naming the
    widths; else record the chain's plan in ``CLUSTERS`` (a cluster, 0 or
    ``SCRATCH``)."""
    if fit[0]:
        raise ValueError(f"{name} {refusal(fit)}: cells {list(h_dims)} "
                         f"(largest {max(h_dims)})")
    CLUSTERS[name] = fit[4]


def count_plans(plans, name, l2, scratch):
    """Count a launch of ``name`` whose chains' ``plans`` read weights
    from L2 (0) into the dict ``l2``, and one with a chain on ``SCRATCH``
    into ``scratch``."""
    for plan, counter in ((0, l2), (SCRATCH, scratch)):
        if plan in plans:
            counter[name] = counter.get(name, 0) + 1


def _count_plans(name):
    count_plans((CLUSTERS[name],), name, L2_LAUNCHES, SCRATCH_LAUNCHES)


def decoder_lstm_bwd_plain(wsum, gates, allc, dallh):
    """The same function as the kernel in plain PyTorch, step for step
    the body of ``_dec_bwd_kernel``."""
    t = allc.shape[0]
    dh, dc = dallh[t - 1], torch.zeros_like(allc[0])
    dgates = [None] * (t - 1)
    for i in range(t - 1, 0, -1):
        ig, fg, gg, og = gates[i].chunk(4, dim=-1)
        si, sf, so = torch.sigmoid(ig), torch.sigmoid(fg), torch.sigmoid(og)
        tg, tc = torch.tanh(gg), torch.tanh(allc[i])
        do = dh * tc
        dc = dc + dh * so * (1.0 - tc * tc)
        dg = torch.cat([
            dc * tg * si * (1.0 - si),
            dc * allc[i - 1] * sf * (1.0 - sf),
            dc * si * (1.0 - tg * tg),
            do * so * (1.0 - so),
        ], dim=-1)
        dgates[i - 1] = dg
        dh = dg @ wsum.T + dallh[i - 1]
        dc = dc * sf
    return torch.stack(dgates), dh, dc


def cell_columns(H, o, h, device):
    """The gate-major columns of the cell of units [o, o + h) in a fused
    (*, 4H) tensor."""
    return torch.cat([torch.arange(q * H + o, q * H + o + h)
                      for q in range(4)]).to(device)


def cluster_columns(h: int, cluster: int) -> int:
    """The gate columns each block of a cluster holds when a cell's 4h
    columns are split (``csrc/cell_bwd.cuh``'s ``cell_cols``): all of
    them for one block, else runs of a multiple of 4, the last ones past
    4h zero."""
    if cluster == 1:
        return 4 * h
    return ((4 * h + cluster - 1) // cluster + 3) & ~3


def cell_dh_split_plain(dg, wcell, cluster: int):
    """``dg @ wcell.T`` (dg (n, 4h), wcell (h, 4h)) as a cluster of
    ``cluster`` blocks forms it: block b's partial over its run of gate
    columns, the partials added in rank order, block 0 first."""
    h4 = wcell.shape[1]
    kc = cluster_columns(h4 // 4, cluster)
    dh = None
    for b in range(cluster):
        cols = slice(min(b * kc, h4), min((b + 1) * kc, h4))
        part = dg[:, cols] @ wcell[:, cols].T
        dh = part if dh is None else dh + part
    return dh


def decoder_lstm_bwd_cells_plain(wsum, gates, allc, dallh, h_dims):
    """``decoder_lstm_bwd_plain`` as the kernel splits it: one independent
    chain per cell of ``h_dims``, each against its own diagonal blocks of
    ``wsum``."""
    t, n, H = allc.shape
    dgates = torch.empty((t - 1, n, 4 * H), dtype=allc.dtype,
                         device=allc.device)
    dh0, dc0 = torch.empty_like(allc[0]), torch.empty_like(allc[0])
    o = 0
    for h in h_dims:
        cols = cell_columns(H, o, h, allc.device)
        cell = slice(o, o + h)
        dg, dh0[:, cell], dc0[:, cell] = decoder_lstm_bwd_plain(
            wsum[cell][:, cols].contiguous(), gates[..., cols],
            allc[..., cell], dallh[..., cell])
        dgates[..., cols] = dg
        o += h
    return dgates, dh0, dc0


class DecoderLSTM(torch.autograd.Function):
    """``allh`` of the decoder recurrence with its hand-derived backward."""

    @staticmethod
    def forward(ctx, h0, c0, wsum, b, t, h_dims):
        allh, allc, gates = decoder_lstm_fwd(h0, c0, wsum, b, t, h_dims)
        ctx.save_for_backward(wsum, b, allh, allc, gates)
        ctx.t, ctx.h_dims = t, list(h_dims)
        return allh

    @staticmethod
    def backward(ctx, dallh):
        wsum, b, allh, allc, gates = ctx.saved_tensors
        t = ctx.t
        if t == 1:
            return (dallh[0], torch.zeros_like(allc[0]),
                    torch.zeros_like(wsum), torch.zeros_like(b), None, None)
        dgates, dh0, dc0 = decoder_lstm_bwd(wsum, gates, allc,
                                            dallh.contiguous(), ctx.h_dims)
        n, H = dh0.shape
        B = dgates.reshape((t - 1) * n, 4 * H)
        dwsum = allh[:t - 1].reshape((t - 1) * n, H).T @ B
        db = B.sum(0).reshape(b.shape)
        return dh0, dc0, dwsum, db, None, None


# ------------------------------------------------- fused encoder cells

def multi_lstm_fwd(xp, wh, h_dims, with_res: bool = False):
    """k fused LSTM cells over time from a zero state (JAX:
    ``_enc_fwd_call``): ``xp (t, n, 4H)`` the gate-major input projections,
    bias included, ``wh (H, 4H)`` the block-diagonal recurrent weight over
    the cells ``h_dims``. Returns ``h_last (n, H)``, or with ``with_res``
    ``(h_last, allh, allc, gates)``: (t, n, H), (t, n, H) and the
    pre-activation gates (t, n, 4H)."""
    if xp.dim() != 3 or xp.shape[2] % 4:
        raise ValueError(f"xp must be (t, n, 4H), got {tuple(xp.shape)}")
    t, n, H4 = xp.shape
    _check_tensors([("xp", xp), ("wh", wh)],
                   {"xp": (t, n, H4), "wh": (H4 // 4, H4)}, h_dims, H4 // 4)
    if xp.device.type == "cpu":
        return multi_lstm_plain(xp, wh, with_res)
    return _launch_multi(xp, wh, h_dims, with_res)


@torch.library.custom_op("ftt::multi_lstm_eval", mutates_args=())
def multi_lstm_eval(xp: torch.Tensor, wh: torch.Tensor,
                    h_dims: List[int]) -> torch.Tensor:
    """``multi_lstm_fwd``'s ``h_last`` as the custom op
    ``ftt::multi_lstm_eval``, so that ``torch.export`` keeps the call
    whole, shape checks and launch plans inside it: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    return multi_lstm_fwd(xp, wh, h_dims)


@multi_lstm_eval.register_fake
def _multi_lstm_eval_shape(xp, wh, h_dims):
    return xp.new_empty((xp.shape[1], xp.shape[2] // 4))


def _launch_multi(xp, wh, h_dims, with_res, lanes: int = 0):
    """The encoder cells' forward kernel, as ``_launch``."""
    global MULTI_LAUNCHES
    t, n, H4 = xp.shape[-3:]
    H = H4 // 4
    fn = _build.kernel(
        "multi_lstm_fwd",
        [ctypes.c_void_p] * 6 + STATE_ARGTYPES + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + LANE_ARGTYPES + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lead = (lanes,) if lanes else ()

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32,
                           device=xp.device)

    outs = [empty(n, H)]
    if with_res:
        outs += [empty(t, n, H), empty(t, n, H), empty(t, n, H4)]
    res = outs[1:] if with_res else [None] * 3
    operands = (xp, wh, outs[0], *res)
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    fit = (ctypes.c_int * 6)()
    plan = chain_fwd_plan(h_dims, n, lanes, decoder=False, train=with_res)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch_chains(
            fn, xp.device,
            [None if x is None else x.data_ptr() for x in operands],
            [t, n, H, len(h_dims), dims, int(with_res),
             rows_arg(plan, lanes), max(lanes, 1),
             lane_strides(operands, lanes), fit, stream])
    _fit("multi_lstm_fwd", fit, h_dims)
    _build.check(err, "multi_lstm_fwd")
    MULTI_LAUNCHES += 1
    count_lanes("multi_lstm_fwd", lanes)
    _count_plans("multi_lstm_fwd")
    FWD_PLAN["multi_lstm_fwd"] = plan
    return tuple(outs) if with_res else outs[0]


def multi_lstm_plain(xp, wh, with_res: bool = False):
    """The same function as the kernel in plain PyTorch, step for step the
    body of ``_enc_fwd_kernel``."""
    t, n, H4 = xp.shape
    h = xp.new_zeros((n, H4 // 4))
    c = xp.new_zeros((n, H4 // 4))
    allh, allc, gates = [], [], []
    for i in range(t):
        g = xp[i] + h @ wh
        h, c = lstm_step(c, g)
        if with_res:
            allh.append(h)
            allc.append(c)
            gates.append(g)
    if not with_res:
        return h
    return h, torch.stack(allh), torch.stack(allc), torch.stack(gates)


def multi_lstm_bwd(gates, wh, allc, dhlast, h_dims):
    """BPTT of the fused cells (JAX: ``_enc_bwd_call``) from the forward's
    ``gates`` and ``allc`` and the cotangent ``dhlast (n, H)`` of the last
    hidden state: ``dxp (t, n, 4H)``, which is dgates."""
    if allc.dim() != 3:
        raise ValueError(f"allc must be (t, n, H), got {tuple(allc.shape)}")
    t, n, H = allc.shape
    _check_tensors([("allc", allc), ("gates", gates), ("wh", wh),
                    ("dhlast", dhlast)],
                   {"allc": (t, n, H), "gates": (t, n, 4 * H),
                    "wh": (H, 4 * H), "dhlast": (n, H)}, h_dims, H)
    if allc.device.type == "cpu":
        return multi_lstm_bwd_plain(gates, wh, allc, dhlast)
    return _launch_multi_bwd(gates, wh, allc, dhlast, h_dims)


def _launch_multi_bwd(gates, wh, allc, dhlast, h_dims, lanes: int = 0):
    """The encoder cells' backward kernel, as ``_launch_bwd``."""
    global MULTI_BWD_LAUNCHES
    t, n, H = allc.shape[-3:]
    fn = _build.kernel(
        "multi_lstm_bwd",
        [ctypes.c_void_p] * 5 + STATE_ARGTYPES + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + LANE_ARGTYPES + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    dxp = torch.empty(((lanes,) if lanes else ()) + (t, n, 4 * H),
                      dtype=torch.float32, device=allc.device)
    operands = (gates, allc, dhlast, wh, dxp)
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    fit = (ctypes.c_int * 6)()
    plan = chain_bwd_plan(h_dims, n, lanes, decoder=False)
    with torch.cuda.device(allc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch_chains(
            fn, allc.device, [x.data_ptr() for x in operands],
            [t, n, H, len(h_dims), dims, MULTI_BWD_THREADS,
             rows_arg(plan, lanes), max(lanes, 1),
             lane_strides(operands, lanes), fit, stream])
    _fit("multi_lstm_bwd", fit, h_dims)
    _build.check(err, "multi_lstm_bwd")
    MULTI_BWD_LAUNCHES += 1
    count_lanes("multi_lstm_bwd", lanes)
    _count_plans("multi_lstm_bwd")
    BWD_PLAN["multi_lstm_bwd"] = plan
    return dxp


def multi_lstm_bwd_plain(gates, wh, allc, dhlast):
    """The same function as the kernel in plain PyTorch, step for step the
    body of ``_enc_bwd_kernel``: step 0 reads a zero previous cell
    state."""
    t = allc.shape[0]
    dh, dc = dhlast, torch.zeros_like(dhlast)
    dxp = [None] * t
    for i in range(t - 1, -1, -1):
        cp = allc[i - 1] if i > 0 else torch.zeros_like(allc[0])
        ig, fg, gg, og = gates[i].chunk(4, dim=-1)
        si, sf, so = torch.sigmoid(ig), torch.sigmoid(fg), torch.sigmoid(og)
        tg, tc = torch.tanh(gg), torch.tanh(allc[i])
        do = dh * tc
        dc = dc + dh * so * (1.0 - tc * tc)
        dg = torch.cat([
            dc * tg * si * (1.0 - si),
            dc * cp * sf * (1.0 - sf),
            dc * si * (1.0 - tg * tg),
            do * so * (1.0 - so),
        ], dim=-1)
        dxp[i] = dg
        dh = dg @ wh.T
        dc = dc * sf
    return torch.stack(dxp)


def multi_lstm_bwd_cells_plain(gates, wh, allc, dhlast, h_dims,
                               cluster: int = 1):
    """``multi_lstm_bwd_plain`` as the kernel splits it: one independent
    chain per cell of ``h_dims``, each against its own diagonal blocks of
    ``wh``, its dh product formed as a cluster of ``cluster`` blocks forms
    it (``cell_dh_split_plain``)."""
    t, n, H = allc.shape
    dxp = torch.empty_like(gates)
    o = 0
    for h in h_dims:
        cols = cell_columns(H, o, h, allc.device)
        wcell = wh[o:o + h][:, cols]
        dh, dc = dhlast[:, o:o + h], torch.zeros_like(dhlast[:, o:o + h])
        for i in range(t - 1, -1, -1):
            c_i = allc[i, :, o:o + h]
            cp = allc[i - 1, :, o:o + h] if i > 0 else torch.zeros_like(c_i)
            ig, fg, gg, og = gates[i][:, cols].chunk(4, dim=-1)
            si, sf, so = (torch.sigmoid(ig), torch.sigmoid(fg),
                          torch.sigmoid(og))
            tg, tc = torch.tanh(gg), torch.tanh(c_i)
            dc = dc + dh * so * (1.0 - tc * tc)
            dg = torch.cat([
                dc * tg * si * (1.0 - si),
                dc * cp * sf * (1.0 - sf),
                dc * si * (1.0 - tg * tg),
                dh * tc * so * (1.0 - so),
            ], dim=-1)
            dxp[i][:, cols] = dg
            dh = cell_dh_split_plain(dg, wcell, cluster)
            dc = dc * sf
        o += h
    return dxp


class MultiLSTM(torch.autograd.Function):
    """``h_last`` of the fused encoder cells with its hand-derived
    backward."""

    @staticmethod
    def forward(ctx, xp, wh, h_dims):
        h_last, allh, allc, gates = multi_lstm_fwd(xp, wh, h_dims,
                                                   with_res=True)
        ctx.save_for_backward(wh, allh, allc, gates)
        ctx.h_dims = list(h_dims)
        return h_last

    @staticmethod
    def backward(ctx, dhlast):
        wh, allh, allc, gates = ctx.saved_tensors
        dxp = multi_lstm_bwd(gates, wh, allc, dhlast.contiguous(),
                             ctx.h_dims)
        return dxp, recurrent_weight_grad(allh, dxp), None


def multi_lstm(xp, wh, h_dims):
    """``h_last (n, H)`` of the fused cells: through ``MultiLSTM`` when a
    gradient is wanted, else the eval forward alone (no residuals
    written); under ``torch.func.vmap`` through the lane kernels
    (``VmapMultiLSTM``)."""
    if batched(xp, wh):
        return VmapMultiLSTM.apply(xp, wh, list(h_dims))
    if torch.is_grad_enabled() and (xp.requires_grad or wh.requires_grad):
        return MultiLSTM.apply(xp, wh, list(h_dims))
    return multi_lstm_fwd(xp, wh, h_dims)


# ------------------------------------------------------------------ lanes
#
# K problems of one shape in one launch: the counterpart of the lane axis
# that jax.vmap puts in front of each Pallas grid (the JAX package's
# multi-seed trainer vmaps its whole train step). Every operand has a
# leading lane dimension K, each lane's slice contiguous; a lane stride of
# 0 (an ``expand``ed operand) shares one array between the lanes. On the
# CPU each wrapper runs its ``*_lanes_plain`` version, the single-lane
# plain version lane by lane.

def batched(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``torch.func.vmap`` batched tensor
    (the lane route)."""
    return any(isinstance(x, torch.Tensor)
               and torch._C._functorch.is_batchedtensor(x) for x in tensors)


def lanes_of(x, dim, lanes: int):
    """``x`` with its vmapped dimension ``dim`` moved to the front and each
    lane contiguous, or, where ``dim`` is None (an operand the lanes
    share), ``x`` expanded to ``lanes`` lanes of stride 0."""
    if x is None:
        return None
    if dim is None:
        return x.contiguous().expand(lanes, *x.shape)
    return x.movedim(dim, 0).contiguous()


def check_lanes(named):
    """Each (name, tensor) of ``named`` has the same leading lane count
    and contiguous lanes; returns that count."""
    lanes = named[0][1].shape[0]
    for name, x in named:
        if x is None:
            continue
        if x.dim() < 2 or x.shape[0] != lanes:
            raise ValueError(f"{name} must have a leading lane dimension "
                             f"of {lanes}, got {tuple(x.shape)}")
        if not x[0].is_contiguous():
            raise ValueError(f"{name}'s lanes must be contiguous")
    return lanes


def _per_lane(fn, lanes, *args):
    """``fn`` lane by lane over the lane dimension of every tensor of
    ``args`` (others passed as they are), each output stacked."""
    outs = [fn(*(a[k] if isinstance(a, torch.Tensor) else a for a in args))
            for k in range(lanes)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def decoder_lstm_lanes_plain(h0, c0, wsum, b, t: int):
    """``decoder_lstm_plain`` lane by lane."""
    return _per_lane(decoder_lstm_plain, h0.shape[0], h0, c0, wsum, b, t)


def decoder_lstm_fwd_lanes(h0, c0, wsum, b, t: int, h_dims):
    """``decoder_lstm_fwd`` over K lanes in one launch: ``h0``, ``c0``
    (K, n, H), ``wsum`` (K, H, 4H), ``b`` (K, 4H) or (K, 1, 4H); returns
    ``(allh, allc, gates)`` each with the lane dimension in front."""
    lanes = check_lanes([("h0", h0), ("c0", c0), ("wsum", wsum), ("b", b)])
    _check(h0[0], c0[0], wsum[0], b[0], t, h_dims)
    if h0.device.type == "cpu":
        return decoder_lstm_lanes_plain(h0, c0, wsum, b, t)
    return _launch(h0, c0, wsum, b, t, h_dims, lanes)


def decoder_lstm_bwd_lanes_plain(wsum, gates, allc, dallh):
    """``decoder_lstm_bwd_plain`` lane by lane."""
    return _per_lane(decoder_lstm_bwd_plain, allc.shape[0], wsum, gates,
                     allc, dallh)


def decoder_lstm_bwd_lanes(wsum, gates, allc, dallh, h_dims):
    """``decoder_lstm_bwd`` over K lanes in one launch, each operand with
    the lane dimension in front."""
    lanes = check_lanes([("allc", allc), ("wsum", wsum), ("gates", gates),
                         ("dallh", dallh)])
    t, n, H = allc.shape[1:]
    if t < 2:
        raise ValueError(f"the backward needs t >= 2, got {t}")
    _check_tensors(
        [("allc", allc[0]), ("wsum", wsum[0]), ("gates", gates[0]),
         ("dallh", dallh[0])],
        {"wsum": (H, 4 * H), "gates": (t, n, 4 * H), "allc": (t, n, H),
         "dallh": (t, n, H)}, h_dims, H)
    if allc.device.type == "cpu":
        return decoder_lstm_bwd_lanes_plain(wsum, gates, allc, dallh)
    return _launch_bwd(wsum, gates, allc, dallh, h_dims, lanes)


def multi_lstm_lanes_plain(xp, wh, with_res: bool = False):
    """``multi_lstm_plain`` lane by lane."""
    return _per_lane(multi_lstm_plain, xp.shape[0], xp, wh, with_res)


def multi_lstm_fwd_lanes(xp, wh, h_dims, with_res: bool = False):
    """``multi_lstm_fwd`` over K lanes in one launch: ``xp`` (K, t, n,
    4H), ``wh`` (K, H, 4H); the outputs with the lane dimension in
    front."""
    lanes = check_lanes([("xp", xp), ("wh", wh)])
    t, n, H4 = xp.shape[1:]
    _check_tensors([("xp", xp[0]), ("wh", wh[0])],
                   {"xp": (t, n, H4), "wh": (H4 // 4, H4)}, h_dims, H4 // 4)
    if xp.device.type == "cpu":
        return multi_lstm_lanes_plain(xp, wh, with_res)
    return _launch_multi(xp, wh, h_dims, with_res, lanes)


def multi_lstm_bwd_lanes_plain(gates, wh, allc, dhlast):
    """``multi_lstm_bwd_plain`` lane by lane."""
    return _per_lane(multi_lstm_bwd_plain, allc.shape[0], gates, wh, allc,
                     dhlast)


def multi_lstm_bwd_lanes(gates, wh, allc, dhlast, h_dims):
    """``multi_lstm_bwd`` over K lanes in one launch."""
    lanes = check_lanes([("allc", allc), ("gates", gates), ("wh", wh),
                         ("dhlast", dhlast)])
    t, n, H = allc.shape[1:]
    _check_tensors([("allc", allc[0]), ("gates", gates[0]), ("wh", wh[0]),
                    ("dhlast", dhlast[0])],
                   {"allc": (t, n, H), "gates": (t, n, 4 * H),
                    "wh": (H, 4 * H), "dhlast": (n, H)}, h_dims, H)
    if allc.device.type == "cpu":
        return multi_lstm_bwd_lanes_plain(gates, wh, allc, dhlast)
    return _launch_multi_bwd(gates, wh, allc, dhlast, h_dims, lanes)


def recurrent_weight_grad_lanes(allh, dgates):
    """``recurrent_weight_grad`` of each lane, one batched product."""
    K, t, n, H = allh.shape
    if t == 1:
        return allh.new_zeros((K, H, 4 * H))
    return torch.bmm(allh[:, :-1].reshape(K, -1, H).transpose(1, 2),
                     dgates[:, 1:].reshape(K, -1, 4 * H))


class LaneDecoderLSTM(torch.autograd.Function):
    """``DecoderLSTM`` over K lanes: every operand and output with the lane
    dimension in front."""

    @staticmethod
    def forward(ctx, h0, c0, wsum, b, t, h_dims):
        allh, allc, gates = decoder_lstm_fwd_lanes(h0, c0, wsum, b, t,
                                                   h_dims)
        ctx.save_for_backward(wsum, b, allh, allc, gates)
        ctx.t, ctx.h_dims = t, list(h_dims)
        return allh

    @staticmethod
    def backward(ctx, dallh):
        wsum, b, allh, allc, gates = ctx.saved_tensors
        t = ctx.t
        if t == 1:
            return (dallh[:, 0], torch.zeros_like(allc[:, 0]),
                    torch.zeros_like(wsum), torch.zeros_like(b), None, None)
        dgates, dh0, dc0 = decoder_lstm_bwd_lanes(
            wsum, gates, allc, dallh.contiguous(), ctx.h_dims)
        K, _, n, H = allh.shape
        B = dgates.reshape(K, (t - 1) * n, 4 * H)
        dwsum = torch.bmm(allh[:, :t - 1].reshape(K, -1, H).transpose(1, 2),
                          B)
        db = B.sum(1).reshape(b.shape)
        return dh0, dc0, dwsum, db, None, None


class LaneMultiLSTM(torch.autograd.Function):
    """``MultiLSTM`` over K lanes."""

    @staticmethod
    def forward(ctx, xp, wh, h_dims):
        h_last, allh, allc, gates = multi_lstm_fwd_lanes(xp, wh, h_dims,
                                                         with_res=True)
        ctx.save_for_backward(wh, allh, allc, gates)
        ctx.h_dims = list(h_dims)
        return h_last

    @staticmethod
    def backward(ctx, dhlast):
        wh, allh, allc, gates = ctx.saved_tensors
        dxp = multi_lstm_bwd_lanes(gates, wh, allc, dhlast.contiguous(),
                                   ctx.h_dims)
        return dxp, recurrent_weight_grad_lanes(allh, dxp), None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


class VmapDecoderLSTM(torch.autograd.Function):
    """``decoder_lstm`` under ``torch.func.vmap``: its vmap rule runs the
    lanes in one launch each way (``LaneDecoderLSTM``, or the lane
    forward alone where no gradient is wanted). Outside vmap it is the
    forward alone."""

    @staticmethod
    def forward(h0, c0, wsum, b, t, h_dims):
        return decoder_lstm_fwd(h0, c0, wsum, b, t, h_dims)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, h0, c0, wsum, b, t, h_dims):
        K = info.batch_size
        ops = [lanes_of(x, d, K) for x, d in zip((h0, c0, wsum, b),
                                                  in_dims[:4])]
        if _wants_grad(*ops):
            return LaneDecoderLSTM.apply(*ops, t, h_dims), 0
        return decoder_lstm_fwd_lanes(*ops, t, h_dims)[0], 0


class VmapMultiLSTM(torch.autograd.Function):
    """``multi_lstm`` under ``torch.func.vmap`` (see
    ``VmapDecoderLSTM``)."""

    @staticmethod
    def forward(xp, wh, h_dims):
        return multi_lstm_fwd(xp, wh, h_dims)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, xp, wh, h_dims):
        K = info.batch_size
        xp, wh = (lanes_of(x, d, K) for x, d in zip((xp, wh), in_dims[:2]))
        if _wants_grad(xp, wh):
            return LaneMultiLSTM.apply(xp, wh, h_dims), 0
        return multi_lstm_fwd_lanes(xp, wh, h_dims), 0
