"""The fused MFM encode, forward and backward: the CUDA kernels' wrappers
and their plain PyTorch versions (port of ``ops/pallas_mfn.py``).

Three kernels, each with a launch counter per variant:

- ``csrc/mfm_encode_fwd.cu``: the forward, eval or train (``LAUNCHES``).
  In train mode it takes the dropout masks and, when a backward follows,
  writes the residuals: ``allh``, ``allc``, ``allmem`` and the ten
  ``RES_NAMES`` fields, as one ``(t, n, R)`` buffer (layout ``"cat"``,
  the training path's) or as ten ``(t, n, width)`` tensors (layout
  ``"split"``, ``SPLIT_LAUNCHES``). The kernels read and write the fields
  through a residual-layout table (``csrc/mfm_res.cuh``). One call
  launches three passes in order (``FWD_PASSES``): one chain per LSTM
  cell (the cell's weights in shared memory), the attention branch for
  all steps at once, and the memory's chain (its weights in shared
  memory); ``mfm_encode_fwd_passes_plain`` is the same data flow in
  plain PyTorch.
- ``csrc/mfm_encode_bwd.cu::mfm_encode_bwd``: the reverse pass,
  writing ``dxp`` (= dgates) and each step's deltas in the
  ``DELTA_NAMES`` layout, as four kernels launched in order
  (``BWD_PASSES``): the gates for all steps at once, the memory carry's
  chain (one block per row tile), the attention branch for
  all steps at once, and one chain per LSTM cell (the cell's weights in
  shared memory). ``mfm_encode_bwd_passes_plain`` is the same data flow
  in plain PyTorch. A chain whose weights pass one block's shared memory
  splits them over a thread-block cluster of 2, 4 or 8 blocks, the
  smallest that fits; past 8 it reads them in place from L2
  (``CLUSTERS`` records each call's plans, 0 for L2; ``L2_LAUNCHES``
  counts the launches with a chain reading from L2), and where a chain's
  per-row state alone passes a block too, it keeps that state in a
  scratch of device memory (plan ``cuda_lstm.SCRATCH``,
  ``SCRATCH_LAUNCHES``). The plans are made from the widths before any
  launch, and every width has one. Variants:
  ``"stream"`` (the training path's, ``BWD_LAUNCHES``),
  ``"recompute_att"`` (att recomputed from r1, ``RECOMPUTE_LAUNCHES``)
  and ``"two_step"`` (the chains take reverse steps in pairs, t even,
  ``TWO_STEP_LAUNCHES``); the last two are the probe variants of
  ``factorized_tpu_torch/probes/``.
- ``csrc/mfm_encode_bwd.cu::mfm_encode_dw`` (``DW_LAUNCHES``): the 14
  non-``wh`` weight and bias gradients as 7 grouped products ``A^T
  delta`` over the t * n rows, each bias the column sum of its weight's
  delta, into one buffer. Each 64 x 64 output tile splits the rows over a
  thread-block cluster of S blocks (``dw_cluster``, from one lane's
  tiles), whose partial tiles are added in a fixed order: no atomics, the
  same bits on every run and at every lane count (``DW_PLAN`` records the
  last call's S and copy width). Over lanes the forward, the reverse pass
  and the weight gradients launch once a pass for any lane count, the
  chains' rows a block chosen by ``fwd_plan`` and ``bwd_plan``
  (``FWD_PLAN`` and ``BWD_PLAN`` record the last call's).

A wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; there is no other route. ``dWh`` is one
``torch.matmul`` outside the kernels, as the JAX package leaves it to
XLA. ``MFMEncode`` is the ``torch.autograd.Function`` over the pair
(JAX: the ``custom_vjp`` of ``mfm_encode_pallas``); ``make_variant``,
``make_variant_d`` and ``make_variant_two_step`` give the probes'
layout and variant pairs over it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from factorized_tpu_torch.ops import _build
from factorized_tpu_torch.ops.core import dropout_mask
from factorized_tpu_torch.ops import cuda_lstm
from factorized_tpu_torch.ops.cuda_lstm import (
    LANE_ARGTYPES, STATE_ARGTYPES, batched, cell_chain_bytes, cell_columns,
    chain_plan, check_lanes, conflict_free_pitch, count_lanes, count_plans,
    fwd_chain_bytes, lane_strides, lanes_of,
    lanes_per_output, launch_chains, pad4, recurrent_weight_grad_lanes,
    refusal, rows_arg, rows_plan)
from factorized_tpu_torch.ops.lstm import recurrent_weight_grad

W_NAMES = ("wh", "a1w1", "a1b1", "a1w2", "a1b2", "a2w1", "a2b1",
           "a2w2", "a2b2", "gw1", "gb1", "g1w2", "g1b2", "g2w2", "g2b2")
DW_NAMES = W_NAMES[1:]
# residual layout of the train forward, unchanged from the JAX package:
# r1/r2/r3 are post-dropout relu activations, kg* = mask * (u > 0)
RES_NAMES = ("att", "r1", "kg1", "r2", "kg2", "r3", "kg3", "chat",
             "g1", "g2")
# what the reverse pass writes per step for the weight-gradient sums
DELTA_NAMES = ("dq1", "dq2", "du3", "dch", "du2", "dlogits", "du1")
# each in-kernel gradient as A^T @ delta over the t * n rows
DW_PRODUCTS = {
    "a1w1": ("cstar", "du1"), "a1b1": ("ones", "du1"),
    "a1w2": ("r1", "dlogits"), "a1b2": ("ones", "dlogits"),
    "a2w1": ("attended", "du2"), "a2b1": ("ones", "du2"),
    "a2w2": ("r2", "dch"), "a2b2": ("ones", "dch"),
    "gw1": ("both", "du3"), "gb1": ("ones", "du3"),
    "g1w2": ("r3a", "dq1"), "g1b2": ("ones", "dq1"),
    "g2w2": ("r3b", "dq2"), "g2b2": ("ones", "dq2"),
}

# the residual layouts and the backward's variants
LAYOUTS = ("cat", "split")
BWD_VARIANTS = ("stream", "recompute_att", "two_step")

LAUNCHES = 0            # mfm_encode_fwd: eval, and train in the cat layout
SPLIT_LAUNCHES = 0      # mfm_encode_fwd: train in the split layout
BWD_LAUNCHES = 0        # mfm_encode_bwd, stream
RECOMPUTE_LAUNCHES = 0  # mfm_encode_bwd, recompute_att
TWO_STEP_LAUNCHES = 0   # mfm_encode_bwd, two_step
DW_LAUNCHES = 0         # mfm_encode_dw
# the launches of each kernel with a lane axis, by kernel (counted in the
# counters above too; see cuda_lstm's lanes section)
LANE_LAUNCHES = {}
# threads per block of the forward's chains and softmax (the attention's
# products run 256-thread tiles), the fastest measured by perf_probe.py
# (PERF.md); the rows a chain's block takes are fwd_plan's
THREADS = 512
# threads per block of the reverse pass's gates pass, chains and softmax
# (the attention products run 256-thread tiles), at the training batch
# (perf_probe.py train); the rows each pass's block takes are fixed in
# csrc/mfm_encode_bwd.cu from the same sweep
BWD_THREADS = 512
# the reverse pass's passes, in launch order, each by the names of its
# CUDA kernels
BWD_PASSES = {"gates": ("gates_kernel",),
              "memory_chain": ("mem_chain_kernel",),
              "attention": ("recompute_att_kernel", "product_kernel",
                            "softmax_bwd_kernel"),
              "lstm_chains": ("lstm_chains_kernel",)}
# the forward's passes, likewise
FWD_PASSES = {"lstm_chains": ("cell_chains_fwd_kernel",),
              "attention": ("product_fwd_kernel", "softmax_fwd_kernel"),
              "memory_chain": ("mem_chain_fwd_kernel",)}
# the plans the last call of each wrapper ran its chains on, by chain: the
# thread-block cluster (1: one block), 0: the weights read from L2, or
# cuda_lstm.SCRATCH: with them the per-row state in device memory
CLUSTERS = {}
# launches of each wrapper with a chain that read its weights from L2, and
# with a chain that kept its state in device memory
L2_LAUNCHES = {}
SCRATCH_LAUNCHES = {}
# the weight-gradient kernel's output tile and rows a chunk
# (csrc/mfm_encode_bwd.cu: kDwTile, kDwChunk), and the blocks one lane's
# launch aims for, which set the cluster that splits K (dw_cluster): two
# a SM of the H100's 132 (perf_probe.py train)
DW_TILE, DW_CHUNK = 64, 32
DW_BLOCKS = 264
# the last weight-gradient launch's plan: the cluster size S and the
# bytes of its staging copies (16, or 4 where the widths or offsets are
# not multiples of four floats)
DW_PLAN = {}
# the last reverse pass's plan (bwd_plan) and the last forward's
# (fwd_plan), by chain
BWD_PLAN = {}
FWD_PLAN = {}


def sizes(weights):
    """(s1, s2, s3, s4, mem): the four MLP widths and the memory width."""
    s3 = weights["g1w2"].shape[0]
    return (weights["a1w1"].shape[1], weights["a2w1"].shape[1], s3,
            weights["gw1"].shape[1] - s3, weights["a2w2"].shape[1])


# the forward's LSTM chains and memory chain take one of these row counts
# a block (csrc/mfm_encode_fwd.cu: kCellRowCounts, kMemRowCounts), chosen
# by fwd_plan; one lane takes EVAL_ROWS without residuals and TRAIN_ROWS
# with them (LSTM chains, memory chain; kEval*Rows, kTrain*Rows), the
# fastest measured at the serving and the training batch (perf_probe.py
# rows)
FWD_CELL_ROW_COUNTS, FWD_MEM_ROW_COUNTS = (2, 4, 8, 16), (1, 2, 4, 8, 16)
EVAL_ROWS, TRAIN_ROWS = (8, 2), (2, 1)
# the reverse pass's chains take one of these row counts a block
# (csrc/mfm_encode_bwd.cu: kMemRowCounts, kCellRowCounts), chosen by
# bwd_plan; the first of each is one lane's at the training batch, the
# fastest measured there (perf_probe.py rows); the operand floats a row
# and unit of the reverse LSTM chains
BWD_MEM_ROW_COUNTS, BWD_CELL_ROW_COUNTS = (1, 2, 4, 8, 16), (2, 4, 8, 16)
BWD_MEM_ROWS, BWD_CELL_ROWS = BWD_MEM_ROW_COUNTS[0], BWD_CELL_ROW_COUNTS[0]
BWD_CELL_OP_WIDTH = 8


def _mem_fwd_bytes(mem, s3, s4, C, rows, threads):
    """The forward's memory chain, a block on a cluster of C (0: L2)."""
    s34 = s3 + s4
    state = rows * (2 * mem + s34 + 2 * (2 * s34 + mem))
    if C == 0:
        return 4 * state
    cu, cm = -(-s34 // C), -(-mem // C)
    pu = conflict_free_pitch(mem, lanes_per_output(cu, threads))
    ksm = lanes_per_output(cm, threads)
    return 4 * (pad4(cu * pu) + pad4(cm * conflict_free_pitch(s3, ksm))
                + pad4(cm * conflict_free_pitch(s4, ksm)) + state)


def _mem_bwd_bytes(mem, s34, C, rows, threads):
    """The reverse pass's memory chain, likewise."""
    state = 2 * rows * (4 * mem + s34) + rows * (5 * mem + s34)
    if C == 0:
        return 4 * state
    cu, cm = -(-s34 // C), -(-mem // C)
    return 4 * (cu * conflict_free_pitch(mem, lanes_per_output(cu, threads))
                + cm * conflict_free_pitch(s34, lanes_per_output(cm, threads))
                + state)


def encode_plans(h_dims, s3: int, s4: int, mem: int, train: bool = True):
    """The plans of the encode's chains for the fused cells ``h_dims``,
    gamma widths s3, s4 and memory ``mem``, before any launch (the
    launchers' arithmetic, ``cuda_lstm.chain_plan``), as ``CLUSTERS``
    records them: ``mfm_encode_fwd`` (LSTM chains, memory chain) with the
    train or eval rows and, in training, ``mfm_encode_bwd`` (memory chain,
    LSTM chains)."""
    cr, mr = TRAIN_ROWS if train else EVAL_ROWS
    plans = {"mfm_encode_fwd": (
        chain_plan(lambda C: fwd_chain_bytes(h_dims, cr, THREADS, C)),
        chain_plan(lambda C: _mem_fwd_bytes(mem, s3, s4, C, mr, THREADS)))}
    if train:
        plans["mfm_encode_bwd"] = (
            chain_plan(lambda C: _mem_bwd_bytes(mem, s3 + s4, C,
                                                BWD_MEM_ROWS, BWD_THREADS)),
            chain_plan(lambda C: cell_chain_bytes(
                h_dims, BWD_CELL_ROWS, BWD_THREADS, BWD_CELL_OP_WIDTH, C)))
    return plans


def bwd_plan(h_dims, s3: int, s4: int, mem: int, n: int, lanes: int = 1,
             wave=None):
    """The reverse pass's rows a block, chosen from the lanes and the
    batch by ``cuda_lstm.rows_plan``: for the memory chain and for the
    LSTM chains, one lane the first count at any batch (the one-model path
    keeps the rows measured fastest there), more lanes the count
    (``BWD_MEM_ROW_COUNTS``, ``BWD_CELL_ROW_COUNTS``) whose blocks take the
    fewest waves of what the card holds at once among those that sum in
    the one-lane order, so lane k's bits do not depend on the lanes.
    ``wave(chain, R, plan, smem_bytes)`` gives what the card holds
    (default ``chain_wave``: its occupancy, registers counted). {chain:
    {"rows", "plan", "row_tiles", "padded_rows", "blocks", "wave",
    "waves"}}; the launcher passes the rows."""
    return _bwd_plan(tuple(h_dims), s3 + s4, mem, n, max(lanes, 1),
                     BWD_THREADS, wave or chain_wave)


@functools.lru_cache(maxsize=None)
def _bwd_plan(h_dims, s34, mem, n, lanes, threads, wave):
    def mem_at(R):
        return lambda C: _mem_bwd_bytes(mem, s34, C, R, threads)

    def cells_at(R):
        return lambda C: cell_chain_bytes(h_dims, R, threads,
                                          BWD_CELL_OP_WIDTH, C)

    return {"memory_chain": rows_plan("memory_chain", mem_at,
                                      BWD_MEM_ROW_COUNTS, n, lanes, 1,
                                      wave),
            "lstm_chains": rows_plan("lstm_chains", cells_at,
                                     BWD_CELL_ROW_COUNTS, n, lanes,
                                     len(h_dims), wave)}


def fwd_plan(h_dims, s3: int, s4: int, mem: int, n: int, lanes: int = 1,
             train: bool = True, wave=None):
    """The forward's rows a block, as ``bwd_plan`` chooses the reverse
    pass's: for the LSTM chains and the memory chain, one lane
    ``TRAIN_ROWS`` with residuals (``train``) or ``EVAL_ROWS`` without at
    any batch (the one-model path and serving keep them), more lanes the
    count of ``FWD_CELL_ROW_COUNTS`` and ``FWD_MEM_ROW_COUNTS`` whose
    blocks take the fewest waves among those that sum in the one-lane
    order; ``wave`` default ``fwd_chain_wave``. {chain: {"rows", "plan",
    "row_tiles", "padded_rows", "blocks", "wave", "waves"}}; the launcher
    passes the rows."""
    return _fwd_plan(tuple(h_dims), s3, s4, mem, n, max(lanes, 1), train,
                     THREADS, wave or fwd_chain_wave)


@functools.lru_cache(maxsize=None)
def _fwd_plan(h_dims, s3, s4, mem, n, lanes, train, threads, wave):
    cr, mr = TRAIN_ROWS if train else EVAL_ROWS

    def cells_at(R):
        return lambda C: fwd_chain_bytes(h_dims, R, threads, C)

    def mem_at(R):
        return lambda C: _mem_fwd_bytes(mem, s3, s4, C, R, threads)

    return {"lstm_chains": rows_plan("lstm_chains", cells_at,
                                     FWD_CELL_ROW_COUNTS, n, lanes,
                                     len(h_dims), wave, cr),
            "memory_chain": rows_plan("memory_chain", mem_at,
                                      FWD_MEM_ROW_COUNTS, n, lanes, 1, wave,
                                      mr)}


def chain_wave(chain: str, rows: int, plan: int, smem_bytes: int) -> int:
    """What the current card holds at once of the reverse pass's ``chain``
    (``"memory_chain"`` or ``"lstm_chains"``) at ``BWD_THREADS`` threads
    (``cuda_lstm.chain_wave`` over ``mfm_encode_bwd_wave``)."""
    return cuda_lstm.chain_wave("mfm_encode_bwd", chain, rows, plan,
                                BWD_THREADS, smem_bytes)


def fwd_chain_wave(chain: str, rows: int, plan: int,
                   smem_bytes: int) -> int:
    """The same for the forward's ``chain`` (``"lstm_chains"`` or
    ``"memory_chain"``) at ``THREADS`` threads (``mfm_encode_fwd_wave``)."""
    return cuda_lstm.chain_wave("mfm_encode_fwd", chain, rows, plan, THREADS,
                                smem_bytes)


def _layout(names, widths):
    offs, o = {}, 0
    for nm in names:
        offs[nm] = (o, widths[nm])
        o += widths[nm]
    return offs, o


def res_layout(weights):
    """{name: (offset, width)} of the residual buffer, and its width R."""
    s1, s2, s3, s4, mem = sizes(weights)
    m2 = weights["a1w1"].shape[0]
    return _layout(RES_NAMES, dict(att=m2, r1=s1, kg1=s1, r2=s2, kg2=s2,
                                   r3=s3 + s4, kg3=s3 + s4, chat=mem,
                                   g1=mem, g2=mem))


def res_fields(res, weights):
    """{name: (t, n, width) tensor} of residuals in either layout: views
    of the one buffer (``"cat"``) or the ten tensors (``"split"``, a
    sequence in the ``RES_NAMES`` order)."""
    if isinstance(res, torch.Tensor):
        return {nm: res[..., o:o + w]
                for nm, (o, w) in res_layout(weights)[0].items()}
    return dict(zip(RES_NAMES, res))


def _res_table(res, weights):
    """The kernels' residual-layout table for ``res``: ten pointers, row
    strides and column offsets as ctypes arrays (``csrc/mfm_res.cuh``)."""
    offs, R = res_layout(weights)
    if isinstance(res, torch.Tensor):
        ptrs = [res.data_ptr()] * len(RES_NAMES)
        strides = [R] * len(RES_NAMES)
        cols = [offs[nm][0] for nm in RES_NAMES]
    else:
        ptrs = [r.data_ptr() for r in res]
        strides = [offs[nm][1] for nm in RES_NAMES]
        cols = [0] * len(RES_NAMES)
    k = len(RES_NAMES)
    return ((ctypes.c_void_p * k)(*ptrs), (ctypes.c_int * k)(*strides),
            (ctypes.c_int * k)(*cols))


_TABLE = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
          ctypes.POINTER(ctypes.c_int)]


def delta_layout(weights):
    """{name: (offset, width)} of the per-step delta buffer, and its
    width."""
    s1, s2, s3, s4, mem = sizes(weights)
    m2 = weights["a1w1"].shape[0]
    return _layout(DELTA_NAMES, dict(dq1=mem, dq2=mem, du3=s3 + s4,
                                     dch=mem, du2=s2, dlogits=m2, du1=s1))


def make_dropout_masks(generator, t: int, n: int, sizes, drops):
    """(t, n, sum(sizes)) scaled keep-masks in the site order att1, att2,
    gamma1, gamma2, on the generator's device; a float rate of 0 gives
    all ones. A rate may be a tensor, a lane's own under
    ``torch.func.vmap`` (the config-bucketed search): its site always
    draws, exactly all ones at 0 and zeros at 1 (``core.dropout_mask``;
    JAX: ``pallas_mfn.make_dropout_masks``)."""
    return torch.cat([dropout_mask(generator, (t, n, s), rate, rows=1)
                      for s, rate in zip(sizes, drops)], dim=2)


# ---------------------------------------------------------------- checks

def _check_tensors(named, device, want):
    for name, tensor in named:
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, xp on {device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape, ok = tuple(tensor.shape), want[name]
        if shape != ok and not (len(ok) == 1 and shape == (1,) + ok):
            raise ValueError(f"{name} must be {ok}, got {shape}")


def _weight_shapes(weights, H, z_tot):
    s1, s2, s3, s4, mem = sizes(weights)
    m2 = 2 * (H - z_tot)
    return {
        "wh": (H, 4 * H), "a1w1": (m2, s1), "a1b1": (s1,), "a1w2": (s1, m2),
        "a1b2": (m2,), "a2w1": (m2, s2), "a2b1": (s2,), "a2w2": (s2, mem),
        "a2b2": (mem,), "gw1": (m2 + mem, s3 + s4), "gb1": (s3 + s4,),
        "g1w2": (s3, mem), "g1b2": (mem,), "g2w2": (s4, mem), "g2b2": (mem,),
    }


def _check(xp, weights, z_tot, h_dims, masks=None):
    if xp.dim() != 3 or xp.shape[2] % 4:
        raise ValueError(f"xp must be (t, n, 4H), got {tuple(xp.shape)}")
    t, n, H4 = xp.shape
    H = H4 // 4
    if sum(h_dims) != H:
        raise ValueError(f"h_dims {list(h_dims)} do not sum to H = {H}")
    prefix = [sum(h_dims[:k]) for k in range(len(h_dims))]
    if z_tot not in prefix:
        raise ValueError(f"z_tot {z_tot} is not a cell boundary of {h_dims}")
    s1, s2, s3, s4, _ = sizes(weights)
    want = dict(_weight_shapes(weights, H, z_tot), xp=(t, n, H4),
                masks=(t, n, s1 + s2 + s3 + s4))
    named = [("xp", xp)] + [(k, weights[k]) for k in W_NAMES]
    if masks is not None:
        named.append(("masks", masks))
    _check_tensors(named, xp.device, want)


def _check_res(res, weights, t, n, device):
    """Raises unless ``res`` is one (t, n, R) buffer or ten (t, n, width)
    tensors in the ``RES_NAMES`` order."""
    offs, R = res_layout(weights)
    if isinstance(res, torch.Tensor):
        _check_tensors([("res", res)], device, {"res": (t, n, R)})
        return
    if len(res) != len(RES_NAMES):
        raise ValueError(f"split residuals must be {len(RES_NAMES)} "
                         f"tensors, got {len(res)}")
    _check_tensors(list(zip(RES_NAMES, res)), device,
                   {nm: (t, n, offs[nm][1]) for nm in RES_NAMES})


def _check_choice(name, value, choices):
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


def _route(device):
    """'cpu' for the plain version, 'cuda' for the kernel; else raise."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device.type


# --------------------------------------------------------------- forward

def mfm_encode(xp, weights, z_tot: int, h_dims, masks=None):
    """Fused encode over time. ``xp (t, n, 4H)`` gate-major input
    projections of the fused cells (``h_dims``, encoders first, up to
    ``z_tot``, 0 for the MFN alone); ``weights`` as in ``W_NAMES``,
    biases ``(1, d)``; ``masks`` the train-mode dropout masks of
    ``make_dropout_masks``, or None (eval: every site is the identity). Returns
    ``(h_last (n, H), mem_last (n, mem))``."""
    _check(xp, weights, z_tot, h_dims, masks)
    if _route(xp.device) == "cpu":
        return mfm_encode_plain(xp, weights, z_tot, masks)
    return _launch_fwd(xp, masks, weights, z_tot, h_dims)


@torch.library.custom_op("ftt::mfm_encode_eval", mutates_args=())
def mfm_encode_eval(xp: torch.Tensor, weights: List[torch.Tensor],
                    z_tot: int, h_dims: List[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mfm_encode`` without masks as the custom op ``ftt::mfm_encode_eval``
    (``weights`` in the ``W_NAMES`` order), so that ``torch.export`` keeps
    the call whole, shape checks and launch plans inside it: the kernel on
    a CUDA tensor, the plain version on a CPU one."""
    return mfm_encode(xp, dict(zip(W_NAMES, weights)), z_tot, h_dims)


@mfm_encode_eval.register_fake
def _mfm_encode_eval_shapes(xp, weights, z_tot, h_dims):
    n, H = xp.shape[1], xp.shape[2] // 4
    mem = weights[W_NAMES.index("a2w2")].shape[1]
    return xp.new_empty((n, H)), xp.new_empty((n, mem))


def mfm_encode_res(xp, masks, weights, z_tot: int, h_dims,
                   layout: str = "cat"):
    """The forward that a backward follows (JAX: ``_fwd_call(...,
    with_res=True)``; ``layout="split"``: the probe's ``_fwd_res_call``):
    ``(h_last, mem_last, allh, allc, allmem, res)``, allh/allc (t, n, H),
    allmem (t, n, mem), res one (t, n, R) buffer in the ``RES_NAMES``
    layout or a tuple of the ten fields. ``masks`` None means all
    ones."""
    _check(xp, weights, z_tot, h_dims, masks)
    _check_choice("layout", layout, LAYOUTS)
    if _route(xp.device) == "cpu":
        return mfm_encode_res_plain(xp, masks, weights, z_tot, layout)
    return _launch_fwd(xp, masks, weights, z_tot, h_dims, layout)


def _fit(name, fit, passes, widths):
    """Raise ``ValueError`` for a launch the kernel refused before it
    started (``fit`` its ``lstm_common.cuh`` Fit array), naming the pass
    and the widths; else record the chains' plans in ``CLUSTERS``."""
    if fit[0]:
        raise ValueError(f"{name}: the {passes[fit[0] - 1]} pass "
                         f"{refusal(fit)}: {widths}")
    CLUSTERS[name] = (fit[4], fit[5])


def _count_plans(name):
    count_plans(CLUSTERS[name], name, L2_LAUNCHES, SCRATCH_LAUNCHES)


def _lane0(weights, lanes):
    """Lane 0's weights of a lane call (the widths come from one lane)."""
    return {k: v[0] for k, v in weights.items()} if lanes else weights


def _res_list(res):
    """The ten residual arrays of ``res`` in the ``RES_NAMES`` order, as
    the launchers' lane strides list them."""
    if isinstance(res, torch.Tensor):
        return [res] * len(RES_NAMES)
    return list(res)


def _launch_fwd(xp, masks, weights, z_tot, h_dims, layout=None, lanes=0):
    """The forward's three passes; ``layout`` None writes no residuals.
    A chain on ``cuda_lstm.SCRATCH`` gets its scratch from
    ``launch_chains``. With ``lanes`` every operand and output has a
    leading lane dimension and each pass is one launch for them all, the
    chains' rows a block ``fwd_plan``'s (one lane: the source's own
    counts)."""
    global LAUNCHES, SPLIT_LAUNCHES
    t, n, H4 = xp.shape[-3:]
    H = H4 // 4
    w0 = _lane0(weights, lanes)
    s1, s2, s3, s4, mem = sizes(w0)
    fn = _build.kernel(
        "mfm_encode_fwd",
        [ctypes.c_void_p] * 22 + _TABLE + [ctypes.c_void_p]
        + STATE_ARGTYPES + [ctypes.c_int] * 10
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + LANE_ARGTYPES
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lead = (lanes,) if lanes else ()

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32,
                           device=xp.device)

    plan = fwd_plan(h_dims, s3, s4, mem, n, lanes, layout is not None)
    rows = [rows_arg(plan[c], lanes) for c in ("lstm_chains", "memory_chain")]
    h_last, mem_last = empty(n, H), empty(n, mem)
    outs = [h_last, mem_last]
    # scratch: pu3, the logits and attended and, without residuals, the
    # cell states, chat, r1 and r2
    m2 = 2 * (H - z_tot)
    if layout is None:
        res_arrays, table = [None] * 3, [None] * 3
        res_lanes = [None] * len(RES_NAMES)
        scratch = empty(t * n * (s3 + s4 + m2 + H + mem + s1 + s2))
    else:
        offs, R = res_layout(w0)
        res = (empty(t, n, R) if layout == "cat" else
               tuple(empty(t, n, offs[nm][1]) for nm in RES_NAMES))
        outs += [empty(t, n, H), empty(t, n, H), empty(t, n, mem), res]
        res_arrays = outs[2:5]
        table = _res_table(res, w0)
        res_lanes = _res_list(res)
        scratch = empty(t * n * (s3 + s4 + m2))
    operands = [xp, masks, *[weights[k] for k in W_NAMES], h_last,
                mem_last, *res_arrays, *res_lanes, scratch]
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    fit = (ctypes.c_int * 6)()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch_chains(
            fn, xp.device,
            [None if x is None else x.data_ptr() for x in operands[:22]]
            + [*table, scratch.data_ptr()],
            [t, n, H, z_tot, mem, s1, s2, s3, s4, len(h_dims), dims,
             THREADS, *rows, max(lanes, 1), lane_strides(operands, lanes),
             fit, stream])
    _fit("mfm_encode_fwd", fit, list(FWD_PASSES),
         f"cells {list(h_dims)} (largest {max(h_dims)}), mem {mem}, "
         f"s3 + s4 {s3 + s4}")
    _build.check(err, "mfm_encode_fwd")
    if layout == "split":
        SPLIT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    count_lanes("mfm_encode_fwd", lanes)
    _count_plans("mfm_encode_fwd")
    FWD_PLAN.clear()
    FWD_PLAN.update(plan)
    return tuple(outs)


def _step_plain(h, c, mem, xp_t, masks_t, w, z_tot):
    """One fused step, as ``_fwd_kernel`` with ``with_res``: returns
    (new_h, new_c, new_mem, residuals in the RES_NAMES order)."""
    s1, s2, s3, s4, _ = sizes(w)
    gates = xp_t + h @ w["wh"]
    ig, fg, gg, og = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(fg) * c + torch.sigmoid(ig) * torch.tanh(gg)
    new_h = torch.sigmoid(og) * torch.tanh(new_c)
    if masks_t is None:
        masks_t = xp_t.new_ones((xp_t.shape[0], s1 + s2 + s3 + s4))
    m1, m2, m34 = masks_t.split([s1, s2, s3 + s4], dim=1)

    def relu_mask(u, m):
        return torch.relu(u) * m, torch.where(u > 0.0, m, 0.0)

    cstar = torch.cat([c[:, z_tot:], new_c[:, z_tot:]], dim=1)
    r1, kg1 = relu_mask(cstar @ w["a1w1"] + w["a1b1"], m1)
    att = torch.softmax(r1 @ w["a1w2"] + w["a1b2"], dim=1)
    attended = att * cstar
    r2, kg2 = relu_mask(attended @ w["a2w1"] + w["a2b1"], m2)
    chat = torch.tanh(r2 @ w["a2w2"] + w["a2b2"])
    both = torch.cat([attended, mem], dim=1)
    r3, kg3 = relu_mask(both @ w["gw1"] + w["gb1"], m34)
    g1 = torch.sigmoid(r3[:, :s3] @ w["g1w2"] + w["g1b2"])
    g2 = torch.sigmoid(r3[:, s3:] @ w["g2w2"] + w["g2b2"])
    new_mem = g1 * mem + g2 * chat
    return new_h, new_c, new_mem, (att, r1, kg1, r2, kg2, r3, kg3, chat,
                                   g1, g2)


def mfm_encode_plain(xp, weights, z_tot: int, masks=None):
    """The same function as the kernel in plain PyTorch: the scan branch
    of the JAX package's ``fused_mfm_encode`` as a Python loop."""
    t, n, H4 = xp.shape
    h = xp.new_zeros((n, H4 // 4))
    c = xp.new_zeros((n, H4 // 4))
    mem = xp.new_zeros((n, sizes(weights)[4]))
    for i in range(t):
        h, c, mem, _ = _step_plain(h, c, mem, xp[i],
                                   None if masks is None else masks[i],
                                   weights, z_tot)
    return h, mem


def mfm_encode_res_plain(xp, masks, weights, z_tot: int,
                         layout: str = "cat"):
    """``mfm_encode_res`` in plain PyTorch."""
    t, n, H4 = xp.shape
    h = xp.new_zeros((n, H4 // 4))
    c = xp.new_zeros((n, H4 // 4))
    mem = xp.new_zeros((n, sizes(weights)[4]))
    allh, allc, allmem, res = [], [], [], []
    for i in range(t):
        h, c, mem, r = _step_plain(h, c, mem, xp[i],
                                   None if masks is None else masks[i],
                                   weights, z_tot)
        allh.append(h)
        allc.append(c)
        allmem.append(mem)
        res.append(r)
    fields = tuple(torch.stack(f) for f in zip(*res))
    return (h, mem, torch.stack(allh), torch.stack(allc),
            torch.stack(allmem),
            torch.cat(fields, dim=2) if layout == "cat" else fields)


def mfm_encode_fwd_passes_plain(xp, weights, z_tot: int, h_dims, masks=None,
                                with_res: bool = False, layout: str = "cat"):
    """The forward as the kernel's three passes split it, in plain
    PyTorch and in their order of summation: (1) one chain per LSTM cell
    of ``h_dims``, against its own diagonal blocks of ``wh``; (2) the
    attention branch of every step at once, with the gamma product's part
    on attended, ``pu3 = attended @ gw1[:M2] + gb1``; (3) the memory's
    chain, ``u3 = pu3 + mem @ gw1[M2:]``. Returns what
    ``mfm_encode_plain`` returns or, with ``with_res``, what
    ``mfm_encode_res_plain`` returns in ``layout``."""
    w = weights
    t, n, H4 = xp.shape
    H = H4 // 4
    s1, s2, s3, s4, mem = sizes(w)
    m2 = w["a1w1"].shape[0]
    if masks is None:
        masks = xp.new_ones((t, n, s1 + s2 + s3 + s4))
    m1, mk2, m34 = masks.split([s1, s2, s3 + s4], dim=2)
    # (1) the LSTM chains, one per cell
    allh, allc = xp.new_empty((t, n, H)), xp.new_empty((t, n, H))
    o = 0
    for h in h_dims:
        cols = cell_columns(H, o, h, xp.device)
        wcell = w["wh"][o:o + h][:, cols]
        hh, cc = xp.new_zeros((n, h)), xp.new_zeros((n, h))
        for i in range(t):
            ig, fg, gg, og = (xp[i][:, cols] + hh @ wcell).chunk(4, dim=-1)
            cc = torch.sigmoid(fg) * cc + torch.sigmoid(ig) * torch.tanh(gg)
            hh = torch.sigmoid(og) * torch.tanh(cc)
            allh[i, :, o:o + h], allc[i, :, o:o + h] = hh, cc
        o += h
    # (2) the attention branch, no carry
    cp = torch.cat([torch.zeros_like(allc[:1]), allc[:-1]])
    cstar = torch.cat([cp[..., z_tot:], allc[..., z_tot:]], dim=-1)

    def relu_mask(u, m):
        return torch.relu(u) * m, torch.where(u > 0.0, m, 0.0)

    r1, kg1 = relu_mask(cstar @ w["a1w1"] + w["a1b1"], m1)
    att = torch.softmax(r1 @ w["a1w2"] + w["a1b2"], dim=-1)
    attended = att * cstar
    r2, kg2 = relu_mask(attended @ w["a2w1"] + w["a2b1"], mk2)
    chat = torch.tanh(r2 @ w["a2w2"] + w["a2b2"])
    pu3 = attended @ w["gw1"][:m2] + w["gb1"]
    # (3) the memory chain
    memv = xp.new_zeros((n, mem))
    chain = {k: [] for k in ("r3", "kg3", "g1", "g2", "mem")}
    for i in range(t):
        r3, kg3 = relu_mask(pu3[i] + memv @ w["gw1"][m2:], m34[i])
        g1 = torch.sigmoid(r3[:, :s3] @ w["g1w2"] + w["g1b2"])
        g2 = torch.sigmoid(r3[:, s3:] @ w["g2w2"] + w["g2b2"])
        memv = g1 * memv + g2 * chat[i]
        for k, v in zip(chain, (r3, kg3, g1, g2, memv)):
            chain[k].append(v)
    if not with_res:
        return allh[-1], memv
    r3, kg3, g1, g2, allmem = (torch.stack(chain[k]) for k in chain)
    fields = (att, r1, kg1, r2, kg2, r3, kg3, chat, g1, g2)
    return (allh[-1], memv, allh, allc, allmem,
            torch.cat(fields, dim=2) if layout == "cat" else fields)


# -------------------------------------------------------------- backward

def mfm_encode_bwd(xp, weights, allh, allc, allmem, res, dhlast, dmemlast,
                   z_tot: int, h_dims, variant: str = "stream"):
    """The encode's backward (JAX: ``_bwd_call``) from the residuals of
    ``mfm_encode_res``, in either layout, and the cotangents of
    ``h_last`` and ``mem_last``. ``variant`` picks the reverse kernel:
    ``"stream"`` (the training path's), ``"recompute_att"`` (att
    recomputed from r1) or ``"two_step"`` (t even). Returns
    ``(dxp (t, n, 4H), {name: grad})`` over ``W_NAMES``."""
    _check(xp, weights, z_tot, h_dims)
    _check_choice("variant", variant, BWD_VARIANTS)
    t, n, H4 = xp.shape
    H, mem = H4 // 4, sizes(weights)[4]
    _check_tensors(
        [("allh", allh), ("allc", allc), ("allmem", allmem),
         ("dhlast", dhlast), ("dmemlast", dmemlast)], xp.device,
        {"allh": (t, n, H), "allc": (t, n, H), "allmem": (t, n, mem),
         "dhlast": (n, H), "dmemlast": (n, mem)})
    _check_res(res, weights, t, n, xp.device)
    if variant == "two_step" and t % 2:
        raise ValueError(f"the two-step backward needs an even t, got {t}")
    if _route(xp.device) == "cpu":
        return mfm_encode_bwd_plain(xp, weights, allh, allc, allmem, res,
                                    dhlast, dmemlast, z_tot,
                                    recompute_att=variant == "recompute_att")
    dxp, deltas = _launch_bwd(xp, weights, allh, allc, allmem, res, dhlast,
                              dmemlast, z_tot, h_dims, variant)
    dweights = _launch_dw(weights, allc, allmem, res, deltas, z_tot)
    # one GEMM outside the kernels (JAX leaves it to XLA)
    dweights["wh"] = recurrent_weight_grad(allh, dxp)
    return dxp, dweights


def _launch_bwd(xp, weights, allh, allc, allmem, res, dhlast, dmemlast,
                z_tot, h_dims, variant="stream", lanes=0):
    """The reverse pass's kernels: (dxp, deltas (t, n, D)). A chain on
    ``cuda_lstm.SCRATCH`` gets its scratch from ``launch_chains``. With
    ``lanes``, every operand and output has a leading lane dimension."""
    global BWD_LAUNCHES, RECOMPUTE_LAUNCHES, TWO_STEP_LAUNCHES
    t, n, H4 = xp.shape[-3:]
    H = H4 // 4
    w0 = _lane0(weights, lanes)
    s1, s2, s3, s4, mem = sizes(w0)
    m2 = 2 * (H - z_tot)
    fn = _build.kernel(
        "mfm_encode_bwd",
        [ctypes.c_void_p] * 4 + _TABLE + [ctypes.c_void_p] * 17
        + STATE_ARGTYPES + [ctypes.c_int] * 10
        + [ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_int] * 4 + LANE_ARGTYPES
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lead = (lanes,) if lanes else ()

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32,
                           device=xp.device)

    dxp, deltas = empty(t, n, H4), empty(t, n, delta_layout(w0)[1])
    # one scratch buffer: the gates, dcstar, datt, and att when it is
    # recomputed
    recompute = variant == "recompute_att"
    lengths = [t * n * w for w in [H4, m2, m2] + [m2] * recompute]
    scratch = list(empty(sum(lengths)).split(lengths, dim=-1))
    scratch += [None] * (not recompute)
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    fit = (ctypes.c_int * 6)()
    # the rows a block of each chain (the probes' two-step variant: the
    # first counts, its only instantiations)
    plan = bwd_plan(h_dims, s3, s4, mem, n, lanes)
    if variant == "two_step":
        plan = {c: dict(p, rows=r) for (c, p), r in
                zip(plan.items(), (BWD_MEM_ROWS, BWD_CELL_ROWS))}
    rows = [plan[c]["rows"] for c in ("memory_chain", "lstm_chains")]
    used = ("wh", "a1w1", "a1w2", "a1b2", "a2w1", "a2w2", "gw1", "g1w2",
            "g2w2")
    operands = [xp, allh, allc, allmem, *_res_list(res), dhlast, dmemlast,
                *[weights[k] for k in used], dxp, deltas, *scratch]
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch_chains(
            fn, xp.device,
            [xp.data_ptr(), allh.data_ptr(), allc.data_ptr(),
             allmem.data_ptr(), *_res_table(res, w0),
             *[None if x is None else x.data_ptr() for x in operands[14:]]],
            [t, n, H, z_tot, mem, s1, s2, s3, s4, len(h_dims), dims,
             BWD_VARIANTS.index(variant), BWD_THREADS, *rows,
             max(lanes, 1), lane_strides(operands, lanes), fit, stream])
    _fit("mfm_encode_bwd", fit, list(BWD_PASSES),
         f"cells {list(h_dims)} (largest {max(h_dims)}), H {H}, mem {mem}, "
         f"s3 + s4 {s3 + s4}, M2 {m2}")
    _build.check(err, f"mfm_encode_bwd ({variant})")
    if variant == "stream":
        BWD_LAUNCHES += 1
    elif recompute:
        RECOMPUTE_LAUNCHES += 1
    else:
        TWO_STEP_LAUNCHES += 1
    count_lanes("mfm_encode_bwd", lanes)
    _count_plans("mfm_encode_bwd")
    BWD_PLAN.clear()
    BWD_PLAN.update(plan)
    return dxp, deltas


def dw_cluster(weights, rows: int) -> int:
    """The blocks S (1, 2, 4 or 8, a thread-block cluster) over which the
    weight-gradient kernel splits the ``rows`` = t * n of each output
    tile, from one lane's tiles (one weight's shape, lanes in front or
    not): the smallest S whose S x tiles reaches ``DW_BLOCKS``, doubled
    only while each of its slices keeps a full chunk of rows. Every lane
    count takes this S, so lane k's sums do not depend on the lanes."""
    return _dw_cluster(tuple(tuple(weights[k].shape[-2:]) for k in DW_NAMES),
                       rows, DW_BLOCKS)


@functools.lru_cache(maxsize=None)
def _dw_cluster(shapes, rows, blocks):
    tiles = sum(-(-shape[0] // DW_TILE) * -(-shape[1] // DW_TILE)
                for shape, (a, _) in zip(shapes, DW_PRODUCTS.values())
                if a != "ones")
    S = 1
    while S < 8 and S * tiles < blocks and rows >= 2 * S * DW_CHUNK:
        S *= 2
    return S


@functools.lru_cache(maxsize=None)
def _dw_views(shapes):
    """The floats of the weight-gradient kernel's output buffer, and each
    gradient's (shape, stride, offset) in it: one after another in
    ``DW_NAMES`` order, row-major."""
    views, at = [], 0
    for shape in shapes:
        views.append((shape, (shape[1], 1), at))
        at += shape.numel()
    return at, views


_DW_ARGTYPES = ([ctypes.c_void_p] * 2 + _TABLE + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 10 + LANE_ARGTYPES
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def _launch_dw(weights, allc, allmem, res, deltas, z_tot, lanes=0):
    """The weight-gradient kernel: {name: grad} for DW_NAMES, each shaped
    like its weight (with ``lanes``, each lane's in front), views in that
    order of one buffer that the kernel fills."""
    global DW_LAUNCHES
    t, n, H = allc.shape[-3:]
    w0 = _lane0(weights, lanes)
    s1, s2, s3, s4, mem = sizes(w0)
    fn = _build.kernel("mfm_encode_dw", _DW_ARGTYPES)
    shapes = tuple(w0[k].shape for k in DW_NAMES)
    total, views = _dw_views(shapes)
    cluster = dw_cluster(w0, t * n)
    out = torch.empty(((lanes,) if lanes else ()) + (total,),
                      dtype=torch.float32, device=allc.device)
    operands = [allc, allmem, *_res_list(res), deltas, out]
    copy = (ctypes.c_int * 1)()
    with torch.cuda.device(allc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(allc.data_ptr(), allmem.data_ptr(),
                 *_res_table(res, w0), deltas.data_ptr(),
                 out.data_ptr(), t, n, H, z_tot, mem, s1, s2, s3, s4,
                 cluster, max(lanes, 1), lane_strides(operands, lanes), copy,
                 stream)
    _build.check(err, "mfm_encode_dw")
    DW_LAUNCHES += 1
    count_lanes("mfm_encode_dw", lanes)
    DW_PLAN.update(cluster=cluster, copy_bytes=copy[0])
    if lanes:
        return {k: out.as_strided((lanes,) + tuple(shape),
                                  (total,) + stride, at)
                for k, (shape, stride, at) in zip(DW_NAMES, views)}
    return {k: out.as_strided(*view) for k, view in zip(DW_NAMES, views)}


def mfm_encode_bwd_steps_plain(xp, weights, allh, allc, allmem, res,
                               dhlast, dmemlast, z_tot: int,
                               recompute_att: bool = False):
    """The reverse-time pass in plain PyTorch, step for step the body of
    ``_bwd_kernel``: returns (dxp, deltas (t, n, D)) as the kernel
    writes them. ``res`` in either layout; ``recompute_att`` takes att
    from r1, a1w2 and a1b2 instead of the stored field (the probe's
    variant B)."""
    w = weights
    t, n, H4 = xp.shape
    m2 = w["a1w1"].shape[0]
    M = m2 // 2
    fields = res_fields(res, w)

    def get(nm, i):
        return fields[nm][i]

    dh, dc, dmem = dhlast, torch.zeros_like(dhlast), dmemlast
    pad = xp.new_zeros((n, z_tot))
    dxp, deltas = [None] * t, [None] * t
    for i in reversed(range(t)):
        if i > 0:
            hp, cp, memp = allh[i - 1], allc[i - 1], allmem[i - 1]
        else:
            hp, cp, memp = (torch.zeros_like(allh[0]),
                            torch.zeros_like(allc[0]),
                            torch.zeros_like(allmem[0]))
        c_i = allc[i]
        # gate activations recomputed, as the TPU kernel does
        ig, fg, gg, og = (xp[i] + hp @ w["wh"]).chunk(4, dim=-1)
        si, sf, so = torch.sigmoid(ig), torch.sigmoid(fg), torch.sigmoid(og)
        tg, tc = torch.tanh(gg), torch.tanh(c_i)
        cstar = torch.cat([cp[:, z_tot:], c_i[:, z_tot:]], dim=1)
        if recompute_att:
            att = torch.softmax(get("r1", i) @ w["a1w2"] + w["a1b2"], dim=1)
        else:
            att = get("att", i)
        chat, g1, g2 = get("chat", i), get("g1", i), get("g2", i)

        # the memory update and the gamma gates
        dq1 = dmem * memp * g1 * (1.0 - g1)
        dq2 = dmem * chat * g2 * (1.0 - g2)
        dch = dmem * g2 * (1.0 - chat * chat)
        dmem_prev = dmem * g1
        du3 = torch.cat([dq1 @ w["g1w2"].T, dq2 @ w["g2w2"].T],
                        dim=1) * get("kg3", i)
        dboth = du3 @ w["gw1"].T
        dmem_prev = dmem_prev + dboth[:, m2:]
        # att2 / chat
        du2 = (dch @ w["a2w2"].T) * get("kg2", i)
        dattended = dboth[:, :m2] + du2 @ w["a2w1"].T
        # attended = att * cstar and the softmax
        datt = dattended * cstar
        dcstar = dattended * att
        dlogits = att * (datt - torch.sum(datt * att, dim=1, keepdim=True))
        du1 = (dlogits @ w["a1w2"].T) * get("kg1", i)
        dcstar = dcstar + du1 @ w["a1w1"].T
        # cStar feeds the current cell state and the previous one
        dc_i = dc + torch.cat([pad, dcstar[:, M:]], dim=1)
        dc_prev_att = torch.cat([pad, dcstar[:, :M]], dim=1)
        # the LSTM cells
        do = dh * tc
        dc_full = dc_i + dh * so * (1.0 - tc * tc)
        dgates = torch.cat([
            dc_full * tg * si * (1.0 - si),
            dc_full * cp * sf * (1.0 - sf),
            dc_full * si * (1.0 - tg * tg),
            do * so * (1.0 - so),
        ], dim=-1)
        dxp[i] = dgates
        deltas[i] = torch.cat([dq1, dq2, du3, dch, du2, dlogits, du1], dim=1)
        dh = dgates @ w["wh"].T
        dc = dc_full * sf + dc_prev_att
        dmem = dmem_prev
    return torch.stack(dxp), torch.stack(deltas)


def mfm_encode_bwd_two_step_plain(xp, weights, allh, allc, allmem, res,
                                  dhlast, dmemlast, z_tot: int):
    """The two-step kernel's plain version. Two reverse steps per
    iteration (JAX: ``twostep_bwd_probe._bwd2_kernel``) is a schedule of
    the same function, so this is ``mfm_encode_bwd_steps_plain``; like
    the kernel, it raises for an odd t."""
    if xp.shape[0] % 2:
        raise ValueError(
            f"the two-step backward needs an even t, got {xp.shape[0]}")
    return mfm_encode_bwd_steps_plain(xp, weights, allh, allc, allmem, res,
                                      dhlast, dmemlast, z_tot)


def mfm_encode_bwd_passes_plain(xp, weights, allh, allc, allmem, res,
                                dhlast, dmemlast, z_tot: int, h_dims,
                                recompute_att: bool = False):
    """The reverse pass as the kernel's four passes split it, in plain
    PyTorch: (dxp, deltas) as ``mfm_encode_bwd_steps_plain`` returns them.
    (1) the gates of every step at once; (2) the memory carry's chain,
    which nothing else feeds; (3) the attention branch of every step at
    once; (4) one chain per LSTM cell, taking only dcstar from the rest."""
    w = weights
    t, n, H4 = xp.shape
    H = H4 // 4
    s1, s2, s3, s4, mem = sizes(w)
    m2 = w["a1w1"].shape[0]
    M = m2 // 2
    f = res_fields(res, w)

    def before(a):  # each step's previous state, zeros before step 0
        return torch.cat([torch.zeros_like(a[:1]), a[:-1]])

    # (1) the gates, no carry
    gates = xp + before(allh) @ w["wh"]
    # (2) the memory chain: dmem_prev = dmem * g1 + du3 @ gw1[M2:]^T
    memp = before(allmem)
    chain = {k: [None] * t for k in ("dq1", "dq2", "dch", "du3")}
    dmem = dmemlast
    for i in reversed(range(t)):
        g1, g2, chat = f["g1"][i], f["g2"][i], f["chat"][i]
        dq1 = dmem * memp[i] * g1 * (1.0 - g1)
        dq2 = dmem * chat * g2 * (1.0 - g2)
        chain["dch"][i] = dmem * g2 * (1.0 - chat * chat)
        du3 = torch.cat([dq1 @ w["g1w2"].T, dq2 @ w["g2w2"].T],
                        dim=1) * f["kg3"][i]
        chain["dq1"][i], chain["dq2"][i], chain["du3"][i] = dq1, dq2, du3
        dmem = dmem * g1 + du3 @ w["gw1"][m2:].T
    dq1, dq2, dch, du3 = (torch.stack(chain[k])
                          for k in ("dq1", "dq2", "dch", "du3"))
    # (3) the attention branch, no carry
    cp = before(allc)
    cstar = torch.cat([cp[..., z_tot:], allc[..., z_tot:]], dim=-1)
    att = (torch.softmax(f["r1"] @ w["a1w2"] + w["a1b2"], dim=-1)
           if recompute_att else f["att"])
    du2 = (dch @ w["a2w2"].T) * f["kg2"]
    dattended = du3 @ w["gw1"][:m2].T + du2 @ w["a2w1"].T
    datt = dattended * cstar
    dlogits = att * (datt - torch.sum(datt * att, dim=-1, keepdim=True))
    du1 = (dlogits @ w["a1w2"].T) * f["kg1"]
    dcstar = dattended * att + du1 @ w["a1w1"].T
    # (4) the LSTM chains, one per cell
    dxp = torch.empty_like(xp)
    o = 0
    for h in h_dims:
        cols = cell_columns(H, o, h, xp.device)
        wcell = w["wh"][o:o + h][:, cols]
        if o >= z_tot:
            dcs_p = dcstar[..., o - z_tot:o - z_tot + h]
            dcs_i = dcstar[..., M + o - z_tot:M + o - z_tot + h]
        else:
            dcs_p = dcs_i = torch.zeros_like(allc[..., o:o + h])
        dh, dc = dhlast[:, o:o + h], torch.zeros_like(dhlast[:, o:o + h])
        for i in reversed(range(t)):
            ig, fg, gg, og = gates[i][:, cols].chunk(4, dim=-1)
            si, sf, so = (torch.sigmoid(ig), torch.sigmoid(fg),
                          torch.sigmoid(og))
            tg, tc = torch.tanh(gg), torch.tanh(allc[i, :, o:o + h])
            dc_full = dc + dcs_i[i] + dh * so * (1.0 - tc * tc)
            dg = torch.cat([
                dc_full * tg * si * (1.0 - si),
                dc_full * cp[i, :, o:o + h] * sf * (1.0 - sf),
                dc_full * si * (1.0 - tg * tg),
                dh * tc * so * (1.0 - so),
            ], dim=-1)
            dxp[i][:, cols] = dg
            dh = dg @ wcell.T
            dc = dc_full * sf + dcs_p[i]
        o += h
    return dxp, torch.cat([dq1, dq2, du3, dch, du2, dlogits, du1], dim=-1)


def dw_operands(allc, allmem, res, weights, z_tot: int):
    """The A operands of ``DW_PRODUCTS`` as (t * n, P) matrices:
    forward residuals, and cStar, attended and memp rebuilt from the
    cell states and the memory (zero before step 0)."""
    t, n, _ = allc.shape
    fields = res_fields(res, weights)
    s3 = weights["g1w2"].shape[0]
    cp = torch.cat([torch.zeros_like(allc[:1]), allc[:-1]])
    memp = torch.cat([torch.zeros_like(allmem[:1]), allmem[:-1]])
    cstar = torch.cat([cp[..., z_tot:], allc[..., z_tot:]], dim=-1)
    attended = fields["att"] * cstar
    ops = {"cstar": cstar, "attended": attended,
           "both": torch.cat([attended, memp], dim=-1),
           "r1": fields["r1"], "r2": fields["r2"],
           "r3a": fields["r3"][..., :s3], "r3b": fields["r3"][..., s3:]}
    return {k: v.reshape(t * n, -1) for k, v in ops.items()}


def mfm_encode_dw_plain(allc, allmem, res, deltas, weights, z_tot: int):
    """The 14 in-kernel weight gradients in plain PyTorch: {name: grad}
    for DW_NAMES, each shaped like its weight."""
    t, n, _ = allc.shape
    A = dw_operands(allc, allmem, res, weights, z_tot)
    offs, _ = delta_layout(weights)
    D = deltas.reshape(t * n, -1)
    grads = {}
    for name, (a, d) in DW_PRODUCTS.items():
        o, wd = offs[d]
        delta = D[:, o:o + wd]
        g = delta.sum(0) if a == "ones" else A[a].T @ delta
        grads[name] = g.reshape(weights[name].shape)
    return grads


def mfm_encode_bwd_plain(xp, weights, allh, allc, allmem, res, dhlast,
                         dmemlast, z_tot: int, recompute_att: bool = False):
    """``mfm_encode_bwd`` in plain PyTorch (every variant: the two-step
    one computes the same function as the stream one)."""
    dxp, deltas = mfm_encode_bwd_steps_plain(xp, weights, allh, allc,
                                             allmem, res, dhlast, dmemlast,
                                             z_tot, recompute_att)
    dweights = mfm_encode_dw_plain(allc, allmem, res, deltas, weights, z_tot)
    dweights["wh"] = recurrent_weight_grad(allh, dxp)
    return dxp, dweights


# --------------------------------------------------------------- autograd

class MFMEncode(torch.autograd.Function):
    """``(h_last, mem_last)`` of the fused encode with its hand-derived
    backward; the masks get no gradient. ``layout`` is the residuals'
    (``LAYOUTS``), ``variant`` the reverse kernel's (``BWD_VARIANTS``)."""

    @staticmethod
    def forward(ctx, xp, masks, z_tot, h_dims, layout, variant, *wlist):
        weights = dict(zip(W_NAMES, wlist))
        h_last, mem_last, allh, allc, allmem, res = mfm_encode_res(
            xp, masks, weights, z_tot, h_dims, layout)
        res = [res] if layout == "cat" else list(res)
        ctx.save_for_backward(xp, allh, allc, allmem, *wlist, *res)
        ctx.z_tot, ctx.h_dims = z_tot, list(h_dims)
        ctx.layout, ctx.variant = layout, variant
        ctx.mark_non_differentiable(*(() if masks is None else (masks,)))
        return h_last, mem_last

    @staticmethod
    def backward(ctx, dh_last, dmem_last):
        xp, allh, allc, allmem, *rest = ctx.saved_tensors
        wlist, res = rest[:len(W_NAMES)], rest[len(W_NAMES):]
        weights = dict(zip(W_NAMES, wlist))
        dh_last = (torch.zeros_like(allh[0]) if dh_last is None
                   else dh_last.contiguous())
        dmem_last = (torch.zeros_like(allmem[0]) if dmem_last is None
                     else dmem_last.contiguous())
        dxp, dweights = mfm_encode_bwd(
            xp, weights, allh, allc, allmem,
            res[0] if ctx.layout == "cat" else tuple(res), dh_last,
            dmem_last, ctx.z_tot, ctx.h_dims, ctx.variant)
        return (dxp, None, None, None, None, None,
                *[dweights[k].reshape(weights[k].shape) for k in W_NAMES])


def encode(xp, weights, z_tot: int, h_dims, masks=None, *,
           layout: str = "cat", variant: str = "stream"):
    """``(h_last, mem_last)``: through ``MFMEncode`` when a gradient is
    wanted, else the forward alone (no residuals written). ``layout`` and
    ``variant`` choose the residual layout and the reverse kernel; the
    defaults are the training path's, the only ones of the lane route
    that ``torch.func.vmap`` takes (``VmapEncode``)."""
    _check_choice("layout", layout, LAYOUTS)
    _check_choice("variant", variant, BWD_VARIANTS)
    tensors = [xp] + [weights[k] for k in W_NAMES]
    if batched(masks, *tensors):
        return VmapEncode.apply(xp, masks, z_tot, list(h_dims),
                                *[weights[k] for k in W_NAMES])
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return MFMEncode.apply(xp, masks, z_tot, list(h_dims), layout,
                               variant, *[weights[k] for k in W_NAMES])
    return mfm_encode(xp, weights, z_tot, h_dims, masks)


# ------------------------------------------------------------------ lanes
#
# K encodes of one shape in one launch a pass (see cuda_lstm's lanes
# section): every operand and output with a leading lane dimension, the
# residuals in the training path's layout ("cat") and its reverse kernel
# ("stream"). On the CPU each wrapper runs its ``*_lanes_plain`` version,
# the single-lane plain version lane by lane.

def _check_lanes(xp, weights, z_tot, h_dims, masks=None):
    """The lane count, each operand's lanes checked as ``_check`` checks
    one lane's."""
    lanes = check_lanes([("xp", xp), ("masks", masks)]
                        + [(k, weights[k]) for k in W_NAMES])
    _check(xp[0], _lane0(weights, lanes), z_tot, h_dims,
           None if masks is None else masks[0])
    return lanes


def _lane(weights, k):
    return {name: w[k] for name, w in weights.items()}


def mfm_encode_lanes_plain(xp, weights, z_tot: int, masks=None):
    """``mfm_encode_plain`` lane by lane."""
    outs = [mfm_encode_plain(xp[k], _lane(weights, k), z_tot,
                             None if masks is None else masks[k])
            for k in range(xp.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def mfm_encode_lanes(xp, weights, z_tot: int, h_dims, masks=None):
    """``mfm_encode`` over K lanes in one launch a pass: ``xp`` (K, t, n,
    4H), each weight (K, ...), ``masks`` (K, t, n, S) or None; returns
    ``(h_last, mem_last)`` with the lane dimension in front."""
    lanes = _check_lanes(xp, weights, z_tot, h_dims, masks)
    if _route(xp.device) == "cpu":
        return mfm_encode_lanes_plain(xp, weights, z_tot, masks)
    return _launch_fwd(xp, masks, weights, z_tot, h_dims, lanes=lanes)


def mfm_encode_res_lanes_plain(xp, masks, weights, z_tot: int):
    """``mfm_encode_res_plain`` (layout "cat") lane by lane."""
    outs = [mfm_encode_res_plain(xp[k], None if masks is None else masks[k],
                                 _lane(weights, k), z_tot)
            for k in range(xp.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def mfm_encode_res_lanes(xp, masks, weights, z_tot: int, h_dims):
    """``mfm_encode_res`` (layout "cat") over K lanes in one launch a
    pass."""
    lanes = _check_lanes(xp, weights, z_tot, h_dims, masks)
    if _route(xp.device) == "cpu":
        return mfm_encode_res_lanes_plain(xp, masks, weights, z_tot)
    return _launch_fwd(xp, masks, weights, z_tot, h_dims, "cat", lanes)


def mfm_encode_bwd_lanes_plain(xp, weights, allh, allc, allmem, res,
                               dhlast, dmemlast, z_tot: int):
    """``mfm_encode_bwd_plain`` lane by lane: (dxp, {name: grad}) with the
    lane dimension in front."""
    outs = [mfm_encode_bwd_plain(xp[k], _lane(weights, k), allh[k], allc[k],
                                 allmem[k], res[k], dhlast[k], dmemlast[k],
                                 z_tot)
            for k in range(xp.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            {name: torch.stack([o[1][name] for o in outs])
             for name in W_NAMES})


def mfm_encode_bwd_lanes(xp, weights, allh, allc, allmem, res, dhlast,
                         dmemlast, z_tot: int, h_dims):
    """``mfm_encode_bwd`` (the "stream" reverse kernel) over K lanes: one
    launch a pass of the reverse pass, one of the weight gradients, and
    dWh one batched product."""
    lanes = _check_lanes(xp, weights, z_tot, h_dims)
    t, n, H4 = xp.shape[1:]
    H, mem = H4 // 4, sizes(_lane0(weights, lanes))[4]
    check_lanes([("allh", allh), ("allc", allc), ("allmem", allmem),
                 ("res", res), ("dhlast", dhlast), ("dmemlast", dmemlast)])
    _check_tensors(
        [("allh", allh[0]), ("allc", allc[0]), ("allmem", allmem[0]),
         ("dhlast", dhlast[0]), ("dmemlast", dmemlast[0])], xp.device,
        {"allh": (t, n, H), "allc": (t, n, H), "allmem": (t, n, mem),
         "dhlast": (n, H), "dmemlast": (n, mem)})
    _check_res(res[0], _lane0(weights, lanes), t, n, xp.device)
    if _route(xp.device) == "cpu":
        return mfm_encode_bwd_lanes_plain(xp, weights, allh, allc, allmem,
                                          res, dhlast, dmemlast, z_tot)
    dxp, deltas = _launch_bwd(xp, weights, allh, allc, allmem, res, dhlast,
                              dmemlast, z_tot, h_dims, lanes=lanes)
    dweights = _launch_dw(weights, allc, allmem, res, deltas, z_tot, lanes)
    dweights["wh"] = recurrent_weight_grad_lanes(allh, dxp)
    return dxp, dweights


class LaneMFMEncode(torch.autograd.Function):
    """``MFMEncode`` over K lanes (residuals "cat", reverse kernel
    "stream"): every operand and output with the lane dimension in
    front."""

    @staticmethod
    def forward(ctx, xp, masks, z_tot, h_dims, *wlist):
        weights = dict(zip(W_NAMES, wlist))
        h_last, mem_last, allh, allc, allmem, res = mfm_encode_res_lanes(
            xp, masks, weights, z_tot, h_dims)
        ctx.save_for_backward(xp, allh, allc, allmem, res, *wlist)
        ctx.z_tot, ctx.h_dims = z_tot, list(h_dims)
        ctx.mark_non_differentiable(*(() if masks is None else (masks,)))
        return h_last, mem_last

    @staticmethod
    def backward(ctx, dh_last, dmem_last):
        xp, allh, allc, allmem, res, *wlist = ctx.saved_tensors
        weights = dict(zip(W_NAMES, wlist))
        dh_last = (torch.zeros_like(allh[:, 0]) if dh_last is None
                   else dh_last.contiguous())
        dmem_last = (torch.zeros_like(allmem[:, 0]) if dmem_last is None
                     else dmem_last.contiguous())
        dxp, dweights = mfm_encode_bwd_lanes(
            xp, weights, allh, allc, allmem, res, dh_last, dmem_last,
            ctx.z_tot, ctx.h_dims)
        return (dxp, None, None, None,
                *[dweights[k].reshape(weights[k].shape) for k in W_NAMES])


class VmapEncode(torch.autograd.Function):
    """``encode`` under ``torch.func.vmap``: its vmap rule runs the lanes
    in one launch a pass each way (``LaneMFMEncode``, or the lane eval
    forward where no gradient is wanted). Outside vmap it is the forward
    alone."""

    @staticmethod
    def forward(xp, masks, z_tot, h_dims, *wlist):
        return mfm_encode(xp, dict(zip(W_NAMES, wlist)), z_tot, h_dims,
                          masks)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, xp, masks, z_tot, h_dims, *wlist):
        K = info.batch_size
        tensors = (xp, masks, *wlist)
        dims = (in_dims[0], in_dims[1], *in_dims[4:])
        xp, masks, *wlist = [lanes_of(x, d, K)
                             for x, d in zip(tensors, dims)]
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (xp, *wlist)):
            return LaneMFMEncode.apply(xp, masks, z_tot, h_dims,
                                       *wlist), (0, 0)
        return mfm_encode_lanes(xp, dict(zip(W_NAMES, wlist)), z_tot,
                                h_dims, masks), (0, 0)


# The probes' encodes, ``encode(xp, masks, weights, z_tot, h_dims) ->
# (h_last, mem_last)``, named after the JAX probe's constructors.

def make_variant(store_att: bool):
    """``bwd_residual_probe.make_variant``: the ten residuals split, the
    backward loading att (variant C) or recomputing it (variant B)."""
    variant = "stream" if store_att else "recompute_att"
    return _probe_encode("split", variant)


def make_variant_d():
    """``bwd_residual_probe.make_variant_d``: one residual buffer and the
    streamed backward, the training path's pair."""
    return _probe_encode("cat", "stream")


def make_variant_two_step():
    """``twostep_bwd_probe``'s backward: one residual buffer and two
    reverse steps per iteration (t even)."""
    return _probe_encode("cat", "two_step")


def _probe_encode(layout, variant):
    def run(xp, masks, weights, z_tot, h_dims):
        return encode(xp, weights, z_tot, h_dims, masks, layout=layout,
                      variant=variant)
    return run
