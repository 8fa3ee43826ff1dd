"""Measurements of the port on a CUDA card, for PERF.md.

Run from the repository root on the card:
``python -m factorized_tpu_torch.perf_probe [serve] [train] [multi]
[profile] [times] [scale] [lanes]`` (the first four parts when none is named), or
``python -m factorized_tpu_torch.perf_probe phases`` or ``... rows``
alone. Prints JSON lines:

- ``tile``: each kernel's mean time for each block size the launchers
  take, the forward kernels at the serving shapes (n = 256, t = 20,
  ``best_acc_mosi_config``) and the training kernels at the training
  shapes (n = 32), by device time: the encode forward's threads and the
  backward kernels' threads, the encode's calls split into their passes
  by torch.profiler, the decoder forward (its rows and threads fixed
  in its source), and the weight-gradient kernel at each ``DW_BLOCKS``
  (the cluster size that splits its rows, with the copy width it took);
  a setting whose shared memory does not fit is reported as refused.
  Part ``multi`` does the same for the fused encoder-cell kernels at the
  widths of ``kl_ef`` and ``missing``. So the defaults in
  ``ops/cuda_mfn.py`` and ``ops/cuda_lstm.py`` are chosen from a
  measurement;
- ``tile`` lines with ``rows`` (part ``rows``, run alone): the chains'
  batch rows a block, constants in the sources, for each value of
  ``ROW_SWEEPS`` in a build of its own (``-D<macro>=<rows>``, one
  process a build): the encode forward's passes, the decoder forward,
  ``multi_lstm_fwd`` and ``multi_lstm_bwd``. So the sources' row
  constants are chosen from a measurement;
- ``profile``: ``torch.profiler`` over 20 padded 256-row ``predict``
  calls: wall time, the device time summed over kernels, the share of
  the wall in which the device was idle, and the largest kernels;
- ``kernel_times`` and ``step_times`` (part ``times``): each of the main
  path's kernels at its default knobs, by CUDA events over back-to-back
  calls and by device time (the calls queued behind a sleeping kernel);
  the weight-gradient kernel's library yardstick (``dw_library``: its
  device ms by torch.profiler, since its calls stall the host while the
  card sleeps); each model's train step (device ms summed over kernels
  and copies, the ``record_function`` spans such as Adam's step apart)
  and epoch (``mfm``, ``kl_ef``, ``missing`` and the ablations
  ``m_a``..``m_d``), eager and, where the build has the chunked loop,
  replayed from CUDA graphs; and the padded 256-row predict;
  ``predict_times``
  (part ``times`` too): the padded 256-row predict of each served model
  with its launches, ``device_latency`` and graph where the build has
  them. They call only what every build of the port has, so this module
  run against an earlier build's package (that build first on
  ``sys.path``, e.g. ``PYTHONPATH=<parent> python
  factorized_tpu_torch/perf_probe.py times``) gives the A/B;
- ``lane_times`` (part ``lanes``): ``mfm``'s lane path (``--seeds K``)
  at K = 1, 8, 16 and 32, its ``LaneLoop`` built directly on 19 batches
  of 32 of synthetic MOSI: device ms and launches a step of every lane
  (torch.profiler over 3 eager steps), the replayed epoch's host s
  (median of 3) and device ms, and the epoch graph's capture ms and pool
  bytes; and ``lane_kernels``, the lane kernels over K lanes
  (``lane_kernel_times``): the encode's reverse pass and weight
  gradients at the training shapes, the encode forward's train (n = 32)
  and eval (n = 256) variants, the decoders' chain backward at n = 32
  and 4n = 128 and the encoder cells' (``m_b``'s and ``kl_ef``'s) at n =
  32, the decoders' chain forward at n = 32 and 4n = 128 and the encoder
  cells' (``m_b``'s and ``kl_ef``'s) train at n = 32 and eval at n =
  256: device ms and events ms, launches a call, the plan each call took
  (``cuda_mfn.FWD_PLAN``'s, ``BWD_PLAN``'s and ``cuda_lstm.FWD_PLAN``'s
  and ``BWD_PLAN``'s rows, the blocks the card holds at once and the
  waves they take; ``DW_PLAN``), the bound, for the encode forward each
  of its kernels' device ms (``split_ms``, torch.profiler), for the
  weight gradients the library's 7 ``torch.bmm`` and 7 sums, and for the
  recurrences' forward its plain version (events ms), one
  ``torch.nn.LSTM`` a cell and lane (cuDNN, events ms) and, over lanes,
  its device ms at each instantiated row count (``rows_device_ms``); and ``mfn_kernels``, the
  encode's reverse pass and weight gradients for one model with no lane
  axis at n = 128 for both ``best_mfn_mosi_config``s
  (``mfn_kernel_times``: device ms, the plan). Like ``step_times`` it
  calls only what every lane build has (a plan the build does not record
  is null), for the A/B;
- ``phases`` (part ``phases``, run alone: it builds the kernels with
  ``FTT_PHASE_CLOCKS``): one line per chain kernel and cell, the mean
  SM cycles of each phase of a step over one call's steps, stamped by
  ``clock64()`` in block x = 0 of each cell (``csrc/lstm_common.cuh``),
  at the main path's shapes: ``multi_lstm_bwd`` (n = 32) and
  ``multi_lstm_fwd`` (eval n = 256, train n = 32) at the widths of
  ``kl_ef`` and ``missing``, the decoder forward (n = 32 and 256) and
  backward (n = 32), the encode's reverse pass (n = 32), the encode
  forward's train (n = 32) and eval (n = 256) variants, and the
  weight-gradient kernel (n = 32, a step being a chunk of its rows: load
  and sum); over lanes the decoder backward at K = 2 and 8, the encode
  forward at 8, and the decoder forward (n = 32) and ``m_b``'s encoder
  cells' (train n = 32, eval n = 256) at K = 2 at each row count
  ``csrc/lstm_fwd.cu`` instantiates (lane 0's blocks stamp); with the SM
  clock read just after;
- ``scale`` (part ``scale``): the sweep of the fused path against the
  modular one (``models/mfm.py::FUSED`` forced) over
  ``best_acc_mosi_config`` and the scale probe's configs A to E
  (``benchprog.scale_candidates``), one line a config and path: the
  train step's device ms (one step's CUDA graph, its replays queued
  behind a sleeping kernel, or back to back by CUDA events where
  enqueueing the graph stalls the host while the card sleeps: the
  ``timing`` key), the chain kernels' launches a step, the
  plans ``benchprog.active_paths`` gives and those the launchers
  reported (``CLUSTERS``), the model FLOPs (``utils/flops.py``) and
  their share of the float32 peak, ``_step_flops_estimate`` (the gate's
  measure), the eager step's and the capture's host ms, the graph pool's
  bytes and the peak device memory; then one ``scale_crossover`` line:
  the largest config at which the fused step took fewer device ms, the
  smallest at which it took more, and the geometric midpoint of their
  estimates (``_FUSED_FLOPS_CROSSOVER``);
- ``card``: the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from factorized_tpu_torch.config import best_acc_mosi_config
from factorized_tpu_torch.models import get_model, mfm
from factorized_tpu_torch.models.common import mfn_drops
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
from factorized_tpu_torch.ops.fused import hoist_xproj
from factorized_tpu_torch.serve import Predictor

N = 256
N_TRAIN = 32
# the ablations, which part times steps and serves beside the MFM family
ABLATIONS = ("m_a", "m_b", "m_c", "m_d")
# the per-phase probe's buffer: csrc/lstm_common.cuh's ClockKernel order,
# kMaxCells grid rows, kClockSteps steps, kClockPhases phases
CLOCK_KERNELS = ("multi_lstm_bwd", "decoder_lstm_bwd", "mem_chain_bwd",
                 "cell_chains_bwd", "cell_chains_fwd", "mem_chain_fwd",
                 "lstm_fwd", "encode_dw")
CLOCK_ROWS, CLOCK_STEPS, CLOCK_PHASES = 8, 64, 8
# the chains' batch rows a block, constants in the sources that a build
# can override (-D<macro>=<rows>), and the values part rows times: the
# encode forward's LSTM chains and memory chain without residuals (n =
# 256) and with them (n = 32), multi_lstm_bwd's chains (n = 32), and the
# recurrences' forward chains (csrc/lstm_fwd.cu): the decoders' (n = 32
# and 256) and the encoder cells' eval (n = 256) and train (n = 32)
# variants, at each count csrc/lstm_fwd.cu instantiates
ROW_SWEEPS = {"FTT_EVAL_CELL_ROWS": (2, 4, 8, 16),
              "FTT_EVAL_MEM_ROWS": (1, 2, 4, 8),
              "FTT_TRAIN_CELL_ROWS": (2, 4, 8),
              "FTT_TRAIN_MEM_ROWS": (1, 2),
              "FTT_MULTI_ROWS": (1, 2, 4),
              "FTT_DECODER_FWD_ROWS": (1, 2, 4, 8),
              "FTT_MULTI_EVAL_ROWS": (1, 2, 4, 8, 16),
              "FTT_MULTI_TRAIN_ROWS": (1, 2, 4, 8, 16)}
# what each stamped phase of a step ends with, per kernel
# (a cluster's chains: "dh product" includes the partials' exchange, the
# memory chains' products the gather of the peers' columns)
_CELL_BWD = ("gate math, barrier", "dh product (thread 0)",
             "operand wait, barrier")
PHASE_NAMES = {
    "multi_lstm_bwd": _CELL_BWD,
    "decoder_lstm_bwd": _CELL_BWD,
    "mem_chain_bwd": ("elementwise, barrier", "du3 product, barrier",
                      "carry product, operand wait, barrier"),
    "cell_chains_bwd": _CELL_BWD,
    "cell_chains_fwd": ("gates product, barrier",
                        "cell update, operand wait, barrier"),
    "mem_chain_fwd": ("u3 product and relu, barrier",
                      "heads and update, operand wait, barrier"),
    "lstm_fwd": ("gates product, barrier",
                 "cell update, operand wait, barrier"),
    "encode_dw": ("chunk load, barrier", "chunk sum, barrier"),
}


def _ms(fn, reps=50):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps=50):
    """Mean device milliseconds of one fn() call: CUDA events around reps
    calls queued behind a kernel that sleeps until all of them are
    enqueued (at least 0.1 s, four times the host's time for reps calls
    as the warm-up calls took it), so the card runs them back to back.
    For wrappers whose host time per call passes their kernels' device
    time, where ``_ms`` would time the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    torch.cuda.synchronize()
    slept.record()
    # cycles at up to 2 GHz
    torch.cuda._sleep(int(max(200_000_000, 4 * host_ms * reps * 2e6)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if not slept.elapsed_time(start) > enqueue_ms:
        raise RuntimeError(f"the card woke before {reps} calls were "
                           f"enqueued ({enqueue_ms} ms)")
    return start.elapsed_time(end) / reps


def on_device(event):
    """Whether a profiler event (of ``key_averages()``) is a kernel or
    copy on the card. A ``record_function`` range, such as the optimizer's
    ``Optimizer.step#Adam.step``, shows on the card too, as the span from
    its first kernel to its last, host-paced gaps included: its kernels are
    counted already, so it is left out."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def _profiled(fn, reps, annotations=None):
    """fn() reps times under torch.profiler: (wall ms, {kernel name:
    (device ms, launches)}), both summed over the calls; the spans of the
    ``record_function`` ranges on the card into ``annotations`` (a dict),
    where given."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device_time_total sums over calls, in microseconds
    events = prof.key_averages()
    if annotations is not None:
        annotations.update({e.key: e.device_time_total / 1e3 for e in events
                            if getattr(e, "is_user_annotation", False)})
    return wall_ms, {e.key: (e.device_time_total / 1e3, e.count)
                     for e in events if on_device(e)}


def _pass_ms(fn, reps=50, passes=None):
    """The encode's reverse pass: its device time (``_device_ms``) and its
    split between the passes (``cuda_mfn.BWD_PASSES``, or ``passes``) by
    the names of the kernels torch.profiler saw over reps whole calls."""
    total = _device_ms(fn, reps)
    _, kernels = _profiled(fn, reps)
    return {"ms": total, "pass_ms": {
        name: sum(ms for k, (ms, _) in kernels.items()
                  if any(kernel in k for kernel in names)) / reps
        for name, names in (passes or cuda_mfn.BWD_PASSES).items()}}


def _fwd_pass_ms(fn, reps=50):
    """The encode forward's device time and its split between its passes
    (``cuda_mfn.FWD_PASSES``), with the clusters its chains ran on."""
    out = _pass_ms(fn, reps, cuda_mfn.FWD_PASSES)
    out["clusters"] = cuda_mfn.CLUSTERS["mfm_encode_fwd"]
    return out


def _planned_ms(fn, reps=50):
    """``_device_ms`` of the weight-gradient kernel, with the plan its
    calls took (``cuda_mfn.DW_PLAN``: cluster size and copy bytes)."""
    return {"ms": _device_ms(fn, reps), **cuda_mfn.DW_PLAN}


def _sweep(name, module, knobs, n, call, timer=_ms, **tags):
    """Time ``call`` for every combination of ``knobs`` ({attribute:
    values}) set on ``module``; a combination the card refuses (its
    shared memory does not fit) is reported as refused. ``timer`` is
    ``_ms`` (CUDA events), ``_device_ms``, ``_pass_ms`` or
    ``_planned_ms``."""
    default = {k: getattr(module, k) for k in knobs}
    try:
        for combo in itertools.product(*knobs.values()):
            setting = dict(zip(knobs, combo))
            for k, v in setting.items():
                setattr(module, k, v)
            line = {"tile": name, **tags, "n": n,
                    **{k.lower(): v for k, v in setting.items()},
                    "default": setting == default,
                    "timer": timer.__name__.strip("_")}
            try:
                got = timer(call)
                line.update(got if isinstance(got, dict) else {"ms": got})
            except ValueError as e:
                line["refused"] = str(e)
            print(json.dumps(line), flush=True)
    finally:
        for k, v in default.items():
            setattr(module, k, v)


def sweep(cfg, params, dev):
    x = torch.randn((cfg.seqlength, N, cfg.d_total),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        mfm.kernel_operands(params, x, cfg)
    t = cfg.seqlength
    # block sizes up to the launchers' limit of 512 threads; the forward's
    # call split into its passes by torch.profiler (its chains' rows:
    # part rows)
    def fwd():
        return cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)

    _sweep("mfm_encode_fwd", cuda_mfn, {"THREADS": (128, 256, 512)}, N, fwd,
           _fwd_pass_ms)
    # the decoder forward's rows and threads are fixed in csrc/lstm_fwd.cu
    # (part rows sweeps the rows)
    _sweep("decoder_lstm_fwd", cuda_lstm, {}, N,
           lambda: cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims),
           _device_ms)


def train_sweep(cfg, params, dev):
    """The training kernels at n = 32."""
    n, t = N_TRAIN, cfg.seqlength
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        mfm.kernel_operands(params, x, cfg)
    masks = cuda_mfn.make_dropout_masks(g, t, n, cuda_mfn.sizes(weights)[:4],
                                        mfn_drops(cfg))
    res = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)[2:]
    dh = torch.randn((n, sum(h_dims)), generator=g, device=dev)
    dmem = torch.randn((n, weights["a2w2"].shape[1]), generator=g,
                       device=dev)
    allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t)
    dallh = torch.randn(allh.shape, generator=g, device=dev)
    def fwd():
        return cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)

    _sweep("mfm_encode_fwd_train", cuda_mfn, {"THREADS": (128, 256, 512)}, n,
           fwd, _fwd_pass_ms)

    # the two backward kernels' threads (the rows their blocks take are
    # fixed in their sources, from this sweep's earlier runs: PERF.md); the
    # encode's reverse pass split into its passes by torch.profiler. Device
    # time, as a call of these wrappers is host-bound
    _sweep("mfm_encode_bwd", cuda_mfn, {"BWD_THREADS": (128, 256, 512)}, n,
           lambda: cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                        h_dims), _pass_ms)
    _sweep("decoder_lstm_bwd", cuda_lstm, {"BWD_THREADS": (128, 256, 512)},
           n, lambda: cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                                 dec_dims), _device_ms)
    # the weight-gradient kernel's blocks a launch aims for, which set the
    # cluster size S that splits its rows (1, 2, 4 and 8 at these widths)
    _, deltas = cuda_mfn.mfm_encode_bwd_steps_plain(xp, weights, *res, dh,
                                                    dmem, z_tot)
    _sweep("mfm_encode_dw", cuda_mfn, {"DW_BLOCKS": (1, 132, 264, 528)}, n,
           lambda: cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                       deltas, z_tot), _planned_ms)


def multi_sweep(cfg, dev):
    """The fused encoder-cell kernels at both models' widths: the eval
    forward at n = 256, the train forward and the backward at n = 32."""
    t = cfg.seqlength
    for model_type in ("kl_ef", "missing"):
        params = mfm.MFM(cfg, seed=0, device=dev, model_type=model_type).tree()
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((t, N, cfg.d_total), generator=g, device=dev)
        xp, wh, h_dims = mfm.multi_lstm_operands(params, x, cfg, model_type)
        # the forward's rows and threads are fixed in csrc/lstm_fwd.cu
        # (part rows sweeps the rows)
        _sweep("multi_lstm_fwd", cuda_lstm, {}, N,
               lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims), _device_ms,
               model_type=model_type)
        xp = xp[:, :N_TRAIN].contiguous()
        _, _, allc, gates = cuda_lstm.multi_lstm_plain(xp, wh, with_res=True)
        dh = torch.randn((N_TRAIN, sum(h_dims)), generator=g, device=dev)
        _sweep("multi_lstm_fwd_train", cuda_lstm, {}, N_TRAIN,
               lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims,
                                                with_res=True), _device_ms,
               model_type=model_type)
        # device time: a call of this wrapper is host-bound
        _sweep("multi_lstm_bwd", cuda_lstm,
               {"MULTI_BWD_THREADS": (128, 256, 512)}, N_TRAIN,
               lambda: cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims),
               _device_ms, model_type=model_type)


def row_builds():
    """Part ``rows``: one process a build, each built with one value of
    every ``ROW_SWEEPS`` macro at once (each macro sizes a different
    kernel, read apart by its pass), timing the kernels they size
    (``row_times``)."""
    for k in range(max(map(len, ROW_SWEEPS.values()))):
        defines = [f"{m}={v[k]}" for m, v in ROW_SWEEPS.items()
                   if k < len(v)]
        subprocess.run([sys.executable, "-m", "factorized_tpu_torch.perf_probe",
                        "row_times", *defines], check=True)


def row_times(cfg, dev, rows):
    """The kernels whose rows ``ROW_SWEEPS`` sets, in a build with the
    macros ``rows`` ({macro: value}): the encode forward eval (n = 256)
    and train (n = 32) split into its passes, and by device time the
    decoder forward (n = 32 and 256), ``multi_lstm_fwd`` eval (n = 256)
    and train (n = 32) and ``multi_lstm_bwd`` (n = 32) at ``kl_ef``'s and
    ``missing``'s widths."""
    t = cfg.seqlength
    params = mfm.MFM(cfg, seed=0, device=dev).tree()
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((t, N, cfg.d_total), generator=g, device=dev)
    (xp, weights, z_tot, h_dims), dec = mfm.kernel_operands(params, x, cfg)
    x32 = x[:, :N_TRAIN].contiguous()
    (xt, _, _, _), dec32 = mfm.kernel_operands(params, x32, cfg)
    for n, (h0, c0, wsum, b, dec_dims) in ((N_TRAIN, dec32), (N, dec)):
        _sweep("decoder_lstm_fwd", cuda_lstm, {}, n,
               lambda: cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t,
                                                  dec_dims),
               _device_ms, rows=rows)
    masks = cuda_mfn.make_dropout_masks(g, t, N_TRAIN,
                                        cuda_mfn.sizes(weights)[:4],
                                        mfn_drops(cfg))
    _sweep("mfm_encode_fwd", cuda_mfn, {}, N,
           lambda: cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
           _fwd_pass_ms, rows=rows)
    _sweep("mfm_encode_fwd_train", cuda_mfn, {}, N_TRAIN,
           lambda: cuda_mfn.mfm_encode_res(xt, masks, weights, z_tot,
                                           h_dims), _fwd_pass_ms, rows=rows)
    for model_type in ("kl_ef", "missing"):
        mparams = mfm.MFM(cfg, seed=0, device=dev,
                          model_type=model_type).tree()
        exp, wh, m_dims = mfm.multi_lstm_operands(mparams, x, cfg,
                                                  model_type)
        _sweep("multi_lstm_fwd", cuda_lstm, {}, N,
               lambda: cuda_lstm.multi_lstm_fwd(exp, wh, m_dims),
               _device_ms, model_type=model_type, rows=rows)
        mxp, wh, m_dims = mfm.multi_lstm_operands(mparams, x32, cfg,
                                                  model_type)
        _sweep("multi_lstm_fwd_train", cuda_lstm, {}, N_TRAIN,
               lambda: cuda_lstm.multi_lstm_fwd(mxp, wh, m_dims,
                                                with_res=True),
               _device_ms, model_type=model_type, rows=rows)
        _, _, allc, gates = cuda_lstm.multi_lstm_plain(mxp, wh, with_res=True)
        dh = torch.randn((N_TRAIN, sum(m_dims)), generator=g, device=dev)
        _sweep("multi_lstm_bwd", cuda_lstm, {}, N_TRAIN,
               lambda: cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, m_dims),
               _device_ms, model_type=model_type, rows=rows)


def kernel_times(cfg, params, dev):
    """Each kernel at its default knobs and the main path's shapes, by
    CUDA events over back-to-back calls and by device time: one JSON line.
    It calls only what every build of the port has, so that a run of this
    module against an earlier build of the package compares the two (run
    them in turns in one call on one card)."""
    t = cfg.seqlength
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((t, N, cfg.d_total), generator=g, device=dev)
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        mfm.kernel_operands(params, x, cfg)
    x32 = x[:, :N_TRAIN].contiguous()
    (xt, _, _, _), (h0t, c0t, _, _, _) = mfm.kernel_operands(params, x32,
                                                             cfg)
    masks = cuda_mfn.make_dropout_masks(g, t, N_TRAIN,
                                        cuda_mfn.sizes(weights)[:4],
                                        mfn_drops(cfg))
    res = cuda_mfn.mfm_encode_res_plain(xt, masks, weights, z_tot)[2:]
    _, deltas = cuda_mfn.mfm_encode_bwd_steps_plain(
        xt, weights, *res, torch.ones_like(res[0][0]),
        torch.ones_like(res[2][0]), z_tot)
    dw_ops = cuda_mfn.dw_operands(res[1], res[2], res[3], weights, z_tot)
    allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0t, c0t, wsum, b, t)
    kl = mfm.MFM(cfg, seed=0, device=dev, model_type="kl_ef").tree()
    kxp, kwh, k_dims = mfm.multi_lstm_operands(kl, x32, cfg, "kl_ef")
    _, _, kallc, kgates = cuda_lstm.multi_lstm_plain(kxp, kwh, with_res=True)
    kdh = torch.ones((N_TRAIN, sum(k_dims)), device=dev)
    kxp256, _, _ = mfm.multi_lstm_operands(kl, x, cfg, "kl_ef")
    # kl_ef's serving forward runs the early-fusion cell alone
    ef = {k: v.detach() for k, v in kl["ef_encoder"]["lstm"].items()}
    exp256 = hoist_xproj(ef, x).contiguous()
    mi = mfm.MFM(cfg, seed=0, device=dev, model_type="missing").tree()
    mxp, mwh, m_dims = mfm.multi_lstm_operands(mi, x32, cfg, "missing")
    calls = {
        "mfm_encode_fwd": lambda: cuda_mfn.mfm_encode(xp, weights, z_tot,
                                                      h_dims),
        "mfm_encode_fwd_train": lambda: cuda_mfn.mfm_encode_res(
            xt, masks, weights, z_tot, h_dims),
        "mfm_encode_bwd": lambda: cuda_mfn._launch_bwd(
            xt, weights, *res, torch.ones_like(res[0][0]),
            torch.ones_like(res[2][0]), z_tot, h_dims),
        "mfm_encode_dw": lambda: cuda_mfn._launch_dw(
            weights, res[1], res[2], res[3], deltas, z_tot),
        "decoder_lstm_fwd": lambda: cuda_lstm.decoder_lstm_fwd(
            h0, c0, wsum, b, t, dec_dims),
        "decoder_lstm_fwd_n32": lambda: cuda_lstm.decoder_lstm_fwd(
            h0t, c0t, wsum, b, t, dec_dims),
        "multi_lstm_fwd": lambda: cuda_lstm.multi_lstm_fwd(
            kxp256, kwh, k_dims),
        "multi_lstm_fwd_serve": lambda: cuda_lstm.multi_lstm_fwd(
            exp256, ef["wh"], [ef["wh"].shape[0]]),
        "multi_lstm_fwd_n32": lambda: cuda_lstm.multi_lstm_fwd(
            kxp, kwh, k_dims),
        "multi_lstm_fwd_train": lambda: cuda_lstm.multi_lstm_fwd(
            kxp, kwh, k_dims, with_res=True),
        "multi_lstm_fwd_train_missing": lambda: cuda_lstm.multi_lstm_fwd(
            mxp, mwh, m_dims, with_res=True),
        "decoder_lstm_bwd": lambda: cuda_lstm.decoder_lstm_bwd(
            wsum, gates, allc, allh, dec_dims),
        "multi_lstm_bwd": lambda: cuda_lstm.multi_lstm_bwd(
            kgates, kwh, kallc, kdh, k_dims),
    }
    times = {k: {"events_ms": _ms(f), "device_ms": _device_ms(f)}
             for k, f in calls.items()}
    # the weight-gradient kernel's yardstick, used nowhere in the port: the
    # 7 products by cuBLAS and the 7 column sums, on operands built
    # beforehand. Its calls stall the host while the card sleeps, so its
    # device ms is torch.profiler's sum over its kernels
    lib = functools.partial(dw_library, dw_ops, deltas, weights)
    lib()
    _, kernels = _profiled(lib, 50)
    times["mfm_encode_dw_library"] = {
        "events_ms": _ms(lib),
        "device_ms": sum(ms for ms, _ in kernels.values()) / 50}
    print(json.dumps({
        "kernel_times": times,
        "package": str(Path(cuda_mfn.__file__).parents[1])}), flush=True)


def dw_library(operands, deltas, weights):
    """The weight-gradient kernel's function in one library call a
    product: ``torch.mm`` (cuBLAS) for each of the 7 weights and
    ``sum(0)`` for each of the 7 biases, on ``cuda_mfn.dw_operands``'
    matrices, which the caller builds beforehand (not timed)."""
    offs, _ = cuda_mfn.delta_layout(weights)
    D = deltas.reshape(-1, deltas.shape[-1])
    out = {}
    for name, (a, d) in cuda_mfn.DW_PRODUCTS.items():
        o, w = offs[d]
        out[name] = (D[:, o:o + w].sum(0) if a == "ones"
                     else torch.mm(operands[a].T, D[:, o:o + w]))
    return out


def step_times(cfg, dev):
    """Each model's train step at batch 32 (CUDA events over 30 steps;
    device ms, launches and the device's idle share under torch.profiler
    over 10) and its epoch of 19 batches with the eval (host clock, median
    of 3), eager; where the build has the chunked loop (``train.Graphed``)
    the same replayed: a step as one graph's replay (CUDA events over 30),
    an epoch as one ``ChunkedLoop.run(1)`` (median of 3), the device's
    idle share over 3 replayed epochs, and the epoch graph's capture ms
    and pool bytes; and the padded 256-row predict of ``mfm`` (median of
    20, host clock) before and after the steps: one JSON line. Like
    ``kernel_times`` it calls only what every build of the port has, or
    writes null, for the A/B."""
    from factorized_tpu_torch import train
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.train import TrainProgram, make_optimizer

    t, n = cfg.seqlength, N_TRAIN
    predictor = Predictor(cfg, mfm.MFM(cfg, seed=0, device=dev).tree(),
                          batch_size=N)
    X = np.random.default_rng(0).normal(
        size=(N, t, cfg.d_total)).astype(np.float32)

    def predict_ms():
        return predictor.probe(X, reps=20)["median_s"] * 1e3

    before = predict_ms()
    data = mosi.get_data(t)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Xb = on_card(data[0][:19 * n].reshape(19, n, t, -1)
                 .transpose(0, 2, 1, 3))
    yb = on_card(data[1][:19 * n].reshape(19, n))
    Xv = on_card(data[2].transpose(1, 0, 2).astype(np.float32))
    yv = on_card(data[3].astype(np.float32))
    x, y = Xb[0], yb[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    programs = {
        "mfm": TrainProgram(mfm.mfm_apply, cfg),
        "kl_ef": TrainProgram(mfm.mfm_kl_ef_apply,
                              cfg.replace(model_type="kl_ef"), "beta_vae",
                              stage=1),
        "missing": TrainProgram(mfm.mfm_missing_apply, cfg.replace(missing=1),
                                "missing"),
    }
    out = {}
    for model_type in ABLATIONS:
        try:
            apply_fn = get_model(model_type)[1]
        except NotImplementedError:  # a build without the ablations
            out[model_type] = None
            continue
        programs[model_type] = TrainProgram(
            apply_fn, cfg.replace(model_type=model_type))
    for model_type, program in programs.items():
        tree = mfm.MFM(cfg, seed=0, device=dev, model_type=model_type).tree()
        opt = make_optimizer(tree, 1e-3)
        # an earlier build's step takes the lr every call
        lr = () if hasattr(opt, "set_lr") else (1e-3,)

        def step():
            program.step(tree, opt, x, y, gen, *lr)

        def epoch():
            program.run_epoch(tree, opt, Xb, yb, gen, 1e-3)
            program.evaluate(tree, Xv, yv, gen)

        step_ms = _ms(step, 30)
        spans = {}
        wall_ms, kernels = _profiled(step, 10, spans)
        device_ms = sum(ms for ms, _ in kernels.values())
        out[model_type] = {
            "step_ms": step_ms, "device_ms_per_step": device_ms / 10,
            "launches_per_step": sum(c for _, c in kernels.values()) / 10,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "annotation_span_ms_per_step": {k: v / 10
                                            for k, v in spans.items()},
            "epoch_s": _epoch_s(epoch), "replayed": None}
        if hasattr(train, "Graphed"):
            out[model_type]["replayed"] = _replayed_times(
                program, tree, opt, Xb, yb, Xv, yv, gen, step)
    print(json.dumps({
        "step_times": out, "predict_ms": before,
        "predict_ms_after_steps": predict_ms(),
        "package": str(Path(cuda_mfn.__file__).parents[1])}), flush=True)


# the models the JAX package's Predictor serves that the port has, and
# the launch counters of the kernels a predict may run
SERVED = ("mfm", "kl", "kl_ef", "missing", *ABLATIONS)
PREDICT_COUNTERS = {"mfm_encode_fwd": (cuda_mfn, "LAUNCHES"),
                    "decoder_lstm_fwd": (cuda_lstm, "LAUNCHES"),
                    "multi_lstm_fwd": (cuda_lstm, "MULTI_LAUNCHES")}


def predict_times(cfg, dev):
    """The padded 256-row predict of each model of ``SERVED`` (random
    weights from seed 0; ``missing`` from its ``--missing 1`` config):
    median host ms of ``Predictor.probe`` over 20 calls, the launches of
    one predict by kernel, and, where the build has them,
    ``device_latency`` (100 queued replays) and the graph's capture ms and
    pool bytes; a model the build does not serve is null. One JSON line.
    It calls only what every build of the port has, for the A/B."""
    X = np.random.default_rng(0).normal(
        size=(N, cfg.seqlength, cfg.d_total)).astype(np.float32)
    out = {}
    for model_type in SERVED:
        mcfg = (cfg.replace(missing=1) if model_type == "missing"
                else cfg.replace(model_type=model_type))
        try:
            params = mfm.MFM(mcfg, seed=0, device=dev,
                             model_type=model_type).tree()
            predictor = Predictor(mcfg, params, model_type=model_type,
                                  batch_size=N)
        except NotImplementedError:
            out[model_type] = None
            continue
        predict_ms = predictor.probe(X, reps=20)["median_s"] * 1e3
        before = {k: getattr(m, a) for k, (m, a) in PREDICT_COUNTERS.items()}
        predictor.predict(X)
        launches = {k: getattr(m, a) - before[k]
                    for k, (m, a) in PREDICT_COUNTERS.items()}
        out[model_type] = {
            "predict_ms": predict_ms, "launches_per_predict": launches,
            "device_latency": (predictor.device_latency(X)
                               if hasattr(predictor, "device_latency")
                               else None),
            "graph": (predictor.graph_stats().get(N)
                      if hasattr(predictor, "graph_stats") else None)}
        del predictor
    print(json.dumps({
        "predict_times": out,
        "package": str(Path(cuda_mfn.__file__).parents[1])}), flush=True)


def _epoch_s(fn, reps=3):
    """Median host seconds of fn(), each call ended by a sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _replayed_times(program, tree, opt, Xb, yb, Xv, yv, gen, step):
    """The graph loop's times (see ``step_times``)."""
    from factorized_tpu_torch.train import ChunkedLoop, Graphed
    from factorized_tpu_torch.utils.checkpoint import BestKeeper
    from factorized_tpu_torch.utils.scheduler import ReduceLROnPlateau

    graph_step = Graphed(step, (gen,))
    step_ms = _ms(graph_step, 30)
    loop = ChunkedLoop(program, tree, opt, Xb, yb, None, Xv, yv, gen,
                       epochs=1)
    loop.load(ReduceLROnPlateau(1e-3), BestKeeper("min"))
    for _ in range(2):  # the eager warm-up; the capture and its replay
        loop.run(1)
    epoch_s = _epoch_s(lambda: loop.run(1))
    wall_ms, kernels = _profiled(lambda: loop.run(1), 3)
    device_ms = sum(ms for ms, _ in kernels.values()) / 3
    # the profiler slows a replay: the share against the unprofiled wall
    return {"step_ms": step_ms, "epoch_s": epoch_s,
            "device_ms_per_epoch": device_ms,
            "device_idle_share": 1.0 - device_ms / (epoch_s * 1e3),
            "device_idle_share_profiled_wall": 1.0 - 3 * device_ms / wall_ms,
            "capture_ms": loop.epoch.capture_ms,
            "graph_pool_bytes": loop.epoch.pool_bytes}


# the card's float32 peak and memory rate, for the lane kernels' bounds
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def _bound(flops, nbytes):
    ops_ms, bytes_ms = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _plan_of(kernel):
    """The plan the last call of ``kernel`` took (rows, wave and waves of
    each chain; the weight gradients' cluster and copy width), or None
    where the build records none."""
    if kernel == "mfm_encode_dw":
        return dict(cuda_mfn.DW_PLAN)
    keep = ("rows", "wave", "waves")
    if kernel in ("decoder_lstm_bwd", "multi_lstm_bwd"):
        plan = getattr(cuda_lstm, "BWD_PLAN", {}).get(kernel)
        return plan and {k: plan.get(k) for k in keep}
    if kernel in ("decoder_lstm_fwd", "multi_lstm_fwd"):
        plan = getattr(cuda_lstm, "FWD_PLAN", {}).get(kernel)
        return plan and {k: plan.get(k) for k in keep}
    plans = getattr(cuda_mfn, "FWD_PLAN" if kernel.startswith(
        "mfm_encode_fwd") else "BWD_PLAN", {})
    return {c: {k: p.get(k) for k in keep}
            for c, p in plans.items()} or None


def _split_ms(fn, reps=10):
    """Device ms a call of each kernel that ``fn`` launches, by the name
    torch.profiler gives it (its template arguments kept)."""
    _, kernels = _profiled(fn, reps)
    return {k: ms / reps for k, (ms, _) in kernels.items()}


def _diag_bytes(h_dims):
    """Bytes of a packed recurrent weight's diagonal blocks (float32, four
    gates): the only part the kernels read."""
    return 16 * sum(h * h for h in h_dims)


def _chain_bwd_bound(K, t, n, h_dims, tensors):
    """A chain backward's bound over K lanes: the dh products on the
    diagonal blocks over t - 1 steps against ``tensors`` (its inputs and
    outputs) and the diagonal blocks, once each."""
    return _bound(2 * K * (t - 1) * n * 4 * sum(h * h for h in h_dims),
                  _nbytes(*tensors) + K * _diag_bytes(h_dims))


def _chain_lanes(cfg, dev, K, t, n, g):
    """The chain backward's operands over K lanes, lane k a model of seed
    k: {call: (fn, counter, bound)} for the decoders at n rows and the
    encoder cells of ``m_b`` and ``kl_ef`` (their forward's residuals from
    the plain lane versions)."""
    from factorized_tpu_torch.models import ablations

    x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
    dec = [mfm.kernel_operands(mfm.MFM(cfg, seed=k, device=dev).tree(), x,
                               cfg)[1] for k in range(K)]
    h0, c0, wsum, b = (torch.stack([d[i] for d in dec]) for i in range(4))
    dec_dims = dec[0][4]
    allh, allc, gates = cuda_lstm.decoder_lstm_lanes_plain(h0, c0, wsum, b,
                                                           t)
    dallh = torch.randn(allh.shape, generator=g, device=dev)
    calls = {f"decoder_lstm_bwd.n{n}": (
        lambda: cuda_lstm._launch_bwd(wsum, gates, allc, dallh, dec_dims,
                                      K), "BWD_LAUNCHES",
        _chain_bwd_bound(K, t, n, dec_dims,
                         [gates, allc, dallh, gates[:, 1:], allc[:, 0],
                          allc[:, 0]]))}
    if n != N_TRAIN:
        return calls
    for model_type in ("m_b", "kl_ef"):
        ops = []
        for k in range(K):
            p = mfm.MFM(cfg.replace(model_type=model_type), seed=k,
                        device=dev).tree()
            ops.append(ablations.kernel_operands(p, x, cfg, "m_b")[
                "multi_lstm"] if model_type == "m_b" else
                mfm.multi_lstm_operands(p, x, cfg, model_type))
        xp, wh = torch.stack([o[0] for o in ops]), torch.stack(
            [o[1] for o in ops])
        dims = ops[0][2]
        h_last, _, mallc, mgates = cuda_lstm.multi_lstm_lanes_plain(
            xp, wh, True)
        dhl = torch.randn(h_last.shape, generator=g, device=dev)
        calls[f"multi_lstm_bwd.{model_type}"] = (
            lambda xp=xp, wh=wh, mallc=mallc, mgates=mgates, dhl=dhl,
            dims=dims: cuda_lstm._launch_multi_bwd(mgates, wh, mallc, dhl,
                                                   dims, K),
            "MULTI_BWD_LAUNCHES",
            _chain_bwd_bound(K, t, n, dims, [mgates, mallc, dhl, mgates]))
    return calls


def _cudnn_lstms(cells, t, n, lanes_from=None):
    """The recurrences' yardstick, used nowhere in the port: one
    ``torch.nn.LSTM`` (cuDNN) per cell and lane computing the same steps.
    ``cells``: (weight_hh (4h, h), bias (4h,) or None, x (s, n, 4h) or
    None, (h0, c0) or None) each; the decoders' cells take a zero input of
    width 1 for t - 1 steps from (h0, c0) with ``weight_ih`` zero and the
    bias b, the encoder cells their xp slice for t steps through an
    identity ``weight_ih`` from a zero state. Returns the call: the
    forward of every module."""
    mods = []
    for whh, bias, x, state in cells:
        h = whh.shape[1]
        m = torch.nn.LSTM(1 if x is None else 4 * h, h).to(whh.device)
        with torch.no_grad():
            m.weight_hh_l0.copy_(whh)
            m.bias_hh_l0.zero_()
            if x is None:
                m.weight_ih_l0.zero_()
                m.bias_ih_l0.copy_(bias)
                x = torch.zeros((t - 1, n, 1), device=whh.device)
            else:
                m.weight_ih_l0.copy_(torch.eye(4 * h, device=whh.device))
                m.bias_ih_l0.zero_()
        mods.append((m, x.contiguous(), state))
    return lambda: [m(x, st) for m, x, st in mods]


def _chain_fwd_lanes(cfg, dev, K, t, g):
    """The recurrences' forward over K lanes (``csrc/lstm_fwd.cu``), lane
    k a model of seed k: the decoders at n = 32 and at ``missing``'s 4n =
    128 (their residuals written), ``m_b``'s and ``kl_ef``'s encoder
    cells train (residuals) at n = 32 and eval at n = 256. {call: (fn,
    counter, bound)} and {call: (plain fn, cuDNN fn, (decoder, train,
    dims, n))}; the bound K lanes' useful float32 work (the recurrent
    products on the diagonal blocks, none into the encoder cells' zero
    state at step 0) against the inputs, the outputs and the diagonal
    blocks, once each."""
    from factorized_tpu_torch.models import ablations

    calls, extras = {}, {}
    for n in (N_TRAIN, 4 * N_TRAIN):
        x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
        dec = [mfm.kernel_operands(mfm.MFM(cfg, seed=k, device=dev).tree(),
                                   x, cfg)[1] for k in range(K)]
        h0, c0, wsum, b = (torch.stack([d[i] for d in dec]) for i in range(4))
        dims = dec[0][4]
        H = sum(dims)
        outs = cuda_lstm._launch(h0, c0, wsum, b, t, dims, K)
        name = f"decoder_lstm_fwd.n{n}"
        calls[name] = (
            lambda h0=h0, c0=c0, wsum=wsum, b=b, dims=dims:
            cuda_lstm._launch(h0, c0, wsum, b, t, dims, K), "LAUNCHES",
            _bound(2 * K * (t - 1) * n * 4 * sum(h * h for h in dims),
                   _nbytes(h0, c0, b, *outs) + K * _diag_bytes(dims)))
        cells, o = [], 0
        for h in dims:
            cols = cuda_lstm.cell_columns(H, o, h, dev)
            cells += [(wsum[k][o:o + h][:, cols].T, b[k].reshape(-1)[cols],
                       None, (h0[k][None, :, o:o + h].contiguous(),
                              c0[k][None, :, o:o + h].contiguous()))
                      for k in range(K)]
            o += h
        extras[name] = (
            lambda h0=h0, c0=c0, wsum=wsum, b=b:
            cuda_lstm.decoder_lstm_lanes_plain(h0, c0, wsum, b, t),
            _cudnn_lstms(cells, t, n), (True, True, dims, n))
    for model_type in ("m_b", "kl_ef"):
        for train, n in ((True, N_TRAIN), (False, N)):
            x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
            ops = []
            for k in range(K):
                p = mfm.MFM(cfg.replace(model_type=model_type), seed=k,
                            device=dev).tree()
                ops.append(ablations.kernel_operands(p, x, cfg, "m_b")[
                    "multi_lstm"] if model_type == "m_b" else
                    mfm.multi_lstm_operands(p, x, cfg, model_type))
            xp, wh = (torch.stack([o[i] for o in ops]) for i in range(2))
            dims = ops[0][2]
            H = sum(dims)
            outs = cuda_lstm._launch_multi(xp, wh, dims, train, K)
            name = f"multi_lstm_fwd.{model_type}" + ("" if train else ".eval")
            calls[name] = (
                lambda xp=xp, wh=wh, dims=dims, train=train:
                cuda_lstm._launch_multi(xp, wh, dims, train, K),
                "MULTI_LAUNCHES",
                _bound(2 * K * (t - 1) * n * 4 * sum(h * h for h in dims),
                       _nbytes(xp, *(outs if train else (outs,)))
                       + K * _diag_bytes(dims)))
            cells, o = [], 0
            for h in dims:
                cols = cuda_lstm.cell_columns(H, o, h, dev)
                cells += [(wh[k][o:o + h][:, cols].T, None,
                           xp[k][..., cols], None) for k in range(K)]
                o += h
            extras[name] = (
                lambda xp=xp, wh=wh, train=train:
                cuda_lstm.multi_lstm_lanes_plain(xp, wh, train),
                _cudnn_lstms(cells, t, n), (False, train, dims, n))
    return calls, extras


@contextlib.contextmanager
def _forced_fwd_rows(R):
    """``cuda_lstm.chain_fwd_plan`` with its rows replaced by R, for
    timing each instantiated count over lanes."""
    real = cuda_lstm.chain_fwd_plan

    def plan(*args, **kw):
        return {**real(*args, **kw), "rows": R}

    cuda_lstm.chain_fwd_plan = plan
    try:
        yield
    finally:
        cuda_lstm.chain_fwd_plan = real


def _fwd_rows_ms(fn, case, K):
    """The forward chain's device ms over K lanes at each instantiated
    count whose chain plan is the one-lane plan's (the counts the lane
    plan chooses among): {rows: device ms}; None where the build has no
    lane plan for it."""
    decoder, train, dims, n = case
    if K < 2 or not hasattr(cuda_lstm, "chain_fwd_plan"):
        return None
    counts = (cuda_lstm.DECODER_FWD_ROW_COUNTS if decoder
              else cuda_lstm.MULTI_FWD_ROW_COUNTS)
    first = cuda_lstm.chain_fwd_plan(dims, n, 1, decoder, train)["plan"]
    out = {}
    for R in counts:
        if cuda_lstm.chain_plan(lambda C: cuda_lstm.fwd_chain_bytes(
                dims, R, cuda_lstm.FWD_THREADS, C)) != first:
            continue
        with _forced_fwd_rows(R):
            out[R] = _device_ms(fn, 20)
    return out


def _encode_fwd_lanes(cfg, dev, K, t, g):
    """The encode forward over K lanes, lane k a model of seed k: the
    train variant (masks, residuals "cat") at n = 32 and the eval variant
    at n = 256, {call: (fn, counter, bound)}; the bound K lanes' useful
    float32 work (no recurrent product into step 0's zero state) against
    the inputs, the weights off the recurrent diagonal, the diagonal
    blocks and the outputs, once each."""
    out = {}
    for train, n in ((True, N_TRAIN), (False, N)):
        x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
        ops = [mfm.kernel_operands(mfm.MFM(cfg, seed=k, device=dev).tree(),
                                   x, cfg)[0] for k in range(K)]
        z_tot, h_dims = ops[0][2], ops[0][3]
        xp = torch.stack([o[0] for o in ops])
        w = {m: torch.stack([o[1][m] for o in ops]) for m in ops[0][1]}
        s1, s2, s3, s4, mem = cuda_mfn.sizes({m: v[0] for m, v in w.items()})
        masks = torch.stack([cuda_mfn.make_dropout_masks(
            g, t, n, (s1, s2, s3, s4), mfn_drops(cfg)) for _ in range(K)]
            ) if train else None
        layout = "cat" if train else None
        outs = cuda_mfn._launch_fwd(xp, masks, w, z_tot, h_dims, layout, K)
        H = sum(h_dims)
        m2 = 2 * (H - z_tot)
        recur = 4 * sum(h * h for h in h_dims)
        macs = (recur + m2 * s1 + s1 * m2 + m2 * s2 + s2 * mem
                + (m2 + mem) * (s3 + s4) + (s3 + s4) * mem)
        off = [v for k, v in w.items() if k != "wh"]
        bound = _bound(2 * K * (t * n * macs - n * recur),
                       _nbytes(xp, *([masks] if train else []), *off, *outs)
                       + K * _diag_bytes(h_dims))
        out["mfm_encode_fwd" + ("" if train else ".eval")] = (
            lambda xp=xp, masks=masks, w=w, layout=layout: cuda_mfn._launch_fwd(
                xp, masks, w, z_tot, h_dims, layout, K), "LAUNCHES", bound)
    return out


def lane_kernel_times(cfg, dev, K):
    """The lane kernels over K lanes, lane k a model of seed k: the
    encode's reverse pass (``_launch_bwd``) and weight gradients
    (``_launch_dw``) at n = 32; the encode forward, train at n = 32 and
    eval at n = 256; the decoders' chain backward at n = 32 and 4n = 128
    and the encoder cells' (``m_b``'s and ``kl_ef``'s) at n = 32; the
    decoders' chain forward at n = 32 and 4n = 128 and the encoder cells'
    (``m_b``'s and ``kl_ef``'s) train at n = 32 and eval at n = 256, each
    beside its plain version, the cuDNN yardstick (``_cudnn_lstms``) and,
    over lanes, its device ms at each instantiated count
    (``rows_device_ms``): {call: numbers} (see the module's doc). The bound counts K lanes' useful
    float32 work (the recurrent products on the diagonal blocks, none into
    step 0's zero state) at 67 TFLOP/s against each input read once and
    each output written once at 3.35 TB/s."""
    t, n = cfg.seqlength, N_TRAIN
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
    ops = [mfm.kernel_operands(mfm.MFM(cfg, seed=k, device=dev).tree(), x,
                               cfg)[0] for k in range(K)]
    z_tot, h_dims = ops[0][2], ops[0][3]
    xp = torch.stack([o[0] for o in ops])
    w = {m: torch.stack([o[1][m] for o in ops]) for m in ops[0][1]}
    w0 = {m: v[0] for m, v in w.items()}
    s1, s2, s3, s4, mem = cuda_mfn.sizes(w0)
    masks = torch.stack([cuda_mfn.make_dropout_masks(
        g, t, n, (s1, s2, s3, s4), mfn_drops(cfg)) for _ in range(K)])
    res = [r.contiguous() for r in cuda_mfn.mfm_encode_res_lanes_plain(
        xp, masks, w, z_tot)[2:]]
    dh = torch.randn((K, n, sum(h_dims)), generator=g, device=dev)
    dmem = torch.randn((K, n, mem), generator=g, device=dev)
    dxp, deltas = cuda_mfn._launch_bwd(xp, w, *res, dh, dmem, z_tot, h_dims,
                                       lanes=K)
    dw = cuda_mfn._launch_dw(w, res[1], res[2], res[3], deltas, z_tot, K)
    rows, H = t * n, sum(h_dims)
    m2 = 2 * (H - z_tot)
    recur = 4 * sum(h * h for h in h_dims)
    used = ("wh", "a1w1", "a1w2", "a1b2", "a2w1", "a2w2", "gw1", "g1w2",
            "g2w2")
    bounds = {
        "mfm_encode_bwd": _bound(
            2 * K * ((t - 1) * n * 2 * recur
                     + rows * ((s3 + s4) * mem + s2 * mem
                               + (m2 + mem) * (s3 + s4) + m2 * s2
                               + 2 * s1 * m2)),
            _nbytes(xp, *res, dh, dmem, *[w[k] for k in used], dxp, deltas)
            + K * 16 * sum(h * h for h in h_dims)),
        "mfm_encode_dw": _bound(
            2 * rows * sum(v.numel() for v in dw.values()),
            _nbytes(res[1], res[2], res[3], deltas, *dw.values()))}
    # the library's weight gradients: 7 torch.bmm and 7 sums over the
    # lanes' operands, built before the timing
    A = [cuda_mfn.dw_operands(res[1][k], res[2][k], res[3][k],
                              {m: v[k] for m, v in w.items()}, z_tot)
         for k in range(K)]
    A = {a: torch.stack([o[a] for o in A]) for a in A[0]}
    offs, _ = cuda_mfn.delta_layout(w0)
    D = deltas.reshape(K, rows, -1)

    def library():
        return {name: (D[:, :, o:o + wd].sum(1) if a == "ones" else
                       torch.bmm(A[a].transpose(1, 2), D[:, :, o:o + wd]))
                for name, (a, d) in cuda_mfn.DW_PRODUCTS.items()
                for o, wd in [offs[d]]}

    calls = {"mfm_encode_bwd": (lambda: cuda_mfn._launch_bwd(
        xp, w, *res, dh, dmem, z_tot, h_dims, lanes=K), "BWD_LAUNCHES",
        bounds["mfm_encode_bwd"]),
             "mfm_encode_dw": (lambda: cuda_mfn._launch_dw(
                 w, res[1], res[2], res[3], deltas, z_tot, K),
                 "DW_LAUNCHES", bounds["mfm_encode_dw"])}
    calls.update(_encode_fwd_lanes(cfg, dev, K, t, g))
    for rows in (n, 4 * n):
        calls.update(_chain_lanes(cfg, dev, K, t, rows, g))
    fwd_calls, extras = _chain_fwd_lanes(cfg, dev, K, t, g)
    calls.update(fwd_calls)
    out = {}
    for name, (fn, counter, bound) in calls.items():
        kernel = name.split(".")[0]
        module = cuda_mfn if kernel.startswith("mfm") else cuda_lstm
        before = getattr(module, counter)
        fn()
        launches = getattr(module, counter) - before
        # as many launches queued behind the sleeping kernel as at 8 lanes
        # (a parent's launch of 8-lane groups holds up to 32 KB of
        # arguments)
        out[name] = {"lanes": K, "launches_per_call": launches,
                     "plan": _plan_of(kernel),
                     "device_ms": _device_ms(fn, 20 // launches),
                     "ms": _ms(fn, 20), "bound_ms": bound[0],
                     "bound_by": bound[1]}
        if kernel == "mfm_encode_fwd":  # its passes' kernels apart
            out[name]["split_ms"] = _split_ms(fn)
    out["mfm_encode_dw"]["library_device_ms"] = _device_ms(library, 20)
    out["mfm_encode_dw"]["library_ms"] = _ms(library, 20)
    for name, (plain, cudnn, case) in extras.items():
        out[name].update({
            "plain_ms": _ms(plain, 2), "library_ms": _ms(cudnn, 5),
            "rows_device_ms": _fwd_rows_ms(calls[name][0], case, K)})
    return out


def mfn_kernel_times(dev, n=128):
    """The encode's reverse pass and weight gradients of one model, no
    lane axis, at n rows (the ``best_mfn_mosi_config`` runs' batch) for
    both ``best_mfn_mosi_config``s: {kind: {kernel: {"device_ms",
    "plan"}}}."""
    from factorized_tpu_torch.config import best_mfn_mosi_config
    from factorized_tpu_torch.models.common import split_modalities
    from factorized_tpu_torch.ops.fused import encode_operands

    out = {}
    for kind in ("mae", "acc"):
        cfg = best_mfn_mosi_config(kind)
        t = cfg.seqlength
        g = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
        params = mfm.MFM(cfg, seed=0, device=dev,
                         model_type="mfn").tree()["mfn"]
        xp, w, z_tot, h_dims = encode_operands(
            [], params, *split_modalities(x, cfg.input_dims), ())
        masks = cuda_mfn.make_dropout_masks(
            g, t, n, cuda_mfn.sizes(w)[:4], mfn_drops(cfg))
        res = cuda_mfn.mfm_encode_res_plain(xp, masks, w, z_tot)[2:]
        dh, dmem = torch.ones_like(res[0][0]), torch.ones_like(res[2][0])
        _, deltas = cuda_mfn._launch_bwd(xp, w, *res, dh, dmem, z_tot,
                                         h_dims)

        def bwd():
            return cuda_mfn._launch_bwd(xp, w, *res, dh, dmem, z_tot,
                                        h_dims)

        def dw():
            return cuda_mfn._launch_dw(w, res[1], res[2], res[3], deltas,
                                       z_tot)

        out[kind] = {"mfm_encode_bwd": {"device_ms": _device_ms(bwd, 20)},
                     "mfm_encode_dw": {"device_ms": _device_ms(dw, 20)}}
        out[kind]["mfm_encode_bwd"]["plan"] = {
            c: p["rows"] for c, p in getattr(cuda_mfn, "BWD_PLAN",
                                             {}).items()} or None
        out[kind]["mfm_encode_dw"]["plan"] = dict(cuda_mfn.DW_PLAN)
    return out


def lane_times(cfg, dev, lanes=(1, 8, 16, 32)):
    """Part ``lanes`` (see the module's doc): one JSON line."""
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.parallel import multiseed
    from factorized_tpu_torch.train import LaneAdam

    data = mosi.get_data(cfg.seqlength)
    _, apply_fn = get_model("mfm")
    out, lane_kernels = {}, {}
    for K in lanes:
        with torch.inference_mode():
            lane_kernels[str(K)] = lane_kernel_times(cfg, dev, K)
        prep = multiseed.prepare_bucket_data(*data, cfg, seed=0, device=dev)
        params = multiseed.init_lanes("mfm", cfg, 0, K, dev)
        opt = LaneAdam(params, 1e-3)
        gen = torch.Generator(device=dev).manual_seed(0)
        programs = multiseed.LanePrograms(apply_fn, cfg, gen)
        loop = multiseed.LaneLoop(programs, params, opt, prep["Xb"],
                                  prep["yb"], prep["Xv"], prep["yv"],
                                  epochs=1)
        loop.run(1)  # eager
        loop.run(1)  # the capture and its replay
        Xb, yb = loop.batches

        def step():
            programs.step(params, opt, Xb[0], yb[0])

        step()
        _, kernels = _profiled(step, 3)
        epoch_s = _epoch_s(lambda: loop.run(1))
        _, replayed = _profiled(lambda: loop.run(1), 1)
        out[str(K)] = {
            "device_ms_per_step": sum(ms for ms, _ in kernels.values()) / 3,
            "launches_per_step": sum(c for _, c in kernels.values()) / 3,
            "replayed_epoch_s": epoch_s,
            "device_ms_per_replayed_epoch": sum(
                ms for ms, _ in replayed.values()),
            "capture_ms": loop.epoch.capture_ms,
            "graph_pool_bytes": loop.epoch.pool_bytes}
        del loop, opt, params, programs
    with torch.inference_mode():
        mfn_kernels = mfn_kernel_times(dev)
    print(json.dumps({
        "lane_times": out, "lane_kernels": lane_kernels,
        "mfn_kernels": mfn_kernels,
        "package": str(Path(cuda_mfn.__file__).parents[1])}), flush=True)


def _sm_clock():
    """The SM clock now and its maximum, MHz, by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    now, most = out.splitlines()[0].split(",")
    return float(now), float(most)


def phases(cfg, dev):
    """Part ``phases``: one call of each chain kernel at the main path's
    shapes with the probe's buffer registered, and of the decoders' chain
    backward and the encode forward over lanes; per kernel and cell the
    mean cycles of each phase over the call's steps."""
    import ctypes

    from factorized_tpu_torch.ops import _build

    t = cfg.seqlength
    params = mfm.MFM(cfg, seed=0, device=dev).tree()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((t, N, cfg.d_total), generator=g, device=dev)
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        mfm.kernel_operands(params, x, cfg)
    x32 = x[:, :N_TRAIN].contiguous()
    (xt, _, _, _), (h0t, c0t, _, _, _) = mfm.kernel_operands(params, x32,
                                                             cfg)
    masks = cuda_mfn.make_dropout_masks(g, t, N_TRAIN,
                                        cuda_mfn.sizes(weights)[:4],
                                        mfn_drops(cfg))
    res = cuda_mfn.mfm_encode_res_plain(xt, masks, weights, z_tot)[2:]
    dh = torch.randn((N_TRAIN, sum(h_dims)), generator=g, device=dev)
    dmem = torch.randn((N_TRAIN, weights["a2w2"].shape[1]), generator=g,
                       device=dev)
    allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0t, c0t, wsum, b, t)
    _, deltas = cuda_mfn.mfm_encode_bwd_steps_plain(xt, weights, *res, dh,
                                                    dmem, z_tot)
    calls = {
        "mfm_encode_dw": (lambda: cuda_mfn._launch_dw(
            weights, res[1], res[2], res[3], deltas, z_tot), h_dims,
            N_TRAIN),
        "decoder_lstm_fwd": (lambda: cuda_lstm.decoder_lstm_fwd(
            h0, c0, wsum, b, t, dec_dims), dec_dims, N),
        "decoder_lstm_fwd_n32": (lambda: cuda_lstm.decoder_lstm_fwd(
            h0t, c0t, wsum, b, t, dec_dims), dec_dims, N_TRAIN),
        "mfm_encode_fwd": (lambda: cuda_mfn.mfm_encode(
            xp, weights, z_tot, h_dims), h_dims, N),
        "mfm_encode_fwd_train": (lambda: cuda_mfn.mfm_encode_res(
            xt, masks, weights, z_tot, h_dims), h_dims, N_TRAIN),
        "mfm_encode_bwd": (lambda: cuda_mfn._launch_bwd(
            xt, weights, *res, dh, dmem, z_tot, h_dims), h_dims, N_TRAIN),
        "decoder_lstm_bwd": (lambda: cuda_lstm.decoder_lstm_bwd(
            wsum, gates, allc, allh, dec_dims), dec_dims, N_TRAIN),
    }
    # over lanes (lane 0 stamps, one model's operands in every lane): the
    # decoders' chain backward at K = 2 and 8 and the encode forward at 8,
    # the rows their plans take there
    def lanes(K, *tensors):
        return [a.expand(K, *a.shape) for a in tensors]

    for K in (2, 8):
        calls[f"decoder_lstm_bwd.lanes{K}"] = (
            lambda K=K: cuda_lstm.decoder_lstm_bwd_lanes(
                *lanes(K, wsum, gates, allc, allh), dec_dims), dec_dims,
            N_TRAIN)
    lw = {k: v.expand(8, *v.shape) for k, v in weights.items()}
    calls["mfm_encode_fwd.lanes8"] = (lambda: cuda_mfn.mfm_encode_lanes(
        *lanes(8, xp), lw, z_tot, h_dims), h_dims, N)
    calls["mfm_encode_fwd_train.lanes8"] = (
        lambda: cuda_mfn.mfm_encode_res_lanes(*lanes(8, xt, masks), lw,
                                              z_tot, h_dims), h_dims,
        N_TRAIN)
    # the recurrences' forward over 2 lanes at each instantiated count
    # (lane 0 stamps): the decoders at n = 32, m_b's encoder cells train
    # at n = 32 and eval at 256
    from factorized_tpu_torch.models import ablations

    def at_rows(R, fn):
        def call():
            with _forced_fwd_rows(R):
                return fn()
        return call

    mb = mfm.MFM(cfg.replace(model_type="m_b"), seed=0, device=dev).tree()
    bxt, bwh, b_dims = ablations.kernel_operands(mb, x32, cfg,
                                                 "m_b")["multi_lstm"]
    bxe = ablations.kernel_operands(mb, x, cfg, "m_b")["multi_lstm"][0]
    for R in cuda_lstm.DECODER_FWD_ROW_COUNTS:
        calls[f"decoder_lstm_fwd.lanes2.rows{R}"] = (at_rows(
            R, lambda: cuda_lstm.decoder_lstm_fwd_lanes(
                *lanes(2, h0t, c0t, wsum, b), t, dec_dims)), dec_dims,
            N_TRAIN)
    for R in cuda_lstm.MULTI_FWD_ROW_COUNTS:
        calls[f"multi_lstm_fwd_train.m_b.lanes2.rows{R}"] = (at_rows(
            R, lambda: cuda_lstm.multi_lstm_fwd_lanes(
                *lanes(2, bxt, bwh), b_dims, True)), b_dims, N_TRAIN)
        calls[f"multi_lstm_fwd.m_b.lanes2.rows{R}"] = (at_rows(
            R, lambda: cuda_lstm.multi_lstm_fwd_lanes(
                *lanes(2, bxe, bwh), b_dims)), b_dims, N)
    for model_type in ("kl_ef", "missing"):
        mparams = mfm.MFM(cfg, seed=0, device=dev,
                          model_type=model_type).tree()
        mxp, wh, m_dims = mfm.multi_lstm_operands(mparams, x32, cfg,
                                                  model_type)
        _, _, mallc, mgates = cuda_lstm.multi_lstm_plain(mxp, wh,
                                                         with_res=True)
        mdh = torch.randn((N_TRAIN, sum(m_dims)), generator=g, device=dev)
        calls[f"multi_lstm_bwd.{model_type}"] = (
            lambda mg=mgates, w=wh, mc=mallc, d=mdh, md=m_dims:
            cuda_lstm.multi_lstm_bwd(mg, w, mc, d, md), m_dims, N_TRAIN)
        exp, _, _ = mfm.multi_lstm_operands(mparams, x, cfg, model_type)
        calls[f"multi_lstm_fwd.{model_type}"] = (
            lambda e=exp, w=wh, md=m_dims: cuda_lstm.multi_lstm_fwd(e, w, md),
            m_dims, N)
        calls[f"multi_lstm_fwd_train.{model_type}"] = (
            lambda e=mxp, w=wh, md=m_dims: cuda_lstm.multi_lstm_fwd(
                e, w, md, with_res=True), m_dims, N_TRAIN)

    shape = (len(CLOCK_KERNELS), CLOCK_ROWS, CLOCK_STEPS, CLOCK_PHASES)
    buf = torch.zeros(shape, dtype=torch.int64, device=dev)
    register = _build.kernel("ftt_set_phase_clocks", [ctypes.c_void_p])
    for call, (fn, dims, n) in calls.items():
        fn()  # built, attributes set: the stamped call is a steady one
        torch.cuda.synchronize()
        buf.zero_()
        register(buf.data_ptr())
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            register(None)
        clock_mhz, max_mhz = _sm_clock()
        stamps = buf.cpu().numpy()
        for k, kernel in enumerate(CLOCK_KERNELS):
            for y in range(CLOCK_ROWS):
                rows = stamps[k, y]
                if rows[0, 0] == 0:
                    continue
                prev, per, steps = int(rows[0, 0]), {}, []
                for i in range(1, CLOCK_STEPS):
                    if not rows[i].any():
                        break
                    start = prev
                    for p in range(CLOCK_PHASES):
                        if rows[i, p]:
                            per.setdefault(p, []).append(
                                int(rows[i, p]) - prev)
                            prev = int(rows[i, p])
                    steps.append(prev - start)
                names = PHASE_NAMES.get(kernel, ())
                print(json.dumps({
                    "phases": call, "kernel": kernel, "row": y,
                    "cell": dims[y] if kernel not in (
                        "mem_chain_bwd", "mem_chain_fwd", "encode_dw")
                    else None, "n": n, "steps": len(steps),
                    "mean_cycles": {
                        (names[p] if p < len(names) else str(p)):
                        float(np.mean(v)) for p, v in sorted(per.items())},
                    "mean_cycles_per_step": float(np.mean(steps)),
                    "sm_clock_mhz": clock_mhz, "max_sm_clock_mhz": max_mhz}),
                    flush=True)


def profile(cfg, params):
    predictor = Predictor(cfg, params, batch_size=N)
    X = np.random.default_rng(0).normal(
        size=(N, cfg.seqlength, cfg.d_total)).astype(np.float32)
    for _ in range(3):
        predictor.predict(X)
    reps = 20
    wall_ms, kernels = _profiled(lambda: predictor.predict(X), reps)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda e: -e[1][0])[:8]
    print(json.dumps({
        "profile": "predict", "batch": N, "calls": reps,
        "wall_ms_per_call": wall_ms / reps,
        "device_ms_per_call": device_ms / reps,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches_per_call": sum(c for _, c in kernels.values())
        / reps,
        "top": [{"name": k[:60], "count_per_call": c / reps,
                 "ms_per_call": ms / reps} for k, (ms, c) in top]}),
        flush=True)


# the card's float32 peak without tensor cores, FLOP/s (PERF.md section 6)
F32_PEAK = 67e12
# the chain kernels' launch counters: {name: (module, attribute)}
CHAIN_COUNTERS = {"mfm_encode_fwd": (cuda_mfn, "LAUNCHES"),
                  "mfm_encode_bwd": (cuda_mfn, "BWD_LAUNCHES"),
                  "mfm_encode_dw": (cuda_mfn, "DW_LAUNCHES"),
                  "decoder_lstm_fwd": (cuda_lstm, "LAUNCHES"),
                  "decoder_lstm_bwd": (cuda_lstm, "BWD_LAUNCHES")}


def chain_launches(fn):
    """fn() and the chain kernels' launches it counted, by kernel."""
    before = {k: getattr(m, a) for k, (m, a) in CHAIN_COUNTERS.items()}
    fn()
    return {k: getattr(m, a) - before[k]
            for k, (m, a) in CHAIN_COUNTERS.items()}


def reported_plans(paths):
    """The plans the launchers reported for the kernels of ``paths`` (an
    ``active_paths``), as they record them in ``CLUSTERS``."""
    return {k: (cuda_mfn.CLUSTERS if k.startswith("mfm") else
                cuda_lstm.CLUSTERS).get(k) for k in paths
            if k != "fused_blockdiag"}


def scale_point(name, cfg, fused, dev, smi):
    """One train step of ``mfm`` at ``cfg`` on the path ``fused`` forces
    (see the module's docstring, part ``scale``): a dict."""
    import gc

    from factorized_tpu_torch import benchprog
    from factorized_tpu_torch.train import Graphed
    from factorized_tpu_torch.utils.flops import model_train_flops_per_step

    saved = mfm.FUSED
    mfm.FUSED = fused
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        paths = benchprog.active_paths(cfg)
        program, params, opt = benchprog.build_train_state(cfg, seed=0,
                                                           device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        t, n = cfg.seqlength, cfg.batchsize
        x = torch.randn((t, n, cfg.d_total), generator=gen, device=dev)
        y = torch.randn((n,), generator=gen, device=dev)
        loss = torch.zeros((), device=dev)

        def step():
            loss.copy_(program.step(params, opt, x, y, gen))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cuda_mfn.CLUSTERS.clear()
        cuda_lstm.CLUSTERS.clear()
        launches = chain_launches(step)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        reported = reported_plans(paths)
        graph = Graphed(step, (gen,))
        graph()  # eager, on the graph's stream
        graph()  # the capture and a replay
        reps = 2 if eager_ms > 1000 else 5 if eager_ms > 100 else 20
        try:
            device_ms, timing = _device_ms(graph, reps), "queued"
        except RuntimeError:
            # a graph this large stalls the host while the card sleeps:
            # back-to-back replays, each longer than its launch, keep the
            # card busy
            device_ms, timing = _ms(graph, reps), "events"
        model_flops = model_train_flops_per_step(cfg)
        out = {
            "scale": name, "fused": fused, "nvidia_smi": smi,
            "batch": n, "h_dims": list(cfg.h_dims), "mem": cfg.memsize,
            "mlp": cfg.att1_shape,
            "step_flops_estimate": mfm._step_flops_estimate(cfg),
            "model_flops": model_flops, "step_device_ms": device_ms,
            "timing": timing,
            "f32_peak_share": model_flops / (device_ms * 1e-3) / F32_PEAK,
            "chain_launches_per_step": launches,
            "active_paths": paths, "reported_plans": reported,
            "plans_match": all(reported[k] == v for k, v in paths.items()
                               if k != "fused_blockdiag"),
            "launches_match": all((k > 0) == fused
                                  for k in launches.values()),
            "eager_step_ms": eager_ms, "capture_ms": graph.capture_ms,
            "graph_pool_bytes": graph.pool_bytes,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "loss": float(loss)}
        del graph, program, params, opt
        return out
    finally:
        mfm.FUSED = saved
        gc.collect()
        torch.cuda.empty_cache()


def scale_sweep(dev, smi):
    """Part ``scale``: a line a config and path, then the crossover."""
    from factorized_tpu_torch import benchprog
    from factorized_tpu_torch.ops import _build

    _build.load_library()  # the eager steps' times hold no build
    configs = {"best_acc_mosi_config": best_acc_mosi_config(),
               **benchprog.scale_candidates()}
    points = {}
    for name, cfg in configs.items():
        for fused in (True, False):
            try:
                point = scale_point(name, cfg, fused, dev, smi)
            except Exception as e:  # print every config it ran
                point = {"scale": name, "fused": fused,
                         "error": f"{type(e).__name__}: {e}"}
            points[name, fused] = point
            print(json.dumps(point), flush=True)
    print(json.dumps(crossover(points, configs)), flush=True)


def crossover(points, configs):
    """The ``scale_crossover`` line of ``scale_sweep``'s points
    ({(name, fused): point}): by ``_step_flops_estimate``, the largest
    config whose fused step took fewer device ms than its modular one,
    the smallest whose took more, and the geometric midpoint of the two
    estimates; where one path wins at every config measured, twice the
    largest estimate (fused) or half the smallest (modular)."""
    est = {name: mfm._step_flops_estimate(cfg)
           for name, cfg in configs.items()}
    wins = {name: points[name, True]["step_device_ms"]
            < points[name, False]["step_device_ms"]
            for name in configs
            if "error" not in points[name, True]
            and "error" not in points[name, False]}
    fused_wins = [n for n in wins if wins[n]]
    modular_wins = [n for n in wins if not wins[n]]
    below = max(fused_wins, key=est.get, default=None)
    above = min(modular_wins, key=est.get, default=None)
    if above is None:
        value = 2.0 * max(est[n] for n in wins)
    elif below is None:
        value = est[above] / 2.0
    else:
        value = (est[below] * est[above]) ** 0.5
    return {"scale_crossover": value, "fused_wins_at": fused_wins,
            "modular_wins_at": modular_wins, "largest_fused_win": below,
            "smallest_modular_win": above,
            "ordered": below is None or above is None
            or est[below] < est[above]}


def main(parts=None):
    parts = set(parts or ("serve", "train", "multi", "profile"))
    # row_times (run by part rows) takes the macros of its build
    rows = {}
    if "row_times" in parts:
        for arg in sorted(parts - {"row_times"}):
            macro, _, value = arg.partition("=")
            if macro not in ROW_SWEEPS or not value.isdigit():
                raise SystemExit(f"row_times takes MACRO=ROWS of "
                                 f"{sorted(ROW_SWEEPS)}, not {arg}")
            rows[macro] = int(value)
        parts = {"row_times"}
    if not parts <= {"serve", "train", "multi", "profile", "times",
                     "phases", "rows", "row_times", "scale", "lanes"}:
        raise SystemExit(f"unknown parts {sorted(parts)}")
    for alone in ("phases", "rows"):
        if alone in parts and parts != {alone}:
            raise SystemExit(f"part {alone} runs alone: it builds the "
                             f"kernels with its own macros")
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0]}), flush=True)
    cfg = best_acc_mosi_config()
    if parts == {"rows"}:
        row_builds()
        return
    if parts & {"phases", "row_times"}:
        from factorized_tpu_torch.ops import _build

        for macro, value in rows.items():
            _build.define(macro, value)
        if "phases" in parts:
            _build.define("FTT_PHASE_CLOCKS")
        with torch.inference_mode():
            if "phases" in parts:
                phases(cfg, torch.device("cuda"))
            else:
                row_times(cfg, torch.device("cuda"), rows)
        return
    params = mfm.MFM(cfg, seed=0, device="cuda").tree()
    with torch.inference_mode():
        if "serve" in parts:
            sweep(cfg, params, torch.device("cuda"))
        if "train" in parts:
            train_sweep(cfg, params, torch.device("cuda"))
        if "multi" in parts:
            multi_sweep(cfg, torch.device("cuda"))
        if "times" in parts:
            kernel_times(cfg, params, torch.device("cuda"))
    if "times" in parts:
        predict_times(cfg, torch.device("cuda"))
        step_times(cfg, torch.device("cuda"))
    if "profile" in parts:
        profile(cfg, params)
    if "scale" in parts:
        scale_sweep(torch.device("cuda"), smi.splitlines()[0])
    if "lanes" in parts:
        lane_times(cfg, torch.device("cuda"))


if __name__ == "__main__":
    main(sys.argv[1:])
