"""Measurements of the port on a CUDA card, for PERF.md.

Run from the repository root on the card:
``python -m factorized_tpu_torch.perf_probe [serve] [train] [multi]
[profile] [times]`` (the first four parts when none is named), or
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
  and the padded 256-row predict. Both call only what every build of the
  port has, so this module run against an earlier build's package (that
  build first on ``sys.path``) gives the A/B;
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
  and sum); with the SM clock read just after;
- ``card``: the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

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
from factorized_tpu_torch.models import mfm
from factorized_tpu_torch.models.common import mfn_drops
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
from factorized_tpu_torch.serve import Predictor

N = 256
N_TRAIN = 32
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
# variants
ROW_SWEEPS = {"FTT_EVAL_CELL_ROWS": (2, 4, 8, 16),
              "FTT_EVAL_MEM_ROWS": (1, 2, 4, 8),
              "FTT_TRAIN_CELL_ROWS": (1, 2, 4),
              "FTT_TRAIN_MEM_ROWS": (1, 2),
              "FTT_MULTI_ROWS": (1, 2, 4),
              "FTT_DECODER_FWD_ROWS": (1, 2, 4, 8),
              "FTT_MULTI_EVAL_ROWS": (2, 4, 8, 16),
              "FTT_MULTI_TRAIN_ROWS": (1, 2, 4)}
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
    calls queued behind a kernel that sleeps (about 0.1 s) until all of
    them are enqueued, so the card runs them back to back. For wrappers
    whose host time per call passes their kernels' device time, where
    ``_ms`` would time the host."""
    for _ in range(3):
        fn()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    torch.cuda.synchronize()
    slept.record()
    torch.cuda._sleep(200_000_000)
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
    over 10) and the padded 256-row ``predict`` of ``mfm`` (median of 20,
    host clock) before and after the steps: one JSON line. Like
    ``kernel_times`` it calls only what every build of the port has, for
    the A/B."""
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
    x = torch.from_numpy(np.ascontiguousarray(
        data[0][:n].transpose(1, 0, 2))).to(dev)
    y = torch.from_numpy(data[1][:n]).to(dev)
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
    for model_type, program in programs.items():
        tree = mfm.MFM(cfg, seed=0, device=dev, model_type=model_type).tree()
        opt = make_optimizer(tree, 1e-3)

        def step():
            program.step(tree, opt, x, y, gen, 1e-3)

        step_ms = _ms(step, 30)
        spans = {}
        wall_ms, kernels = _profiled(step, 10, spans)
        device_ms = sum(ms for ms, _ in kernels.values())
        out[model_type] = {
            "step_ms": step_ms, "device_ms_per_step": device_ms / 10,
            "launches_per_step": sum(c for _, c in kernels.values()) / 10,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "annotation_span_ms_per_step": {k: v / 10
                                            for k, v in spans.items()}}
    print(json.dumps({
        "step_times": out, "predict_ms": before,
        "predict_ms_after_steps": predict_ms(),
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
    shapes with the probe's buffer registered; per kernel and cell the
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
                     "phases", "rows", "row_times"}:
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
        step_times(cfg, torch.device("cuda"))
    if "profile" in parts:
        profile(cfg, params)


if __name__ == "__main__":
    main(sys.argv[1:])
