"""Measurements of the port on a CUDA card, for PERF.md.

Run from the repository root on the card:
``python -m factorized_tpu_torch.perf_probe [serve] [train] [multi]
[profile]`` (all four parts when none is named). Prints JSON lines:

- ``tile``: each kernel's mean time (CUDA events, 50 launches after
  warm-up) for each batch-row tile and block size the launchers take, the
  forward kernels at the serving shapes (n = 256, t = 20,
  ``best_acc_mosi_config``) and the training kernels at the training
  shapes (n = 32); part ``multi`` does the same for the fused
  encoder-cell kernels at the widths of ``kl_ef`` and ``missing``. So the
  defaults in ``ops/cuda_mfn.py`` and ``ops/cuda_lstm.py`` are chosen
  from a measurement;
- ``profile``: ``torch.profiler`` over 20 padded 256-row ``predict``
  calls: wall time, the device time summed over kernels, the share of
  the wall in which the device was idle, and the largest kernels;
- ``card``: the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from factorized_tpu_torch.config import best_acc_mosi_config
from factorized_tpu_torch.models import mfm
from factorized_tpu_torch.models.common import mfn_drops
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
from factorized_tpu_torch.serve import Predictor

N = 256
N_TRAIN = 32


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


def _sweep(name, module, rows_attr, threads_attr, rows_list, block_sizes,
           n, call, **tags):
    """Time ``call`` for each (rows, threads) set on ``module``."""
    default = (getattr(module, rows_attr), getattr(module, threads_attr))
    try:
        for rows in rows_list:
            for threads in block_sizes:
                setattr(module, rows_attr, rows)
                setattr(module, threads_attr, threads)
                print(json.dumps({
                    "tile": name, **tags, "n": n, "rows": rows,
                    "threads": threads, "blocks": -(-n // rows),
                    "ms": _ms(call),
                    "default": (rows, threads) == default}), flush=True)
    finally:
        setattr(module, rows_attr, default[0])
        setattr(module, threads_attr, default[1])


def sweep(cfg, params, dev):
    x = torch.randn((cfg.seqlength, N, cfg.d_total),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        mfm.kernel_operands(params, x, cfg)
    t = cfg.seqlength
    # block sizes up to the launchers' limit of 512 threads
    _sweep("mfm_encode_fwd", cuda_mfn, "ROWS", "THREADS", (1, 2, 4, 8, 16),
           (128, 256, 512), N,
           lambda: cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims))
    _sweep("decoder_lstm_fwd", cuda_lstm, "ROWS", "THREADS",
           (1, 2, 4, 8, 16), (64, 128, 160, 256, 512), N,
           lambda: cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims))


def train_sweep(cfg, params, dev):
    """The training kernels at n = 32 (the encode backward's shared memory
    allows at most 8 rows)."""
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
    _sweep("mfm_encode_fwd_train", cuda_mfn, "TRAIN_ROWS", "THREADS",
           (1, 2, 4, 8), (128, 256, 512), n,
           lambda: cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot,
                                           h_dims))
    _sweep("mfm_encode_bwd", cuda_mfn, "BWD_ROWS", "BWD_THREADS",
           (1, 2, 4, 8), (128, 256, 512), n,
           lambda: cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                        h_dims))
    _sweep("decoder_lstm_bwd", cuda_lstm, "BWD_ROWS", "BWD_THREADS",
           (1, 2, 4, 8, 16), (64, 128, 160, 256, 512), n,
           lambda: cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                              dec_dims))


def multi_sweep(cfg, dev):
    """The fused encoder-cell kernels at both models' widths: the eval
    forward at n = 256, the train forward and the backward at n = 32."""
    t = cfg.seqlength
    for model_type in ("kl_ef", "missing"):
        params = mfm.MFM(cfg, seed=0, device=dev, model_type=model_type).tree()
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((t, N, cfg.d_total), generator=g, device=dev)
        xp, wh, h_dims = mfm.multi_lstm_operands(params, x, cfg, model_type)
        _sweep("multi_lstm_fwd", cuda_lstm, "MULTI_ROWS", "MULTI_THREADS",
               (1, 2, 4, 8, 16), (128, 256, 512), N,
               lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims),
               model_type=model_type)
        xp = xp[:, :N_TRAIN].contiguous()
        _, _, allc, gates = cuda_lstm.multi_lstm_plain(xp, wh, with_res=True)
        dh = torch.randn((N_TRAIN, sum(h_dims)), generator=g, device=dev)
        _sweep("multi_lstm_fwd_train", cuda_lstm, "MULTI_ROWS",
               "MULTI_THREADS", (1, 2, 4, 8), (128, 256, 512), N_TRAIN,
               lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims,
                                                with_res=True),
               model_type=model_type)
        _sweep("multi_lstm_bwd", cuda_lstm, "MULTI_BWD_ROWS",
               "MULTI_BWD_THREADS", (1, 2, 4, 8), (128, 256, 512), N_TRAIN,
               lambda: cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims),
               model_type=model_type)


def profile(cfg, params):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    predictor = Predictor(cfg, params, batch_size=N)
    X = np.random.default_rng(0).normal(
        size=(N, cfg.seqlength, cfg.d_total)).astype(np.float32)
    for _ in range(3):
        predictor.predict(X)
    torch.cuda.synchronize()
    reps = 20
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            predictor.predict(X)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # device_time_total sums over calls, in microseconds
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    print(json.dumps({
        "profile": "predict", "batch": N, "calls": reps,
        "wall_ms_per_call": wall_ms / reps,
        "device_ms_per_call": device_ms / reps,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches_per_call": sum(e.count for e in kernels) / reps,
        "top": [{"name": e.key[:60], "count_per_call": e.count / reps,
                 "ms_per_call": e.device_time_total / 1e3 / reps}
                for e in top]}), flush=True)


def main(parts=None):
    parts = set(parts or ("serve", "train", "multi", "profile"))
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
    params = mfm.MFM(cfg, seed=0, device="cuda").tree()
    with torch.inference_mode():
        if "serve" in parts:
            sweep(cfg, params, torch.device("cuda"))
        if "train" in parts:
            train_sweep(cfg, params, torch.device("cuda"))
        if "multi" in parts:
            multi_sweep(cfg, torch.device("cuda"))
    if "profile" in parts:
        profile(cfg, params)


if __name__ == "__main__":
    main(sys.argv[1:])
