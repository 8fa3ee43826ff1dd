#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``factorized_tpu_torch``) on one
CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``factorized_tpu_torch/csrc/`` and prints
   what ``nvcc -Xptxas -v`` reports;
3. holds each kernel against its plain PyTorch version on the card at the
   serving shapes (n = 256, t = 20, ``best_acc_mosi_config``), float32
   with TF32 off, within rtol 1e-4 / atol 1e-5 (the sums run in another
   order than cuBLAS's);
4. serves the MFM model from a checkpoint of seeded random weights over
   HTTP with micro-batching, answers requests of 1 to 300 samples, some
   concurrent, checks every reply against the plain path on the CPU, and
   checks that the serving run launched every kernel;
5. times each kernel and its plain version with CUDA events, and one
   padded 256-row ``predict`` with its stages;
6. prints one JSON line on the kernels, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA card it exits 1.
"""

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5
SEED = 0
N_SERVE = 256
REQUEST_SIZES = (1, 3, 17, 64, 100, 256, 257, 300, 5, 40)
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(obj):
    print(json.dumps(obj), flush=True)


def compare(name, got, want):
    """Max errors of got against want; raises past RTOL/ATOL."""
    diff = (got - want).abs()
    out = {
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff / want.abs().clamp_min(1e-3)).max()),
        "tol_ratio": float((diff / (ATOL + RTOL * want.abs())).max()),
    }
    log({"check": name, **out})
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    return out


def cuda_ms(fn, reps, warmup=3):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
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


def bound(flops, nbytes):
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def post(port, x):
    body = json.dumps({"x": x.tolist()}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.asarray(json.loads(resp.read())["y"], np.float32)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port is imported only now: alone, without the repository, the
    # script fails here
    from factorized_tpu_torch.config import best_acc_mosi_config
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import split_modalities
    from factorized_tpu_torch.ops import _build, cuda_lstm, cuda_mfn
    from factorized_tpu_torch.ops.core import linear_apply
    from factorized_tpu_torch.serve import Predictor, make_server
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log({"phase": "card", "nvidia_smi": smi, "kind": kind,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "library": str(_build.library_path())})
    print(_build.build_log(), flush=True)

    # ---- 3. each kernel against its plain version, main-path shapes
    cfg = best_acc_mosi_config()
    t, d = cfg.seqlength, cfg.d_total
    model = mfm.MFM(cfg, seed=SEED, device=dev)
    params = model.tree()
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((t, N_SERVE, d), generator=gen).to(dev)
    with torch.inference_mode():
        (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
            mfm.kernel_operands(params, x, cfg)
        h_last, mem_last = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
        h_ref, mem_ref = cuda_mfn.mfm_encode_plain(xp, weights, z_tot)
        torch.cuda.synchronize()
        err_enc = max(compare("mfm_encode_fwd.h_last", h_last, h_ref),
                      compare("mfm_encode_fwd.mem_last", mem_last, mem_ref),
                      key=lambda e: e["max_abs_err"])

        outs = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)
        refs = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t)
        torch.cuda.synchronize()
        err_dec = max((compare(f"decoder_lstm_fwd.{nm}", o, r)
                       for nm, o, r in zip(("allh", "allc", "gates"), outs,
                                           refs)),
                      key=lambda e: e["max_abs_err"])

    # ---- 4. serve from a checkpoint, replies checked against the CPU
    rng = np.random.default_rng(SEED)
    requests = [np.round(rng.normal(size=(k, t, d)), 3).astype(np.float32)
                for k in REQUEST_SIZES]
    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, params, config=cfg.to_dict())
        predictor = Predictor.from_checkpoint(ckpt)
        reference = Predictor.from_checkpoint(ckpt, device="cpu")
    expected = [reference.predict(r) for r in requests]
    server, batcher = make_server(predictor, "127.0.0.1", 0,
                                  micro_batch=True)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        cuda_mfn.LAUNCHES = 0
        cuda_lstm.LAUNCHES = 0
        replies = [post(port, requests[0]), post(port, requests[1])]
        with ThreadPoolExecutor(len(requests) - 2) as pool:
            replies += list(pool.map(lambda r: post(port, r), requests[2:]))
        launches = {"mfm_encode_fwd": cuda_mfn.LAUNCHES,
                    "decoder_lstm_fwd": cuda_lstm.LAUNCHES}
        batches = (batcher.batches_run, batcher.requests_served)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    serving.join(timeout=10)
    worst = 0.0
    for r, y, want in zip(requests, replies, expected):
        if y.shape != want.shape or not np.isfinite(y).all():
            raise AssertionError(f"bad reply shape {y.shape} for {r.shape}")
        np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL)
        worst = max(worst, float(np.abs(y - want).max()))
    log({"phase": "serve", "requests": len(requests),
         "samples": int(sum(REQUEST_SIZES)), "batches_run": batches[0],
         "requests_served": batches[1], "max_abs_err_vs_cpu": worst,
         "launches": launches})
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched while serving")

    # ---- 5. times
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: cuda_mfn.mfm_encode(xp, weights, z_tot,
                                                     h_dims), 50)
        enc_plain_ms = cuda_ms(
            lambda: cuda_mfn.mfm_encode_plain(xp, weights, z_tot), 10)
        dec_ms = cuda_ms(lambda: cuda_lstm.decoder_lstm_fwd(
            h0, c0, wsum, b, t, dec_dims), 50)
        dec_plain_ms = cuda_ms(
            lambda: cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t), 10)

        # one padded forward by stage, CUDA events between the stages
        x_l, x_a, x_v = split_modalities(x, cfg.input_dims)

        def staged():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            zl, za, zv, mfn_last = mfm._encode_stage(params, x_l, x_a, x_v,
                                                     cfg)
            zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
            ev[1].record()
            noise = torch.randn(mfm.mmd_noise_shape(cfg, N_SERVE),
                                device=dev, generator=torch.Generator(
                                    device=dev).manual_seed(0))
            mfm._mmd4(zl, za, zv, zy, noise)
            fy, fl, fa, fv = mfm._zf_all(params, zy, zl, za, zv)
            ev[2].record()
            mfm._decode(params, fy, fl, fa, fv, t, cfg)
            ev[3].record()
            torch.cuda.synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

        for _ in range(3):
            staged()
        stages = np.median([staged() for _ in range(20)], axis=0)
    X = np.round(rng.normal(size=(N_SERVE, t, d)), 3).astype(np.float32)
    probe = predictor.probe(X, reps=20)
    predict_ms = probe["median_s"] * 1e3
    log({"phase": "predict", "batch": N_SERVE, "nvidia_smi": smi,
         "predict_ms": predict_ms,
         "samples_per_s": probe["throughput_per_s"],
         "encode_stage_ms": float(stages[0]),
         "mmd_zf_ms": float(stages[1]),
         "decode_stage_ms": float(stages[2]),
         "decode_share_of_predict": float(stages[2]) / predict_ms})

    # bounds from this run's shapes: useful float32 work (only the
    # diagonal blocks of the recurrent weights) and each input read once,
    # each output written once
    n = N_SERVE
    s1, s2, s3, s4, mem = cuda_mfn._sizes(weights)
    m2 = 2 * (sum(h_dims) - z_tot)
    enc_macs = t * n * (4 * sum(h * h for h in h_dims)
                        + m2 * s1 + s1 * m2 + m2 * s2 + s2 * mem
                        + (m2 + mem) * (s3 + s4) + (s3 + s4) * mem)
    enc_bound = bound(2 * enc_macs, nbytes(xp, *weights.values(), h_last,
                                           mem_last))
    dec_macs = (t - 1) * n * 4 * sum(h * h for h in dec_dims)
    dec_bound = bound(2 * dec_macs, nbytes(h0, c0, wsum, b, *outs))
    kernels = [
        {"name": "mfm_encode_fwd", "route": "cuda",
         "source": "factorized_tpu_torch/csrc/mfm_encode_fwd.cu",
         "replaces": "factorized_tpu/ops/pallas_mfn.py:169",
         "launches": launches["mfm_encode_fwd"],
         "max_abs_err": err_enc["max_abs_err"], "ms": enc_ms,
         "plain_ms": enc_plain_ms, "bound_ms": enc_bound[0],
         "bound_by": enc_bound[1], "library_ms": None},
        {"name": "decoder_lstm_fwd", "route": "cuda",
         "source": "factorized_tpu_torch/csrc/decoder_lstm_fwd.cu",
         "replaces": "factorized_tpu/ops/pallas_lstm.py:272",
         "launches": launches["decoder_lstm_fwd"],
         "max_abs_err": err_dec["max_abs_err"], "ms": dec_ms,
         "plain_ms": dec_plain_ms, "bound_ms": dec_bound[0],
         "bound_by": dec_bound[1], "library_ms": None},
    ]
    log({"kernels": kernels})
    print(smi, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
