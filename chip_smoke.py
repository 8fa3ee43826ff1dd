#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``factorized_tpu_torch``) on one
CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``factorized_tpu_torch/csrc/`` and prints
   what ``nvcc -Xptxas -v`` reports, and a line of the registers, static
   shared memory, stack and spills of the kernels of the encode's passes,
   forward and backward, and of the recurrences' forward and backward
   chains;
3. holds each kernel against its plain PyTorch version on the card at the
   serving shapes (n = 256, t = 20, ``best_acc_mosi_config``), float32
   with TF32 off, within rtol 1e-4 / atol 1e-5 (the sums run in another
   order than cuBLAS's), the encode forward also against the plain mirror
   of its three passes;
4. serves the MFM model from a checkpoint of seeded random weights over
   HTTP with micro-batching, answers requests of 1 to 300 samples, some
   concurrent, checks every reply against the plain path on the CPU, and
   checks that the serving run launched every kernel;
5. times each kernel and its plain version with CUDA events over
   back-to-back calls (``ms``: a call's time, the host's included), each
   kernel also with its calls queued behind a sleeping kernel
   (``device_ms``: the card's time alone, which a host-bound wrapper
   hides from ``ms``), and one padded 256-row ``predict`` with its
   stages;
6. holds the training kernels (the encode forward with dropout masks and
   residuals, the encode backward and its weight-gradient reduction, the
   decoder backward) against their plain versions at the training shapes
   (n = 32), gradients within rtol 1e-3 / atol 2e-5 (sums over t * n
   rows in another order), and one train step's gradients on the card
   against the plain path on the CPU with the same injected draws, and a
   line of the encode backward's time split between its four passes
   (torch.profiler) with the rows and threads of their blocks, and a line
   of the encode forward's time split between its three passes at both
   batches; the weight-gradient kernel also at step 11's widest encode and
   at widths whose column offsets are not multiples of four floats, each
   with the cluster size and copy width it took and a rerun's bits, beside
   its library yardstick (7 ``torch.mm`` and 7 ``sum(0)``); and the bounds
   of the decoder forward at n = 32 and of the decoder backward over
   ``missing``'s 4n stacked rows;
7. trains MFM for 2 epochs on the synthetic MOSI set through
   ``trainers.train_mfm``, checks finite, falling train loss and that the
   run launched every kernel, then times a train step, an epoch, the
   training kernels and their plain versions, and profiles the step;
8. holds the fused encoder-cell kernels (``multi_lstm_fwd``, eval at
   n = 256 and train at n = 32, and ``multi_lstm_bwd`` at n = 32) against
   their plain versions at the widths of ``kl_ef`` and ``missing``, and
   times them beside the k per-cell ``torch.nn.LSTM`` (cuDNN) calls over
   the same cells, as the decoder kernels are timed beside one
   ``torch.nn.LSTM`` per decoder cell;
9. serves ``kl_ef`` and ``missing`` from checkpoints over HTTP, replies
   checked against the CPU; one train step's gradients of each on the
   card against the CPU with the same injected draws; trains ``kl_ef``
   through ``trainers.train_beta_vae`` (2 epochs per stage) and
   ``missing`` through ``trainers.train_mfm_missing`` (2 epochs), checking
   finite losses, a falling stage-1 and a falling ``missing`` loss and
   that each path launched every kernel it runs, and that one ``missing``
   train step launches the decoder forward and backward once each (its
   four decodes stacked); times and profiles each model's train step;
10. the probe path: the encode's probe variants (the forward writing its
    residuals as ten tensors, the backward recomputing att on its chain,
    the backward taking two reverse steps per iteration) against their
    plain versions at full width and n = 32, each timed beside the
    training path's backward; both probe entry points
    (``factorized_tpu_torch.probes``) run with their repetitions cut,
    checking that the run launched every variant;
11. the chains past one block's shared memory: a decoder cell of 160
    units and a memory chain of mem 128 with both gamma MLPs 128 wide
    (256 KiB), each kernel on its thread-block cluster against its plain
    version, the cluster sizes printed; and the chains past a cluster of
    8, which read their weights from L2: a 336-unit decoder cell (``fy``
    80 + ``fl`` 256, a search draw's widest), a 400-unit encode cell with
    mem 400 and both gamma MLPs 256 wide, and 400-unit ``multi_lstm``
    cells, each forward and backward against its plain version, with the
    plan and the L2 launch count each took;
12. prints one JSON line on the ten kernels, the ``nvidia-smi`` line,
    and last ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA card it exits 1.
"""

import functools
import json
import re
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
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-5
SEED = 0
N_SERVE = 256
N_TRAIN = 32
TRAIN_EPOCHS = 2
# queued_ms's sleeping kernel: about 0.1 s at the H100's clock, far
# longer than enqueueing 50 wrapper calls
SLEEP_CYCLES = 200_000_000
REQUEST_SIZES = (1, 3, 17, 64, 100, 256, 257, 300, 5, 40)
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the encode's probe variants: no training or serving path runs them
PROBE_KERNELS = ("mfm_encode_fwd_split", "mfm_encode_bwd_recompute_att",
                 "mfm_encode_bwd_two_step")


def log(obj):
    print(json.dumps(obj), flush=True)


def compare(name, got, want, rtol=RTOL, atol=ATOL):
    """Max errors of got against want; raises past rtol/atol."""
    diff = (got - want).abs()
    out = {
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff / want.abs().clamp_min(1e-3)).max()),
        "tol_ratio": float((diff / (atol + rtol * want.abs())).max()),
    }
    log({"check": name, **out})
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    return out


def compare_all(name, pairs, rtol=RTOL, atol=ATOL):
    """compare() over (label, got, want) triples; the worst by abs err."""
    return max((compare(f"{name}.{label}", g, w, rtol, atol)
                for label, g, w in pairs), key=lambda e: e["max_abs_err"])


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


def queued_ms(fn, reps=50, warmup=3):
    """Mean device milliseconds of one fn() call: CUDA events around reps
    calls queued behind a kernel that sleeps until all of them are
    enqueued, so the card runs them back to back. For a wrapper whose host
    time per call passes its kernels' device time, where cuda_ms would
    time the host."""
    for _ in range(warmup):
        fn()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    torch.cuda.synchronize()
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if not slept.elapsed_time(start) > enqueue_ms:
        raise AssertionError(
            f"the card woke before {reps} calls were enqueued "
            f"({enqueue_ms} ms): the time would hold the host's")
    return start.elapsed_time(end) / reps


def on_device(event):
    """Whether a profiler event (of ``key_averages()``) is a kernel or
    copy on the card. A ``record_function`` range, such as the optimizer's
    ``Optimizer.step#Adam.step``, shows on the card too, as the span from
    its first kernel to its last, host-paced gaps included: its kernels are
    counted already, so it is left out."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def kernel_split_ms(fn, reps=50, warmup=3):
    """{kernel name: mean device milliseconds a call} of the kernels fn()
    launches, over reps calls under torch.profiler: how a call's time
    splits between its kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if on_device(e)}


def kernel_name(key):
    """``gates_kernel<4>`` of the profiler's
    ``void ftt::(anonymous namespace)::gates_kernel<4>(ftt::...)``."""
    m = re.search(r"(?:^|::)(\w+(?:<[^>]*>)?)\(", key)
    return m.group(1) if m else key


def ptxas_report(log_text, names):
    """What ``nvcc -Xptxas -v`` printed for each kernel whose mangled name
    holds one of ``names``: registers, static shared memory, stack and
    spills, one entry per template instance."""
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            hit = next((k for k in names if k in name), None)
            cur = None
            if hit is not None:
                args = re.search(hit + r"I(.*?)EEv", name)
                cur = {"kernel": hit, "template": (
                    re.findall(r"L[ib](\d+)E", args.group(1)) if args
                    else [])}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def bound(flops, nbytes):
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def diag_bytes(h_dims):
    """Bytes of the diagonal blocks of a packed gate-major recurrent
    weight (float32, four gates): the only part the kernels read."""
    return 4 * 4 * sum(h * h for h in h_dims)


def off_diag(weights):
    """The packed weights but the recurrent one (see diag_bytes)."""
    return [w for k, w in weights.items() if k != "wh"]


def decoder_library_ms(h0, c0, wsum, b, t, dec_dims, backward=False):
    """The yardstick of the decoder kernels, used nowhere in the port: one
    ``torch.nn.LSTM`` (cuDNN) per decoder cell computes the same t - 1
    steps from (h0, c0), with a zero input of width 1, ``weight_ih``
    zero, ``weight_hh`` the cell's diagonal blocks of wsum transposed,
    ``bias_ih`` its b and ``bias_hh`` zero. Forward ms by CUDA events; with
    ``backward``, (forward + backward) - forward, the outputs' cotangent
    all ones."""
    from factorized_tpu_torch.ops import cuda_lstm

    n, H = h0.shape
    dev = h0.device
    lstms, states, o = [], [], 0
    for h in dec_dims:
        cols = cuda_lstm.cell_columns(H, o, h, dev)
        m = torch.nn.LSTM(1, h).to(dev)
        with torch.no_grad():
            m.weight_ih_l0.zero_()
            m.weight_hh_l0.copy_(wsum[o:o + h][:, cols].T)
            m.bias_ih_l0.copy_(b.reshape(-1)[cols])
            m.bias_hh_l0.zero_()
        lstms.append(m)
        states.append((h0[None, :, o:o + h].clone(),
                       c0[None, :, o:o + h].clone()))
        o += h
    zeros = torch.zeros((t - 1, n, 1), device=dev)

    def forward():
        return [m(zeros, st)[0] for m, st in zip(lstms, states)]

    if not backward:
        with torch.inference_mode():
            return cuda_ms(forward, 50)

    def both():
        hs = forward()
        torch.autograd.backward(hs, [torch.ones_like(h) for h in hs])

    return cuda_ms(both, 50) - cuda_ms(forward, 50)


def counters():
    """Each kernel's launch counter: {name: (module, attribute)}."""
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    return {"mfm_encode_fwd": (cuda_mfn, "LAUNCHES"),
            "mfm_encode_bwd": (cuda_mfn, "BWD_LAUNCHES"),
            "mfm_encode_dw": (cuda_mfn, "DW_LAUNCHES"),
            "decoder_lstm_fwd": (cuda_lstm, "LAUNCHES"),
            "decoder_lstm_bwd": (cuda_lstm, "BWD_LAUNCHES"),
            "multi_lstm_fwd": (cuda_lstm, "MULTI_LAUNCHES"),
            "multi_lstm_bwd": (cuda_lstm, "MULTI_BWD_LAUNCHES"),
            "mfm_encode_fwd_split": (cuda_mfn, "SPLIT_LAUNCHES"),
            "mfm_encode_bwd_recompute_att": (cuda_mfn, "RECOMPUTE_LAUNCHES"),
            "mfm_encode_bwd_two_step": (cuda_mfn, "TWO_STEP_LAUNCHES")}


def counted(path, kernels, fn):
    """Runs fn() with every launch count set to 0 just before and read
    just after; fails unless each of ``kernels`` was launched. Returns
    (fn's result, seconds, {kernel: launches})."""
    for module, attr in counters().values():
        setattr(module, attr, 0)
    for module in {m for m, _ in counters().values()}:
        module.L2_LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t0
    launches = {k: getattr(m, a) for k, (m, a) in counters().items()}
    for name in kernels:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on path {path}")
    return out, seconds, launches


def post(port, x):
    body = json.dumps({"x": x.tolist()}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.asarray(json.loads(resp.read())["y"], np.float32)


def serve_requests(predictor, reference, requests):
    """Serves ``requests`` over HTTP with micro-batching (the first two
    alone, the rest concurrently) and checks every reply against the CPU
    ``reference``. Returns (worst abs error, (batches run, requests
    served))."""
    from factorized_tpu_torch.serve import make_server

    expected = [reference.predict(r) for r in requests]
    server, batcher = make_server(predictor, "127.0.0.1", 0,
                                  micro_batch=True)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        replies = [post(port, requests[0]), post(port, requests[1])]
        with ThreadPoolExecutor(len(requests) - 2) as pool:
            replies += list(pool.map(lambda r: post(port, r), requests[2:]))
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
    return worst, batches


def grads_vs_cpu(label, loss_fn, params, x, y, draws, dev):
    """One train step's gradients on the card against the CPU's plain
    path: the same parameters, batch and injected draws (a dict of
    tensors, or of lists of tensors or None, nested)."""
    from factorized_tpu_torch.convert import from_state_dict, to_state_dict

    def move(v, where):
        if isinstance(v, dict):
            return {k: move(u, where) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return [move(u, where) for u in v]
        return None if v is None else v.to(where)

    grads = {}
    for where in ("cpu", dev):
        flat = {k: v.detach().to(where).requires_grad_()
                for k, v in to_state_dict(params).items()}
        loss, _ = loss_fn(from_state_dict(flat), x.to(where), y.to(where),
                          draws=move(draws, where))
        loss.backward()
        grads[str(where)] = {k: (torch.zeros_like(v) if v.grad is None
                                 else v.grad).cpu() for k, v in flat.items()}
    return compare_all(label, [(k, grads[str(dev)][k], grads["cpu"][k])
                               for k in grads["cpu"]], GRAD_RTOL, GRAD_ATOL)


def zf_masks(cfg, n, generator):
    """Scaled keep-masks of the four z->f sites (zy's rate is 0: None)."""
    return [None] + [
        (torch.rand((n, f), generator=generator) >= r).float() / (1.0 - r)
        for f, r in ((cfg.fl_size, cfg.zl_to_fl_dropout),
                     (cfg.fa_size, cfg.za_to_fa_dropout),
                     (cfg.fv_size, cfg.zv_to_fv_dropout))]


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
    from factorized_tpu_torch.serve import Predictor
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
    log({"phase": "ptxas", "note": "dynamic shared memory is sized at "
         "launch", "kernels": ptxas_report(_build.build_log(), (
             "cell_chains_fwd_kernel", "product_fwd_kernel",
             "softmax_fwd_kernel",
             "mem_chain_fwd_kernel", "gates_kernel", "mem_chain_kernel",
             "recompute_att_kernel", "product_kernel", "softmax_bwd_kernel",
             "lstm_chains_kernel", "lstm_chain_bwd_kernel",
             "lstm_chain_fwd_kernel", "mfm_encode_dw_kernel"))})

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
        passes_ref = cuda_mfn.mfm_encode_fwd_passes_plain(xp, weights,
                                                          z_tot, h_dims)
        err_enc = max(compare("mfm_encode_fwd.h_last", h_last, h_ref),
                      compare("mfm_encode_fwd.mem_last", mem_last, mem_ref),
                      compare_all("mfm_encode_fwd.passes",
                                  zip(("h_last", "mem_last"),
                                      (h_last, mem_last), passes_ref)),
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
    (worst, batches), _, launches = counted(
        "serve mfm", ("mfm_encode_fwd", "decoder_lstm_fwd"),
        lambda: serve_requests(predictor, reference, requests))
    launches = {k: launches[k] for k in ("mfm_encode_fwd",
                                         "decoder_lstm_fwd")}
    log({"phase": "serve", "requests": len(requests),
         "samples": int(sum(REQUEST_SIZES)), "batches_run": batches[0],
         "requests_served": batches[1], "max_abs_err_vs_cpu": worst,
         "launches": launches})

    # ---- 5. times
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: cuda_mfn.mfm_encode(xp, weights, z_tot,
                                                     h_dims), 50)
        enc_dev_ms = queued_ms(lambda: cuda_mfn.mfm_encode(xp, weights,
                                                           z_tot, h_dims))
        enc_plain_ms = cuda_ms(
            lambda: cuda_mfn.mfm_encode_plain(xp, weights, z_tot), 10)
        dec_ms = cuda_ms(lambda: cuda_lstm.decoder_lstm_fwd(
            h0, c0, wsum, b, t, dec_dims), 50)
        dec_dev_ms = queued_ms(lambda: cuda_lstm.decoder_lstm_fwd(
            h0, c0, wsum, b, t, dec_dims))
        dec_plain_ms = cuda_ms(
            lambda: cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t), 10)
    dec_library_ms = decoder_library_ms(h0, c0, wsum, b, t, dec_dims)
    with torch.inference_mode():
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
    # diagonal blocks of the recurrent weights; no product with the zero
    # state of step 0) and each input read once, each output written once
    n = N_SERVE
    enc_macs = n * (t * encode_macs_per_row(weights, h_dims, z_tot)
                    - 4 * sum(h * h for h in h_dims))
    enc_bound = bound(2 * enc_macs,
                      nbytes(xp, *off_diag(weights), h_last, mem_last)
                      + diag_bytes(h_dims))
    dec_macs = (t - 1) * n * 4 * sum(h * h for h in dec_dims)
    dec_bound = bound(2 * dec_macs,
                      nbytes(h0, c0, b, *outs) + diag_bytes(dec_dims))
    serve_kernels = [
        {"name": "mfm_encode_fwd", "route": "cuda",
         "source": "factorized_tpu_torch/csrc/mfm_encode_fwd.cu",
         "replaces": "factorized_tpu/ops/pallas_mfn.py:169",
         "launches": launches["mfm_encode_fwd"],
         "max_abs_err": err_enc["max_abs_err"], "ms": enc_ms,
         "device_ms": enc_dev_ms, "plain_ms": enc_plain_ms,
         "bound_ms": enc_bound[0], "bound_by": enc_bound[1],
         "library_ms": None},
        {"name": "decoder_lstm_fwd", "route": "cuda",
         "source": "factorized_tpu_torch/csrc/lstm_fwd.cu",
         "replaces": "factorized_tpu/ops/pallas_lstm.py:272",
         "launches": launches["decoder_lstm_fwd"],
         "max_abs_err": err_dec["max_abs_err"], "ms": dec_ms,
         "device_ms": dec_dev_ms, "plain_ms": dec_plain_ms,
         "bound_ms": dec_bound[0], "bound_by": dec_bound[1],
         "library_ms": dec_library_ms},
    ]

    train_kernels = train_phase(cfg, dev, smi)
    variant_kernels = variants_phase(cfg, dev, smi)
    probe_kernels = probe_phase(cfg, dev, smi)
    cluster_phase(cfg, dev, smi)
    log({"kernels": serve_kernels + train_kernels + variant_kernels
         + probe_kernels})
    print(smi, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


def encode_macs_per_row(weights, h_dims, z_tot):
    """Multiply-adds of one step of one row of the encode forward."""
    from factorized_tpu_torch.ops import cuda_mfn

    s1, s2, s3, s4, mem = cuda_mfn.sizes(weights)
    m2 = 2 * (sum(h_dims) - z_tot)
    return (4 * sum(h * h for h in h_dims) + m2 * s1 + s1 * m2 + m2 * s2
            + s2 * mem + (m2 + mem) * (s3 + s4) + (s3 + s4) * mem)


def train_phase(cfg, dev, smi):
    """Steps 6 and 7; returns the kernels-line entries of the three
    training kernels."""
    from factorized_tpu_torch import perf_probe
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
    from factorized_tpu_torch.train import TrainProgram, make_optimizer
    from factorized_tpu_torch.trainers import train_mfm
    from factorized_tpu_torch.utils.logging import RunLogger

    t, n = cfg.seqlength, N_TRAIN
    params = mfm.MFM(cfg, seed=SEED + 2, device=dev).tree()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((t, n, cfg.d_total), generator=gen, device=dev)
    y = torch.randn((n,), generator=gen, device=dev)

    # ---- 6a. each training kernel against its plain version, n = 32
    with torch.inference_mode():
        (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
            mfm.kernel_operands(params, x, cfg)
        masks = cuda_mfn.make_dropout_masks(
            gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(cfg))
        fwd = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        fwd_ref = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)
        passes_ref = cuda_mfn.mfm_encode_fwd_passes_plain(
            xp, weights, z_tot, h_dims, masks, True)
        torch.cuda.synchronize()
        # each field against the steps' plain version and the passes':
        # allh and allc are pass (1)'s, att to chat pass (2)'s, r3, kg3,
        # g1, g2, allmem and mem_last pass (3)'s
        fields = ("h_last", "mem_last", "allh", "allc", "allmem",
                  *cuda_mfn.RES_NAMES)

        def by_field(outs):
            return (*outs[:5], *cuda_mfn.res_fields(outs[5], weights)
                    .values())

        err_fwd = max(
            compare_all("mfm_encode_fwd.train",
                        zip(fields, by_field(fwd), by_field(fwd_ref))),
            compare_all("mfm_encode_fwd.train.passes",
                        zip(fields, by_field(fwd), by_field(passes_ref))),
            key=lambda e: e["max_abs_err"])
        res = fwd_ref[2:]  # the backward kernels read the plain residuals
        dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
        dmem = torch.randn((n, weights["a2w2"].shape[1]), generator=gen,
                           device=dev)
        dxp, deltas = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem,
                                           z_tot, h_dims)
        dxp_ref, deltas_ref = cuda_mfn.mfm_encode_bwd_steps_plain(
            xp, weights, *res, dh, dmem, z_tot)
        torch.cuda.synchronize()
        err_bwd = compare_all("mfm_encode_bwd",
                              [("dxp", dxp, dxp_ref),
                               ("deltas", deltas, deltas_ref)],
                              GRAD_RTOL, GRAD_ATOL)
        dw_out = cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                     deltas_ref, z_tot)
        dw_ref = cuda_mfn.mfm_encode_dw_plain(res[1], res[2], res[3],
                                              deltas_ref, weights, z_tot)
        torch.cuda.synchronize()
        err_dw = compare_all("mfm_encode_dw",
                             [(k, dw_out[k], dw_ref[k])
                              for k in cuda_mfn.DW_NAMES],
                             GRAD_RTOL, GRAD_ATOL)
        dw_plan = dict(cuda_mfn.DW_PLAN)
        again = cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                    deltas_ref, z_tot)
        if not all(torch.equal(dw_out[k], again[k])
                   for k in cuda_mfn.DW_NAMES):
            raise AssertionError("mfm_encode_dw: a rerun gave other bits")
        allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t)
        dallh = torch.randn(allh.shape, generator=gen, device=dev)
        dec = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh, dec_dims)
        dec_ref = cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc, dallh)
        torch.cuda.synchronize()
        err_decb = compare_all("decoder_lstm_bwd",
                               zip(("dgates", "dh0", "dc0"), dec, dec_ref),
                               GRAD_RTOL, GRAD_ATOL)

    # ---- 6b. one train step's gradients: card against the CPU's plain
    #      path, the same parameters, batch and injected draws
    cpu = torch.Generator().manual_seed(SEED + 4)
    draws = {
        "encode_masks": cuda_mfn.make_dropout_masks(
            cpu, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(cfg)),
        "mmd_noise": torch.randn(mfm.mmd_noise_shape(cfg, n), generator=cpu),
        "zf_masks": zf_masks(cfg, n, cpu),
    }
    program = TrainProgram(mfm.mfm_apply, cfg)
    grads_vs_cpu("train_step_grads_vs_cpu", program.loss_fn, params, x, y,
                 draws, dev)

    # ---- 7a. the training path: 2 epochs of synthetic MOSI through the
    #      trainer, every kernel's count read just after
    data = mosi.get_data(cfg.seqlength)
    run, train_s, launches = counted(
        "train mfm", ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
                      "decoder_lstm_fwd", "decoder_lstm_bwd"),
        lambda: train_mfm(*data, cfg.replace(num_epochs=TRAIN_EPOCHS),
                          seed=SEED, logger=RunLogger(echo=False),
                          device=dev))
    launches = {k: launches[k] for k in (
        "mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
        "decoder_lstm_fwd", "decoder_lstm_bwd")}
    losses = [e["train_loss"] for e in run["history"]]
    log({"phase": "train", "epochs": TRAIN_EPOCHS, "seconds": train_s,
         "history": run["history"], "metrics": run["metrics"],
         "launches": launches})
    if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"training did not run clean: {run['history']}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    if not np.all(np.isfinite(list(run["metrics"].values()))):
        raise AssertionError(f"non-finite test metrics {run['metrics']}")

    # ---- 7b. times: a step, an epoch, each training kernel and its plain
    #      version
    Xb = torch.from_numpy(np.ascontiguousarray(
        data[0][:19 * n].reshape(19, n, t, -1).transpose(0, 2, 1, 3))).to(dev)
    yb = torch.from_numpy(data[1][:19 * n].reshape(19, n)).to(dev)
    tree = mfm.MFM(cfg, seed=SEED, device=dev).tree()
    opt = make_optimizer(tree, 1e-3)
    step_ms = cuda_ms(lambda: program.step(tree, opt, Xb[0], yb[0], gen,
                                           1e-3), 30)
    epoch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        program.run_epoch(tree, opt, Xb, yb, gen, 1e-3)
        epoch_s.append(time.perf_counter() - t0)
    prof = profile_steps(program, tree, opt, Xb[0], yb[0], gen)
    log({"phase": "train_times", "batch": n, "nvidia_smi": smi,
         "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
         "epoch_s": float(np.median(epoch_s)), "epoch_batches": 19, **prof})

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: cuda_mfn.mfm_encode_res(
            xp, masks, weights, z_tot, h_dims), 50)
        fwd_plain_ms = cuda_ms(lambda: cuda_mfn.mfm_encode_res_plain(
            xp, masks, weights, z_tot), 10)

        def bwd():
            return cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                        h_dims)

        def dw():
            return cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                       deltas_ref, z_tot)

        def decb():
            return cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                              dec_dims)

        bwd_ms, bwd_dev_ms = cuda_ms(bwd, 50), queued_ms(bwd)
        bwd_kernels = kernel_split_ms(bwd)
        bwd_plain_ms = cuda_ms(lambda: cuda_mfn.mfm_encode_bwd_steps_plain(
            xp, weights, *res, dh, dmem, z_tot), 10)
        dw_ms, dw_dev_ms = cuda_ms(dw, 50), queued_ms(dw)
        dw_plain_ms = cuda_ms(lambda: cuda_mfn.mfm_encode_dw_plain(
            res[1], res[2], res[3], deltas_ref, weights, z_tot), 10)
        # the yardstick, used nowhere in the port: 7 torch.mm (cuBLAS) and
        # 7 sum(0), on operands built here, before the timing
        dw_ops = cuda_mfn.dw_operands(res[1], res[2], res[3], weights,
                                      z_tot)
        lib = functools.partial(perf_probe.dw_library, dw_ops, deltas_ref,
                                weights)
        err_lib = compare_all("mfm_encode_dw.library",
                              [(k, v, dw_ref[k].reshape(v.shape))
                               for k, v in lib().items()],
                              GRAD_RTOL, GRAD_ATOL)
        # its calls stall the host while the card sleeps (queued_ms would
        # fail): its device ms is torch.profiler's sum over its kernels
        dw_lib_ms = cuda_ms(lib, 50)
        dw_lib_dev_ms = sum(kernel_split_ms(lib).values())
        # the decoder forward at the training batch, for its bound
        def decf():
            return cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)

        decf_dev_ms = queued_ms(decf)
        # the decoder backward over missing's four stacked decodes (4n
        # rows), for its bound, against its plain version
        h4, c4 = (torch.randn((4 * n, v.shape[1]), generator=gen,
                              device=dev) for v in (h0, c0))
        allh4, allc4, gates4 = cuda_lstm.decoder_lstm_plain(h4, c4, wsum, b,
                                                            t)
        dallh4 = torch.randn(allh4.shape, generator=gen, device=dev)

        def decb4():
            return cuda_lstm.decoder_lstm_bwd(wsum, gates4, allc4, dallh4,
                                              dec_dims)

        dec4 = decb4()
        err_decb4 = compare_all(
            "decoder_lstm_bwd.4n", zip(("dgates", "dh0", "dc0"), dec4,
                                       cuda_lstm.decoder_lstm_bwd_plain(
                                           wsum, gates4, allc4, dallh4)),
            GRAD_RTOL, GRAD_ATOL)
        decb4_dev_ms = queued_ms(decb4)
        decb_ms, decb_dev_ms = cuda_ms(decb, 50), queued_ms(decb)
        decb_plain_ms = cuda_ms(lambda: cuda_lstm.decoder_lstm_bwd_plain(
            wsum, gates, allc, dallh), 10)
    decb_library_ms = decoder_library_ms(h0, c0, wsum, b, t, dec_dims,
                                         backward=True)

    # bounds from this run's shapes, as for the forward kernels; the
    # backward's two recurrent products (the gates recomputed and dh
    # carried back) vanish at step 0, whose previous state is zero
    rows = t * n
    s1, s2, s3, s4, mem = cuda_mfn.sizes(weights)
    m2 = 2 * (sum(h_dims) - z_tot)
    recur = 4 * sum(h * h for h in h_dims)
    fwd_bound = bound(
        2 * (rows * encode_macs_per_row(weights, h_dims, z_tot) - n * recur),
        nbytes(xp, masks, *off_diag(weights), *fwd) + diag_bytes(h_dims))
    bwd_macs = ((t - 1) * n * 2 * recur
                + rows * ((s3 + s4) * mem + s2 * mem + (m2 + mem) * (s3 + s4)
                          + m2 * s2 + 2 * s1 * m2))
    used = ("a1w1", "a1w2", "a2w1", "a2w2", "gw1", "g1w2", "g2w2")
    bwd_bound = bound(2 * bwd_macs, nbytes(
        xp, *res, dh, dmem, *[weights[k] for k in used], dxp, deltas)
        + diag_bytes(h_dims))
    dw_bound = dw_bound_of(res, deltas_ref, dw_out)
    decf_bound = bound(2 * (t - 1) * n * 4 * sum(h * h for h in dec_dims),
                       nbytes(h0, c0, b, allh, allc, gates)
                       + diag_bytes(dec_dims))
    decb4_bound = bound(2 * (t - 1) * 4 * n * 4 * sum(h * h
                                                      for h in dec_dims),
                        nbytes(gates4, allc4, dallh4, *dec4)
                        + diag_bytes(dec_dims))
    decb_macs = (t - 1) * n * 4 * sum(h * h for h in dec_dims)
    decb_bound = bound(2 * decb_macs, nbytes(gates, allc, dallh, *dec)
                       + diag_bytes(dec_dims))
    passes = {name: sum(v for k, v in bwd_kernels.items()
                        if any(kernel in k for kernel in kernels))
              for name, kernels in cuda_mfn.BWD_PASSES.items()}
    # the rows a block of each pass takes are the kernels' template
    # arguments, in their names; the chains' clusters as the last call
    # chose them (1: one block)
    bwd_clusters = cuda_mfn.CLUSTERS["mfm_encode_bwd"]
    log({"phase": "backward_passes", "batch": n, "nvidia_smi": smi,
         "mfm_encode_bwd": {
             "ms": bwd_ms, "device_ms": bwd_dev_ms, "pass_ms": passes,
             "kernel_ms": {kernel_name(k): v
                           for k, v in bwd_kernels.items()},
             "threads": cuda_mfn.BWD_THREADS,
             "clusters": {"memory_chain": bwd_clusters[0],
                          "lstm_chains": bwd_clusters[1]}},
         "decoder_lstm_bwd": {
             "ms": decb_ms, "device_ms": decb_dev_ms,
             "threads": cuda_lstm.BWD_THREADS,
             "cluster": cuda_lstm.CLUSTERS["decoder_lstm_bwd"]}})
    log({"phase": "forward_passes", "nvidia_smi": smi,
         **forward_passes(cfg, dev)})
    log({"phase": "weight_gradients", "nvidia_smi": smi,
         "main": {"n": n, "t": t, **dw_plan, "ms": dw_ms,
                  "device_ms": dw_dev_ms, "bound_ms": dw_bound[0],
                  "bound_by": dw_bound[1],
                  "max_abs_err": err_dw["max_abs_err"]},
         "library": {"note": "7 torch.mm (TF32 off) + 7 sum(0); building "
                     "the operands (dw_operands) is not counted",
                     "ms": dw_lib_ms, "device_ms": dw_lib_dev_ms,
                     "max_abs_err": err_lib["max_abs_err"]},
         **dw_widths_phase(cfg, dev)})
    log({"phase": "decoder_bounds", "nvidia_smi": smi,
         "decoder_lstm_fwd": {"n": n, "device_ms": decf_dev_ms,
                              "bound_ms": decf_bound[0],
                              "bound_by": decf_bound[1]},
         "decoder_lstm_bwd_4n": {"n": 4 * n, "device_ms": decb4_dev_ms,
                                 "bound_ms": decb4_bound[0],
                                 "bound_by": decb4_bound[1],
                                 "max_abs_err": err_decb4["max_abs_err"]}})
    log({"phase": "train_kernels", "batch": n, "nvidia_smi": smi,
         "mfm_encode_fwd_train": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                                  "bound_ms": fwd_bound[0],
                                  "bound_by": fwd_bound[1],
                                  "max_abs_err": err_fwd["max_abs_err"],
                                  "launches": launches["mfm_encode_fwd"]}})

    def entry(name, source, replaces, err, ms, dev_ms, plain_ms, bnd,
              library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"factorized_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err["max_abs_err"], "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms}

    return [
        entry("mfm_encode_bwd", "mfm_encode_bwd.cu",
              "factorized_tpu/ops/pallas_mfn.py:269", err_bwd, bwd_ms,
              bwd_dev_ms, bwd_plain_ms, bwd_bound),
        entry("mfm_encode_dw", "mfm_encode_bwd.cu",
              "factorized_tpu/ops/pallas_mfn.py:342", err_dw, dw_ms,
              dw_dev_ms, dw_plain_ms, dw_bound, dw_lib_ms),
        entry("decoder_lstm_bwd", "lstm_bwd.cu",
              "factorized_tpu/ops/pallas_lstm.py:298", err_decb, decb_ms,
              decb_dev_ms, decb_plain_ms, decb_bound, decb_library_ms),
    ]


def dw_bound_of(res, deltas, grads):
    """The weight-gradient kernel's bound: 2 t n FLOPs an output (every
    output a sum over the t n rows) against allc, allmem, the residuals
    and the deltas read once and the gradients written once."""
    rows = deltas.shape[0] * deltas.shape[1]
    return bound(2 * rows * sum(g.numel() for g in grads.values()),
                 nbytes(res[1], res[2], res[3], deltas, *grads.values()))


def dw_widths_phase(cfg, dev):
    """The weight-gradient kernel against its plain version beyond the
    main path: at step 11's widest encode (an MFN cell of 400, mem 400,
    gamma MLPs 256) and at widths whose column offsets are not multiples
    of four floats, n = 32, t = 20, on the plain forward's residuals and
    the plain reverse pass's deltas; each with the cluster size and copy
    width it took, its device ms and bound, and a rerun's bits."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn

    t, n = cfg.seqlength, N_TRAIN
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    widths = {
        "widest": cfg.replace(h_dims=[400, 64, 48], memsize=400,
                              gamma1_shape=256, gamma2_shape=256),
        "misaligned": cfg.replace(h_dims=[87, 64, 48], memsize=63,
                                  att1_shape=127, att2_shape=126,
                                  gamma1_shape=125, gamma2_shape=129)}
    out = {}
    for k, (label, wcfg) in enumerate(widths.items()):
        params = mfm.MFM(wcfg, seed=SEED + 81 + k, device=dev).tree()
        x = torch.randn((t, n, wcfg.d_total), generator=gen, device=dev)
        with torch.inference_mode():
            (xp, weights, z_tot, h_dims), _ = mfm.kernel_operands(params, x,
                                                                  wcfg)
            masks = cuda_mfn.make_dropout_masks(
                gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(wcfg))
            res = cuda_mfn.mfm_encode_res_plain(xp, masks, weights,
                                                z_tot)[2:]
            dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
            dmem = torch.randn((n, wcfg.memsize), generator=gen, device=dev)
            _, deltas = cuda_mfn.mfm_encode_bwd_steps_plain(
                xp, weights, *res, dh, dmem, z_tot)

            def dw():
                return cuda_mfn._launch_dw(weights, res[1], res[2],
                                           res[3], deltas, z_tot)

            got, again = dw(), dw()
            want = cuda_mfn.mfm_encode_dw_plain(res[1], res[2], res[3],
                                                deltas, weights, z_tot)
            torch.cuda.synchronize()
            err = compare_all(f"mfm_encode_dw.{label}",
                              [(nm, got[nm], want[nm])
                               for nm in cuda_mfn.DW_NAMES],
                              GRAD_RTOL, GRAD_ATOL)
            if not all(torch.equal(got[nm], again[nm])
                       for nm in cuda_mfn.DW_NAMES):
                raise AssertionError(f"mfm_encode_dw.{label}: a rerun "
                                     f"gave other bits")
            plan = dict(cuda_mfn.DW_PLAN)
            dev_ms = queued_ms(dw)
        bnd = dw_bound_of(res, deltas, got)
        out[label] = {"cells": h_dims, "z_tot": z_tot, "mem": wcfg.memsize,
                      "mlps": list(cuda_mfn.sizes(weights)[:4]), **plan,
                      "device_ms": dev_ms, "bound_ms": bnd[0],
                      "bound_by": bnd[1], "max_abs_err": err["max_abs_err"]}
    if out["misaligned"]["copy_bytes"] != 4:
        raise AssertionError(f"misaligned widths took 16-byte copies: "
                             f"{out['misaligned']}")
    return out


def forward_passes(cfg, dev):
    """The encode forward's call split between its three passes
    (``cuda_mfn.FWD_PASSES``, torch.profiler over 50 calls), beside its
    device time (queued calls): eval at n = 256 and train (masks and
    residuals) at n = 32, each kernel by its name (a chain's template
    arguments are its rows and cluster) and the chains' clusters."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn

    params = mfm.MFM(cfg, seed=SEED + 5, device=dev).tree()
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    out = {}
    for variant, n in (("eval", N_SERVE), ("train", N_TRAIN)):
        x = torch.randn((cfg.seqlength, n, cfg.d_total), generator=gen,
                        device=dev)
        with torch.inference_mode():
            (xp, weights, z_tot, h_dims), _ = mfm.kernel_operands(params, x,
                                                                  cfg)
            if variant == "eval":
                def call():
                    return cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
            else:
                masks = cuda_mfn.make_dropout_masks(
                    gen, cfg.seqlength, n, cuda_mfn.sizes(weights)[:4],
                    mfn_drops(cfg))

                def call():
                    return cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot,
                                                   h_dims)
            device_ms = queued_ms(call)
            kernels = kernel_split_ms(call)
        clusters = cuda_mfn.CLUSTERS["mfm_encode_fwd"]
        out[variant] = {
            "n": n, "device_ms": device_ms,
            "pass_ms": {name: sum(v for k, v in kernels.items()
                                  if any(kn in k for kn in names))
                        for name, names in cuda_mfn.FWD_PASSES.items()},
            "kernel_ms": {kernel_name(k): v for k, v in kernels.items()},
            "clusters": {"lstm_chains": clusters[0],
                         "memory_chain": clusters[1]},
            "threads": cuda_mfn.THREADS}
    return out


def cluster_phase(cfg, dev, smi):
    """Step 11: chains whose weights pass one block's shared memory run on
    thread-block clusters. A decoder cell of 160 units (n = 32, t = 20)
    through the decoder backward, and the encode at mem 128 with both
    gamma MLPs 128 wide (256 KiB of memory-chain weights; n = 32, t = 20,
    ``best_acc_mosi_config``'s other widths) through its forward and
    backward, each against its plain version, with the clusters chosen."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    t, n, h = cfg.seqlength, N_TRAIN, 160
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    wsum = 0.1 * torch.randn((h, 4 * h), generator=gen, device=dev)
    gates = torch.randn((t, n, 4 * h), generator=gen, device=dev)
    allc = torch.randn((t, n, h), generator=gen, device=dev)
    dallh = torch.randn((t, n, h), generator=gen, device=dev)
    with torch.inference_mode():
        got = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh, [h])
        want = cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc, dallh)
        torch.cuda.synchronize()
        err_dec = compare_all("cluster.decoder_lstm_bwd",
                              zip(("dgates", "dh0", "dc0"), got, want),
                              GRAD_RTOL, GRAD_ATOL)
    dec_cluster = cuda_lstm.CLUSTERS["decoder_lstm_bwd"]

    wide = cfg.replace(memsize=128, gamma1_shape=128, gamma2_shape=128)
    params = mfm.MFM(wide, seed=SEED + 61, device=dev).tree()
    x = torch.randn((t, n, wide.d_total), generator=gen, device=dev)
    with torch.inference_mode():
        (xp, weights, z_tot, h_dims), _ = mfm.kernel_operands(params, x, wide)
        masks = cuda_mfn.make_dropout_masks(
            gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(wide))
        fwd = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        fwd_ref = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)
        torch.cuda.synchronize()
        err_fwd = compare_all(
            "cluster.mfm_encode_fwd",
            zip(("h_last", "mem_last", "allh", "allc", "allmem", "res"),
                fwd, fwd_ref))
        fwd_clusters = cuda_mfn.CLUSTERS["mfm_encode_fwd"]
        dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
        dmem = torch.randn((n, wide.memsize), generator=gen, device=dev)
        bwd = cuda_mfn._launch_bwd(xp, weights, *fwd_ref[2:], dh, dmem,
                                   z_tot, h_dims)
        bwd_ref = cuda_mfn.mfm_encode_bwd_steps_plain(
            xp, weights, *fwd_ref[2:], dh, dmem, z_tot)
        torch.cuda.synchronize()
        err_bwd = compare_all("cluster.mfm_encode_bwd",
                              zip(("dxp", "deltas"), bwd, bwd_ref),
                              GRAD_RTOL, GRAD_ATOL)
        bwd_clusters = cuda_mfn.CLUSTERS["mfm_encode_bwd"]
    if dec_cluster < 2 or fwd_clusters[1] < 2 or bwd_clusters[0] < 2:
        raise AssertionError("a chain past one block's shared memory did "
                             "not run on a cluster")
    l2_phase(cfg, dev, smi)
    log({"phase": "clusters", "nvidia_smi": smi,
         "decoder_lstm_bwd": {"cells": [h], "n": n, "cluster": dec_cluster,
                              "max_abs_err": err_dec["max_abs_err"]},
         "mfm_encode_fwd": {"mem": 128, "gamma": [128, 128], "n": n,
                            "clusters": {"lstm_chains": fwd_clusters[0],
                                         "memory_chain": fwd_clusters[1]},
                            "max_abs_err": err_fwd["max_abs_err"]},
         "mfm_encode_bwd": {"mem": 128, "gamma": [128, 128], "n": n,
                            "clusters": {"memory_chain": bwd_clusters[0],
                                         "lstm_chains": bwd_clusters[1]},
                            "max_abs_err": err_bwd["max_abs_err"]}})


def l2_phase(cfg, dev, smi):
    """Step 11's second half: the widest chains a search draw makes,
    past a cluster of 8, whose kernels read their weights from L2 (plan 0,
    counted in ``L2_LAUNCHES``): a 336-unit decoder cell (``fy`` 80 +
    ``fl`` 256) through the decoder forward and backward; the encode with
    a 400-unit MFN cell, mem 400 and both gamma MLPs 256 wide through its
    forward (eval and train) and backward; 400-unit ``multi_lstm`` cells
    through its forward (eval and train) and backward. n = 32, t = 20, the
    other widths ``best_acc_mosi_config``'s; each against its plain
    version, timed by queued calls (the card's time alone)."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    t, n = cfg.seqlength, N_TRAIN
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    wide = cfg.replace(fy_size=80, fl_size=256, h_dims=[400, 64, 48],
                       memsize=400, gamma1_shape=256, gamma2_shape=256)
    params = mfm.MFM(wide, seed=SEED + 71, device=dev).tree()
    x = torch.randn((t, n, wide.d_total), generator=gen, device=dev)
    for module in (cuda_lstm, cuda_mfn):
        module.L2_LAUNCHES.clear()
    out = {}
    with torch.inference_mode():
        (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
            mfm.kernel_operands(params, x, wide)
        # the decoder, forward and backward
        got = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)
        allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t)
        err = compare_all("l2.decoder_lstm_fwd",
                          zip(("allh", "allc", "gates"), got,
                              (allh, allc, gates)))
        out["decoder_lstm_fwd"] = {"cells": dec_dims, "err": err,
                                   "device_ms": queued_ms(
            lambda: cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims))}
        dallh = torch.randn(allh.shape, generator=gen, device=dev)
        err = compare_all(
            "l2.decoder_lstm_bwd",
            zip(("dgates", "dh0", "dc0"),
                cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                           dec_dims),
                cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc, dallh)),
            GRAD_RTOL, GRAD_ATOL)
        out["decoder_lstm_bwd"] = {"cells": dec_dims, "err": err,
                                   "device_ms": queued_ms(
            lambda: cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                               dec_dims))}
        # the encode, forward (eval and train) and backward
        err = compare_all(
            "l2.mfm_encode_fwd.eval", zip(
                ("h_last", "mem_last"),
                cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
                cuda_mfn.mfm_encode_plain(xp, weights, z_tot)))
        masks = cuda_mfn.make_dropout_masks(
            gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(wide))
        fwd_ref = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)
        err = max(err, compare_all(
            "l2.mfm_encode_fwd.train",
            zip(("h_last", "mem_last", "allh", "allc", "allmem", "res"),
                cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims),
                fwd_ref)), key=lambda e: e["max_abs_err"])
        out["mfm_encode_fwd"] = {
            "cells": h_dims, "mem": 400, "gamma": [256, 256], "err": err,
            "device_ms": queued_ms(lambda: cuda_mfn.mfm_encode_res(
                xp, masks, weights, z_tot, h_dims))}
        dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
        dmem = torch.randn((n, 400), generator=gen, device=dev)
        err = compare_all(
            "l2.mfm_encode_bwd",
            zip(("dxp", "deltas"),
                cuda_mfn._launch_bwd(xp, weights, *fwd_ref[2:], dh, dmem,
                                     z_tot, h_dims),
                cuda_mfn.mfm_encode_bwd_steps_plain(
                    xp, weights, *fwd_ref[2:], dh, dmem, z_tot)),
            GRAD_RTOL, GRAD_ATOL)
        out["mfm_encode_bwd"] = {
            "cells": h_dims, "mem": 400, "gamma": [256, 256], "err": err,
            "device_ms": queued_ms(lambda: cuda_mfn._launch_bwd(
                xp, weights, *fwd_ref[2:], dh, dmem, z_tot, h_dims))}
        # the fused encoder cells, forward (eval and train) and backward
        m_dims = [400, 24]
        H = sum(m_dims)
        block = torch.zeros((H, 4 * H), device=dev)
        o = 0
        for h in m_dims:
            block[o:o + h, cuda_lstm.cell_columns(H, o, h, dev)] = 1.0
            o += h
        wh = 0.1 * torch.randn((H, 4 * H), generator=gen, device=dev) * block
        mxp = torch.randn((t, n, 4 * H), generator=gen, device=dev)
        err = compare("l2.multi_lstm_fwd.eval",
                      cuda_lstm.multi_lstm_fwd(mxp, wh, m_dims),
                      cuda_lstm.multi_lstm_plain(mxp, wh))
        res = cuda_lstm.multi_lstm_plain(mxp, wh, with_res=True)
        err = max(err, compare_all(
            "l2.multi_lstm_fwd.train",
            zip(("h_last", "allh", "allc", "gates"),
                cuda_lstm.multi_lstm_fwd(mxp, wh, m_dims, with_res=True),
                res)), key=lambda e: e["max_abs_err"])
        out["multi_lstm_fwd"] = {"cells": m_dims, "err": err,
                                 "device_ms": queued_ms(
            lambda: cuda_lstm.multi_lstm_fwd(mxp, wh, m_dims,
                                             with_res=True))}
        mdh = torch.randn((n, H), generator=gen, device=dev)
        err = compare("l2.multi_lstm_bwd",
                      cuda_lstm.multi_lstm_bwd(res[3], wh, res[2], mdh,
                                               m_dims),
                      cuda_lstm.multi_lstm_bwd_plain(res[3], wh, res[2],
                                                     mdh),
                      GRAD_RTOL, GRAD_ATOL)
        out["multi_lstm_bwd"] = {"cells": m_dims, "err": err,
                                 "device_ms": queued_ms(
            lambda: cuda_lstm.multi_lstm_bwd(res[3], wh, res[2], mdh,
                                             m_dims))}
        torch.cuda.synchronize()
    for name, numbers in out.items():
        module = cuda_mfn if name.startswith("mfm") else cuda_lstm
        plan = module.CLUSTERS[name]
        numbers.update(plan=plan, l2_launches=module.L2_LAUNCHES.get(name, 0),
                       max_abs_err=numbers.pop("err")["max_abs_err"])
        if 0 not in (plan if isinstance(plan, tuple) else (plan,)) or \
                numbers["l2_launches"] < 1:
            raise AssertionError(f"{name} did not read its weights from L2 "
                                 f"past a cluster of 8: {numbers}")
    log({"phase": "weights_from_l2", "nvidia_smi": smi, "n": n, "t": t,
         **out})


def multi_lstm_phase(cfg, dev, smi):
    """Step 8: the fused encoder-cell kernels against their plain versions
    and beside the k per-cell cuDNN LSTMs, at both models' widths.
    Returns {model type: numbers}."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.ops import cuda_lstm

    t = cfg.seqlength
    out = {}
    for k, model_type in enumerate(("kl_ef", "missing")):
        params = mfm.MFM(cfg, seed=SEED + 10 + k, device=dev,
                         model_type=model_type).tree()
        gen = torch.Generator(device=dev).manual_seed(SEED + 12 + k)
        x_eval = torch.randn((t, N_SERVE, cfg.d_total), generator=gen,
                             device=dev)
        x_train = torch.randn((t, N_TRAIN, cfg.d_total), generator=gen,
                              device=dev)
        with torch.inference_mode():
            xp, wh, h_dims = mfm.multi_lstm_operands(params, x_eval, cfg,
                                                     model_type)
            h_last = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims)
            torch.cuda.synchronize()
            err_fwd = compare(f"multi_lstm_fwd.{model_type}.h_last",
                              h_last, cuda_lstm.multi_lstm_plain(xp, wh))
            fwd_ms = cuda_ms(lambda: cuda_lstm.multi_lstm_fwd(xp, wh,
                                                              h_dims), 50)
            fwd_dev_ms = queued_ms(lambda: cuda_lstm.multi_lstm_fwd(
                xp, wh, h_dims))
            fwd_plain_ms = cuda_ms(lambda: cuda_lstm.multi_lstm_plain(xp, wh),
                                   10)
            xp32, _, _ = mfm.multi_lstm_operands(params, x_train, cfg,
                                                 model_type)
            res = cuda_lstm.multi_lstm_fwd(xp32, wh, h_dims, with_res=True)
            res_ref = cuda_lstm.multi_lstm_plain(xp32, wh, with_res=True)
            torch.cuda.synchronize()
            err_train = compare_all(
                f"multi_lstm_fwd.{model_type}.train",
                zip(("h_last", "allh", "allc", "gates"), res, res_ref))
            train_ms = cuda_ms(lambda: cuda_lstm.multi_lstm_fwd(
                xp32, wh, h_dims, with_res=True), 50)
            _, _, allc, gates = res_ref  # the backward reads the plain ones
            dh = torch.randn((N_TRAIN, sum(h_dims)), generator=gen,
                             device=dev)
            dxp = cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims)
            dxp_ref = cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh)
            torch.cuda.synchronize()
            err_bwd = compare(f"multi_lstm_bwd.{model_type}.dxp", dxp,
                              dxp_ref, GRAD_RTOL, GRAD_ATOL)
            bwd_cluster = cuda_lstm.CLUSTERS["multi_lstm_bwd"]
            bwd_ms = cuda_ms(lambda: cuda_lstm.multi_lstm_bwd(
                gates, wh, allc, dh, h_dims), 50)
            bwd_dev_ms = queued_ms(lambda: cuda_lstm.multi_lstm_bwd(
                gates, wh, allc, dh, h_dims))
            bwd_plain_ms = cuda_ms(lambda: cuda_lstm.multi_lstm_bwd_plain(
                gates, wh, allc, dh), 10)

        # the yardstick, used nowhere in the port: the same cells as k
        # cuDNN LSTMs (input projection included), forward at n = 256,
        # backward at n = 32 as (forward + backward) - forward
        cells, xs = mfm.fused_cells(params, x_eval, cfg, model_type)
        xs = [xi.contiguous() for xi in xs]
        lstms = [torch.nn.LSTM(xi.shape[2], c["wh"].shape[0]).to(dev)
                 for c, xi in zip(cells, xs)]
        with torch.inference_mode():
            lib_fwd_ms = cuda_ms(lambda: [m(xi) for m, xi in zip(lstms, xs)],
                                 50)
        xs32 = [xi.detach().contiguous().requires_grad_() for xi in
                mfm.fused_cells(params, x_train, cfg, model_type)[1]]

        def lib_forward():
            return [m(xi)[1][0] for m, xi in zip(lstms, xs32)]

        def lib_both():
            hs = lib_forward()
            torch.autograd.backward(hs, [torch.ones_like(h) for h in hs])

        lib_bwd_ms = cuda_ms(lib_both, 50) - cuda_ms(lib_forward, 50)

        # products over the diagonal blocks only, none with the zero
        # state of step 0 (forward) or into it (backward)
        hh = 4 * sum(h * h for h in h_dims)
        wh_bytes = diag_bytes(h_dims)
        fwd_bound = bound(2 * (t - 1) * N_SERVE * hh,
                          nbytes(xp, h_last) + wh_bytes)
        train_bound = bound(2 * (t - 1) * N_TRAIN * hh,
                            nbytes(xp32, *res) + wh_bytes)
        bwd_bound = bound(2 * (t - 1) * N_TRAIN * hh,
                          nbytes(gates, allc, dh, dxp) + wh_bytes)
        out[model_type] = {
            "h_dims": h_dims, "H": sum(h_dims), "nvidia_smi": smi,
            "fwd": {"n": N_SERVE, "ms": fwd_ms, "device_ms": fwd_dev_ms,
                    "plain_ms": fwd_plain_ms,
                    "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                    "library_ms": lib_fwd_ms,
                    "max_abs_err": max(err_fwd["max_abs_err"],
                                       err_train["max_abs_err"])},
            "fwd_train": {"n": N_TRAIN, "ms": train_ms,
                          "bound_ms": train_bound[0],
                          "bound_by": train_bound[1]},
            "bwd": {"n": N_TRAIN, "ms": bwd_ms, "device_ms": bwd_dev_ms,
                    "plain_ms": bwd_plain_ms, "cluster": bwd_cluster,
                    "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                    "library_ms": lib_bwd_ms,
                    "max_abs_err": err_bwd["max_abs_err"]},
        }
        log({"phase": "multi_lstm", "model_type": model_type,
             **out[model_type]})
    return out


def variants_phase(cfg, dev, smi):
    """Steps 8 and 9; returns the kernels-line entries of the two fused
    encoder-cell kernels."""
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn
    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.train import TrainProgram, make_optimizer
    from factorized_tpu_torch.trainers import (train_beta_vae,
                                               train_mfm_missing)
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint
    from factorized_tpu_torch.utils.logging import RunLogger

    kernels = multi_lstm_phase(cfg, dev, smi)
    t, n = cfg.seqlength, N_TRAIN
    cfgs = {"kl_ef": cfg.replace(model_type="kl_ef"),
            "missing": cfg.replace(missing=1)}
    # the kernels each path runs
    runs = {"kl_ef": ("multi_lstm_fwd", "decoder_lstm_fwd"),
            "missing": ("mfm_encode_fwd", "multi_lstm_fwd",
                        "decoder_lstm_fwd")}
    trains = {"kl_ef": runs["kl_ef"] + ("multi_lstm_bwd", "decoder_lstm_bwd"),
              "missing": tuple(k for k in counters()
                               if k not in PROBE_KERNELS)}
    multi = {"multi_lstm_fwd": 0, "multi_lstm_bwd": 0}

    # ---- 9a. serve each model from a checkpoint
    rng = np.random.default_rng(SEED + 20)
    requests = [np.round(rng.normal(size=(k, t, cfg.d_total)), 3)
                .astype(np.float32) for k in (1, 3, 64, 256, 300)]
    for k, (model_type, mcfg) in enumerate(cfgs.items()):
        params = mfm.MFM(mcfg, seed=SEED + 21 + k, device="cpu",
                         model_type=model_type).tree()
        with tempfile.TemporaryDirectory() as ckpt:
            save_checkpoint(ckpt, params, config=mcfg.to_dict())
            predictor = Predictor.from_checkpoint(ckpt, model_type=model_type)
            reference = Predictor.from_checkpoint(ckpt, model_type=model_type,
                                                  device="cpu")
        (worst, batches), _, launches = counted(
            f"serve {model_type}", runs[model_type],
            lambda: serve_requests(predictor, reference, requests))
        multi["multi_lstm_fwd"] += launches["multi_lstm_fwd"]
        log({"phase": "serve", "model_type": model_type,
             "requests": len(requests), "batches_run": batches[0],
             "requests_served": batches[1], "max_abs_err_vs_cpu": worst,
             "launches": {k: launches[k] for k in runs[model_type]}})

    # ---- 9b. one train step's gradients of each, card against the CPU
    cpu = torch.Generator().manual_seed(SEED + 30)
    x = torch.randn((t, n, cfg.d_total), generator=cpu)
    y = torch.randn((n,), generator=cpu)
    sizes = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
             cfg.gamma2_shape)
    step_draws = {
        "kl_ef": {"zf_masks": zf_masks(cfg, n, cpu)},
        "missing": {
            "encode_masks": cuda_mfn.make_dropout_masks(cpu, t, n, sizes,
                                                        mfn_drops(cfg)),
            "mmd_noise": torch.randn(mfm.mmd_noise_shape(cfg, n),
                                     generator=cpu),
            "zf_masks": [zf_masks(cfg, n, cpu) for _ in range(4)]},
    }
    programs = {
        "kl_ef": TrainProgram(mfm.mfm_kl_ef_apply, cfgs["kl_ef"],
                              "beta_vae", stage=1),
        "missing": TrainProgram(mfm.mfm_missing_apply, cfgs["missing"],
                                "missing"),
    }
    for k, model_type in enumerate(cfgs):
        params = mfm.MFM(cfg, seed=SEED + 31 + k, device="cpu",
                         model_type=model_type).tree()
        grads_vs_cpu(f"train_step_grads_vs_cpu.{model_type}",
                     programs[model_type].loss_fn, params, x, y,
                     step_draws[model_type], dev)

    # ---- 9c. the training paths on the synthetic MOSI set
    data = mosi.get_data(t)
    train_fns = {"kl_ef": train_beta_vae, "missing": train_mfm_missing}
    for model_type, mcfg in cfgs.items():
        run, seconds, launches = counted(
            f"train {model_type}", trains[model_type],
            lambda: train_fns[model_type](
                *data, mcfg.replace(num_epochs=TRAIN_EPOCHS), seed=SEED,
                logger=RunLogger(echo=False), device=dev))
        for name in multi:
            multi[name] += launches[name]
        hist = run["history"]
        log({"phase": "train", "model_type": model_type,
             "epochs": TRAIN_EPOCHS, "seconds": seconds, "history": hist,
             "metrics": run["metrics"],
             "launches": {k: launches[k] for k in trains[model_type]}})
        first = [e["train_loss"] for e in hist if e.get("stage", 1) == 1]
        want = TRAIN_EPOCHS * (2 if model_type == "kl_ef" else 1)
        losses = [e["train_loss"] for e in hist]
        if len(hist) != want or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{model_type} did not train clean: {hist}")
        if not first[-1] < first[0]:
            raise AssertionError(f"{model_type} loss did not fall: {first}")
        scores = run["metrics"]
        flat = [v for m in scores.values()
                for v in (m.values() if isinstance(m, dict) else [m])]
        if not np.all(np.isfinite(flat)):
            raise AssertionError(f"non-finite test metrics {scores}")

    # ---- 9d. each model's train step, timed and profiled
    Xb = torch.from_numpy(np.ascontiguousarray(
        data[0][:19 * n].reshape(19, n, t, -1).transpose(0, 2, 1, 3))).to(dev)
    yb = torch.from_numpy(data[1][:19 * n].reshape(19, n)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    for model_type, program in programs.items():
        tree = mfm.MFM(cfg, seed=SEED, device=dev,
                       model_type=model_type).tree()
        opt = make_optimizer(tree, 1e-3)
        if model_type == "missing":
            # the four decodes stacked: one decoder launch each way a step
            _, _, step_launches = counted(
                "missing step", ("decoder_lstm_fwd", "decoder_lstm_bwd"),
                lambda: program.step(tree, opt, Xb[0], yb[0], gen, 1e-3))
            decoder = {k: step_launches[k] for k in ("decoder_lstm_fwd",
                                                     "decoder_lstm_bwd")}
            log({"phase": "missing_step_launches", **decoder})
            if decoder != {"decoder_lstm_fwd": 1, "decoder_lstm_bwd": 1}:
                raise AssertionError(f"a missing step launched the decoder "
                                     f"kernels {decoder} times, not once")
        step_ms = cuda_ms(lambda: program.step(tree, opt, Xb[0], yb[0], gen,
                                               1e-3), 30)
        prof = profile_steps(program, tree, opt, Xb[0], yb[0], gen)
        log({"phase": "train_times", "model_type": model_type, "batch": n,
             "loss": ("beta_vae stage 1" if model_type == "kl_ef"
                      else "missing"),
             "nvidia_smi": smi, "step_ms": step_ms,
             "steps_per_s": 1e3 / step_ms, **prof})

    def entry(name, source, replaces, numbers):
        return {"name": name, "route": "cuda",
                "source": f"factorized_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": multi[name],
                "max_abs_err": max(kernels[m][numbers]["max_abs_err"]
                                   for m in kernels),
                **{key: kernels["kl_ef"][numbers][key] for key in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}

    return [
        entry("multi_lstm_fwd", "lstm_fwd.cu",
              "factorized_tpu/ops/pallas_lstm.py:88", "fwd"),
        entry("multi_lstm_bwd", "lstm_bwd.cu",
              "factorized_tpu/ops/pallas_lstm.py:116", "bwd"),
    ]


def probe_phase(cfg, dev, smi):
    """Step 10; returns the kernels-line entries of the three probe
    variants."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn
    from factorized_tpu_torch.probes import (bwd_residual_probe,
                                             twostep_bwd_probe)

    t, n = cfg.seqlength, N_TRAIN
    params = mfm.MFM(cfg, seed=SEED + 50, device=dev).tree()
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    x = torch.randn((t, n, cfg.d_total), generator=gen, device=dev)
    names = ("h_last", "mem_last", "allh", "allc", "allmem",
             *cuda_mfn.RES_NAMES)

    def flat(outs):
        return (*outs[:5], *outs[5])

    # ---- 10a. each variant against its plain version, n = 32
    with torch.inference_mode():
        (xp, weights, z_tot, h_dims), _ = mfm.kernel_operands(params, x, cfg)
        masks = cuda_mfn.make_dropout_masks(
            gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(cfg))
        split = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims,
                                        "split")
        split_ref = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot,
                                                  "split")
        torch.cuda.synchronize()
        err = {"split": compare_all("mfm_encode_fwd.split",
                                    zip(names, flat(split), flat(split_ref)))}
        # the backward kernels read the plain residuals, in both layouts
        res_split = split_ref[2:]
        res_cat = (*split_ref[2:5], torch.cat(split_ref[5], dim=2))
        dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
        dmem = torch.randn((n, weights["a2w2"].shape[1]), generator=gen,
                           device=dev)
        runs = {"stream": res_cat, "recompute_att": res_split,
                "two_step": res_cat, "stream_split": res_split}
        plains = {
            "stream": cuda_mfn.mfm_encode_bwd_steps_plain,
            "recompute_att": functools.partial(
                cuda_mfn.mfm_encode_bwd_steps_plain, recompute_att=True),
            "two_step": cuda_mfn.mfm_encode_bwd_two_step_plain,
            "stream_split": cuda_mfn.mfm_encode_bwd_steps_plain}

        def kernel(run):
            return cuda_mfn._launch_bwd(xp, weights, *runs[run], dh, dmem,
                                        z_tot, h_dims,
                                        run.replace("_split", ""))

        for run in runs:
            got = kernel(run)
            want = plains[run](xp, weights, *runs[run], dh, dmem, z_tot)
            torch.cuda.synchronize()
            err[run] = compare_all(f"mfm_encode_bwd.{run}",
                                   zip(("dxp", "deltas"), got, want),
                                   GRAD_RTOL, GRAD_ATOL)
        dxp, deltas = got

        # ---- 10b. times: each variant beside the training path's kernel,
        #      in turns (the training path's first and last)
        order = ("stream", "recompute_att", "two_step", "stream_split",
                 "stream")
        ms, dev_ms = {}, {}
        for run in order:
            ms.setdefault(run, []).append(cuda_ms(lambda: kernel(run), 50))
            dev_ms.setdefault(run, []).append(queued_ms(lambda: kernel(run)))

        def fwd(layout):
            return cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims,
                                           layout)

        fwd_ms = {layout: cuda_ms(lambda: fwd(layout), 50)
                  for layout in ("cat", "split")}
        fwd_dev_ms = {layout: queued_ms(lambda: fwd(layout))
                      for layout in ("cat", "split")}
        plain_ms = {
            "split": cuda_ms(lambda: cuda_mfn.mfm_encode_res_plain(
                xp, masks, weights, z_tot, "split"), 10),
            **{run: cuda_ms(lambda: plains[run](
                xp, weights, *runs[run], dh, dmem, z_tot), 10)
               for run in ("recompute_att", "two_step")}}

    # bounds from this run's shapes, as for the training kernels; the
    # recompute adds the logits product (2 t n s1 M2 FLOPs) and reads r1
    # where the others read att
    s1, s2, s3, s4, mem = cuda_mfn.sizes(weights)
    m2 = 2 * (sum(h_dims) - z_tot)
    rows = t * n
    recur = 4 * sum(h * h for h in h_dims)
    fwd_bound = bound(
        2 * (rows * encode_macs_per_row(weights, h_dims, z_tot) - n * recur),
        nbytes(xp, masks, *off_diag(weights), *flat(split))
        + diag_bytes(h_dims))
    bwd_macs = ((t - 1) * n * 2 * recur
                + rows * ((s3 + s4) * mem + s2 * mem + (m2 + mem) * (s3 + s4)
                          + m2 * s2 + 2 * s1 * m2))
    used = ("a1w1", "a1w2", "a2w1", "a2w2", "gw1", "g1w2", "g2w2")
    bwd_bytes = (nbytes(xp, *res_cat[:3], dh, dmem,
                        *[weights[k] for k in used], dxp, deltas)
                 + diag_bytes(h_dims))
    fields = dict(zip(cuda_mfn.RES_NAMES, res_split[3]))
    bounds = {
        "two_step": bound(2 * bwd_macs,
                          bwd_bytes + nbytes(*fields.values())),
        "recompute_att": bound(
            2 * (bwd_macs + rows * s1 * m2),
            bwd_bytes + nbytes(weights["a1b2"], *[
                v for k, v in fields.items() if k != "att"]))}

    # ---- 10c. the probe path: both entry points, repetitions cut
    kernels = PROBE_KERNELS + ("mfm_encode_fwd", "mfm_encode_bwd",
                               "mfm_encode_dw")
    (residual, twostep), seconds, launches = counted(
        "probes", kernels, lambda: (
            bwd_residual_probe.main(["--iters", "5", "--groups", "2"]),
            twostep_bwd_probe.main(["--groups", "2", "--epochs", "2"])))
    if not twostep["tracked_loss_match"]:
        raise AssertionError(f"two-step losses differ: {twostep}")
    for name, diff in residual["max_grad_diff"].items():
        if not diff < 1e-3:
            raise AssertionError(f"{name} grads off the plain ones: {diff}")
    if not np.all(np.isfinite([v for v in residual.values()
                               if isinstance(v, float)])):
        raise AssertionError(f"non-finite probe times {residual}")
    log({"phase": "probes", "batch": n, "nvidia_smi": smi,
         "seconds": seconds, "launches": {k: launches[k] for k in kernels},
         "bwd_ms": ms, "bwd_device_ms": dev_ms, "fwd_ms": fwd_ms,
         "fwd_device_ms": fwd_dev_ms, "plain_ms": plain_ms,
         "bwd_residual_probe": residual, "twostep_bwd_probe": twostep})

    def entry(name, source, replaces, e, time_ms, dev, plain, bnd):
        return {"name": name, "route": "cuda",
                "source": f"factorized_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": e["max_abs_err"], "ms": time_ms,
                "device_ms": dev, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    return [
        entry("mfm_encode_fwd_split", "mfm_encode_fwd.cu",
              "scripts/bwd_residual_probe.py:81", err["split"],
              fwd_ms["split"], fwd_dev_ms["split"], plain_ms["split"],
              fwd_bound),
        entry("mfm_encode_bwd_recompute_att", "mfm_encode_bwd.cu",
              "scripts/bwd_residual_probe.py:151", err["recompute_att"],
              ms["recompute_att"][0], dev_ms["recompute_att"][0],
              plain_ms["recompute_att"], bounds["recompute_att"]),
        entry("mfm_encode_bwd_two_step", "mfm_encode_bwd.cu",
              "scripts/twostep_bwd_probe.py:139", err["two_step"],
              ms["two_step"][0], dev_ms["two_step"][0], plain_ms["two_step"],
              bounds["two_step"]),
    ]


def profile_steps(program, tree, opt, x, y, gen, steps=10):
    """torch.profiler over train steps: launches per step, device time,
    and the share of the wall in which the device was idle."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        program.step(tree, opt, x, y, gen, 1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            program.step(tree, opt, x, y, gen, 1e-3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if on_device(e)]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    return {"profiled_steps": steps,
            "profiled_wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "top": [{"name": e.key[:60], "count_per_step": e.count / steps,
                     "ms_per_step": e.device_time_total / 1e3 / steps}
                    for e in top]}


if __name__ == "__main__":
    sys.exit(main())
