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
4. serves ``mfm``, ``kl``, ``kl_ef`` and ``missing`` from checkpoints of
   seeded random weights through the ``Predictor``'s CUDA graphs of the
   y_hat-only forward at B = 256: requests of 1 to 300 samples over HTTP
   with micro-batching, some concurrent, every reply against the CPU
   ``Predictor``; checks that the path launched its kernel (the eval
   encode, or ``multi_lstm_fwd`` for ``kl_ef``) once a padded chunk and
   no decoder; per model the padded 256-row predict's median ms through
   the graph, through the y_hat forward eagerly and through the whole
   eval forward eagerly (the port's predict before the y_hat forward),
   in turns, ``device_latency``, the capture's ms and pool bytes, and
   ``export`` with ``ExportedPredictor`` replying as the Predictor; for
   ``mfm`` also ``autotune`` over its candidates, ``serve --exported``
   over HTTP in a process of its own, and ``test_mosi`` on a checkpoint
   against the CPU's score;
5. times each kernel and its plain version with CUDA events over
   back-to-back calls (``ms``: a call's time, the host's included), each
   kernel also with its calls queued behind a sleeping kernel
   (``device_ms``: the card's time alone, which a host-bound wrapper
   hides from ``ms``); the decoder forward, which serving no longer
   runs, at n = 256 for the record (its kernels-line entry is step 7's,
   at n = 32);
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
   ``trainers.train_mfm`` (the chunked loop: the second epoch a graph
   replay), checks finite, falling train loss and that the run launched
   every kernel, then times an eager train step, an epoch, the training
   kernels and their plain versions, and profiles the step;
8. holds the fused encoder-cell kernels (``multi_lstm_fwd``, eval at
   n = 256 and train at n = 32, and ``multi_lstm_bwd`` at n = 32) against
   their plain versions at the widths of ``kl_ef`` and ``missing``, and
   times them beside the k per-cell ``torch.nn.LSTM`` (cuDNN) calls over
   the same cells, as the decoder kernels are timed beside one
   ``torch.nn.LSTM`` per decoder cell;
9. one train step's gradients of ``kl_ef`` and ``missing`` on the
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
12. the chunked training loop (``trainers._loop``, on the card one CUDA
    graph replay an epoch after the first): ``mfm``, ``kl_ef`` (both
    stages) and ``missing`` train 2 epochs (``kl_ef`` 2 a stage) on the
    synthetic MOSI set at batch 32 through the graph loop and through
    the host loop (``FACTORIZED_TPU_HOST_LOOP=1``) from one seed: equal
    histories, best and final parameters, Adam's and the scheduler's
    state bit for bit, and each kernel's launches equal epoch for epoch;
    a forced divergence (lr 1e18) truncates both at the same epoch with
    the same live parameters; two replays of a graph draw different
    masks, each the eager draw from the same seed, and a replayed epoch
    consumes the generator as an eager one; per model the epoch s, step
    ms and device idle share, eager and replayed, the capture's ms and
    the graph pool's bytes;
13. the ablations ``m_a``..``m_d`` at full width: each kernel at the
    shapes each one gives it against its plain version, timed beside its
    bound and library yardstick (the encode with one encoder cell over
    the whole input, z_tot 32, or none, z_tot 0, eval at n = 256 and
    train, reverse pass and weight gradients at n = 32; the encoder trio
    [32, 8, 80]; the decoder trios [104] * 3, [88, 8, 8] and [16] * 3);
    one train step's gradients on the card against the CPU's with the
    same injected draws; 2 epochs through ``trainers.train_mfm_ablation``
    (the second a graph replay), every kernel of the path launched; the
    trained parameters served from a checkpoint over HTTP against the CPU
    ``Predictor``, one launch of the serving kernel a padded chunk, the
    padded 256-row predict's ms and ``device_latency``;
14. ``--zeros 1``: ``trainers.train_mfm_test_zeros`` for 2 epochs, its
    three scores against the CPU's ``YHat`` on the same parameters;
15. the released checkpoints ``factorized_tpu_torch/released/mfn_mae``
    and ``mfn_acc``: ``test_mosi`` on the card scores as the CPU
    ``Predictor`` does, within 1e-5, and ``serve`` replies as the CPU;
16. the chains past the width at which a block's per-row state alone
    passed its shared memory (a launch refused before this plan): each
    chain just past it against its plain version (a 600-unit cell in the
    eval encode and ``multi_lstm_fwd``'s eval at n = 256, 1,400 in the
    encode backward, 1,700 in ``multi_lstm_bwd``, 2,200 in the 2-row
    forward chains, 3,000 in the decoder backward, at n = 32; the memory
    chain at mem 7,400), each with the plan it took (its state in device
    memory, ``cuda_lstm.SCRATCH``), device ms, events ms, bound, plain ms
    and the recurrences' per-cell ``nn.LSTM`` yardstick (``c1`` lines);
    then ``mosi --config`` with a JSON that makes an MFN cell of 1,400, an
    encoder cell of 600 and a decoder cell of 3,000, 2 epochs: a finite,
    falling loss and every kernel of the path launched (``c1_train``);
17. the ``mosi`` command's surface: ``--mode search --trials 3`` for
    ``mfm`` and ``kl_ef`` against the CPU's draws, ``--save-ckpt`` then
    ``--resume`` (the restored state bit for bit, the epochs and lr
    going on) with ``--ckpt-every 1``, and ``--data-root`` on a
    fabricated MOSI root with ``--feature-selection`` 1 and 0 (``cli``);
18. the missing-modality baselines and the other datasets: ``s2s`` and
    ``bm`` (``--missing 1``) at full width, one train step's gradients on
    the card against the CPU's with the same injected draws, 2 epochs
    through ``trainers.train_seq2seq`` and ``train_basic_missing`` (the
    second a graph replay), finite falling losses, ``multi_lstm_fwd`` and
    ``multi_lstm_bwd`` launched (their three encoders, inputs of 305, 320
    and 25 floats) and for ``s2s`` the decoder kernels (cells [88, 8,
    8]); then ``moud``, ``you``, ``mmmo`` and ``mosi_acc --mode best
    --epochs 2`` through the command on their synthetic sets (``you``
    with a remainder batch of 20 rows in its epoch graph), finite falling
    losses, MFM's encode and decoder kernels launched, a score block
    printed; each path's device ms and launches a step and replayed
    epoch s (``baseline`` and ``dataset_command`` lines);
19. prints one JSON line on the ten kernels, the ``nvidia-smi`` line,
    and last ``{"ok": true, "device": {...}}``; a ``seconds`` line after
    each of steps 4, 6, 8, 10, 11, 12, 13, 14, 15, 16, 17 and 18.

Any failure raises and exits non-zero; without a CUDA card it exits 1.
"""

import contextlib
import functools
import io
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
# epochs of each model in the training-loop phase (kl_ef: a stage): the
# first eager, the second a capture and its replay
LOOP_EPOCHS = 2
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
        module.SCRATCH_LAUNCHES.clear()
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


def split_rows(y, requests):
    """``y`` of the requests' rows concatenated, split back by request."""
    return np.split(y, np.cumsum([len(r) for r in requests])[:-1])


def serve_requests(predictor, expected, requests):
    """Serves ``requests`` over HTTP with micro-batching (the first two
    alone, the rest concurrently) and checks every reply against the CPU
    ``expected``. Returns (worst abs error, (batches run, requests
    served))."""
    from factorized_tpu_torch.serve import make_server

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


# the serving phase's models, and the kernel each one's y_hat forward
# launches (once a chunk); the decoders and the other recurrence never
SERVE_MODELS = {"mfm": "mfm_encode_fwd", "kl": "mfm_encode_fwd",
                "kl_ef": "multi_lstm_fwd", "missing": "mfm_encode_fwd"}
SERVE_IDLE = ("decoder_lstm_fwd", "mfm_encode_fwd", "multi_lstm_fwd")


def serve_config(cfg, model_type):
    """The checkpoint config of a served model: ``missing`` is an ``mfm``
    config with ``missing`` 1, as ``--missing 1`` writes it."""
    if model_type == "missing":
        return cfg.replace(missing=1)
    return cfg.replace(model_type=model_type)


def median_ms(fn, reps=20):
    """Median host milliseconds of fn() after one warm-up call (fn ends on
    the host, so the card's work is inside)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def eager_predict(apply_fn, params, cfg, X, dev):
    """The padded predict of the port before its serving forward, for the
    comparison only: the whole eval forward, eagerly on the card (the
    packing per call, the MMD draw, the three decoders), ``y_hat =
    decoded[3]``, a host copy each way."""
    x = torch.from_numpy(np.ascontiguousarray(X.swapaxes(0, 1))).to(dev)
    with torch.inference_mode():
        out = apply_fn(params, x, cfg, train=False,
                       generator=torch.Generator(device=dev).manual_seed(0))
    return out[0][3].cpu().numpy()


def yhat_eager(predictor, X, dev):
    """The serving forward eagerly on the card, without its graph: a host
    copy each way."""
    x = torch.from_numpy(X).to(dev).transpose(0, 1)
    with torch.no_grad():
        return predictor.forward(x).cpu().numpy()


def serving_phase(cfg, dev, smi):
    """Step 4: every model of ``SERVE_MODELS`` served from a checkpoint of
    seeded random weights through its CUDA graphs at B = 256: requests of
    1 to 300 rows over HTTP with micro-batching, each reply against the
    CPU ``Predictor``; the path launches its kernel and no other
    (``SERVE_IDLE``); launches of one padded predict; the padded 256-row
    predict's median ms through the graph, the serving forward eager and
    the whole eval forward eager (the port's predict before the serving
    forward), in turns; ``device_latency``; the graph's capture ms and pool
    bytes; ``export`` and ``ExportedPredictor`` replying as the
    Predictor. Then, for ``mfm``: ``autotune`` over its candidates,
    ``serve --exported`` over HTTP in a process of its own, and
    ``test_mosi`` on a checkpoint. Returns {model: the serving path's
    launches}."""
    from factorized_tpu_torch.models import get_model, mfm
    from factorized_tpu_torch.serve import ExportedPredictor, Predictor
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    t, d = cfg.seqlength, cfg.d_total
    rng = np.random.default_rng(SEED)
    X = np.round(rng.normal(size=(N_SERVE, t, d)), 3).astype(np.float32)
    served, extras = {}, {}
    for k, (model_type, kernel) in enumerate(SERVE_MODELS.items()):
        # mfm takes every size of REQUEST_SIZES, the others 1 to 300 rows
        sizes = REQUEST_SIZES if k == 0 else (1, 3, 64, 256, 300)
        requests = [np.round(rng.normal(size=(r, t, d)), 3)
                    .astype(np.float32) for r in sizes]
        seconds = {}
        t0 = time.perf_counter()
        mcfg = serve_config(cfg, model_type)
        params = mfm.MFM(mcfg, seed=SEED + 60 + k, device="cpu",
                         model_type=model_type).tree()
        with tempfile.TemporaryDirectory() as ckpt:
            save_checkpoint(ckpt, params, config=mcfg.to_dict())
            predictor = Predictor.from_checkpoint(ckpt, model_type=model_type)
            reference = Predictor.from_checkpoint(ckpt, model_type=model_type,
                                                  device="cpu")
        seconds["construct"] = time.perf_counter() - t0
        expected = split_rows(reference.predict(np.concatenate(requests)),
                              requests)
        seconds["cpu_reference"] = time.perf_counter() - t0 - sum(
            seconds.values())
        (worst, batches), seconds["http"], launches = counted(
            f"serve {model_type}", (kernel,),
            lambda: serve_requests(predictor, expected, requests))
        t0 = time.perf_counter()
        idle = {name: launches[name] for name in SERVE_IDLE
                if name != kernel and launches[name]}
        if idle:
            raise AssertionError(f"serving {model_type} launched {idle}")
        served[model_type] = launches
        y, _, per_predict = counted(f"predict {model_type}", (kernel,),
                                    lambda: predictor.predict(X))
        per_predict = {name: per_predict[name] for name in SERVE_IDLE}
        if per_predict[kernel] != 1:
            raise AssertionError(f"one padded predict of {model_type} "
                                 f"launched {per_predict}")
        y_cpu = reference.predict(X)
        err = compare(f"serve.{model_type}.predict", torch.from_numpy(y),
                      torch.from_numpy(y_cpu))
        # the three ways to the same y_hat, timed in turns in one process
        apply_fn = get_model(model_type)[1]
        full = device_tree(params, dev)
        compare(f"serve.{model_type}.eager_forward",
                torch.from_numpy(eager_predict(apply_fn, full, mcfg, X, dev)
                                 [:, 0]), torch.from_numpy(y_cpu))
        compare(f"serve.{model_type}.yhat_eager",
                torch.from_numpy(yhat_eager(predictor, X, dev)),
                torch.from_numpy(y_cpu))
        times = {"graph": [], "yhat_eager": [], "eager_forward": []}
        for _ in range(2):
            times["graph"].append(median_ms(lambda: predictor.predict(X)))
            times["yhat_eager"].append(median_ms(
                lambda: yhat_eager(predictor, X, dev)))
            times["eager_forward"].append(median_ms(
                lambda: eager_predict(apply_fn, full, mcfg, X, dev)))
        latency = predictor.device_latency(X, iters=100)
        seconds["timing"] = time.perf_counter() - t0
        # export and the artifact's predictor, replies as the Predictor's
        with tempfile.TemporaryDirectory() as art:
            t0 = time.perf_counter()
            predictor.export(art)
            seconds["export"] = time.perf_counter() - t0
            exported = ExportedPredictor(art)
            err_exported = compare(
                f"serve.{model_type}.exported",
                torch.from_numpy(exported.predict(requests[-1])),
                torch.from_numpy(predictor.predict(requests[-1])))
            if model_type == "mfm":
                extras["serve_exported"] = serve_exported(
                    art, requests[:6], expected[:6])
        log({"phase": "serve", "model_type": model_type, "nvidia_smi": smi,
             "requests": len(requests), "samples": int(sum(sizes)),
             "batches_run": batches[0], "requests_served": batches[1],
             "max_abs_err_vs_cpu": max(worst, err["max_abs_err"]),
             "launches": {name: launches[name] for name in SERVE_IDLE},
             "launches_per_padded_predict": per_predict,
             "batch": N_SERVE, "predict_ms": times,
             "samples_per_s": N_SERVE * 1e3 / float(np.median(
                 times["graph"])),
             "device_latency": latency,
             **predictor.graph_stats()[N_SERVE],
             "exported_max_abs_err": err_exported["max_abs_err"],
             "seconds": seconds})
        if model_type == "mfm":
            extras["autotune"] = autotune_check(predictor, requests[-3],
                                                expected[-3], rng)
            extras["test_mosi"] = test_mosi_check(params, mcfg, reference)
        del predictor, exported
    log({"phase": "serve_mfm_surfaces", "nvidia_smi": smi, **extras})
    return served


def device_tree(params, dev):
    """A tree's leaves detached, on ``dev``."""
    if isinstance(params, dict):
        return {k: device_tree(v, dev) for k, v in params.items()}
    return params.detach().to(dev)


def autotune_check(predictor, x, expected, rng):
    """``autotune`` over its candidates on 1024 rows: the rates, the
    winner, only the winner's graph kept, the reply to ``x`` still the
    CPU's ``expected``."""
    from factorized_tpu_torch.serve import CANDIDATES

    t, d = predictor.cfg.seqlength, sum(predictor.cfg.input_dims)
    X = np.round(rng.normal(size=(1024, t, d)), 3).astype(np.float32)
    t0 = time.perf_counter()
    rates = predictor.autotune(X)
    seconds = time.perf_counter() - t0
    if set(rates) != set(CANDIDATES) or \
            predictor.batch_size != max(rates, key=rates.get):
        raise AssertionError(f"autotune gave {rates}, batch "
                             f"{predictor.batch_size}")
    graphs = predictor.graph_stats()
    if set(graphs) != {predictor.batch_size}:
        raise AssertionError(f"autotune kept the graphs {sorted(graphs)}")
    err = compare("serve.autotune.predict",
                  torch.from_numpy(predictor.predict(x)),
                  torch.from_numpy(expected))
    return {"samples_per_s": rates, "batch_size": predictor.batch_size,
            "seconds": seconds, "graph": graphs[predictor.batch_size],
            "max_abs_err": err["max_abs_err"]}


def serve_exported(art, requests, expected):
    """``python -m factorized_tpu_torch serve --exported art`` in a process
    of its own on a free port: the requests over HTTP, each reply against
    the CPU's ``expected``; the process stopped after."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "factorized_tpu_torch", "serve", "--exported",
         art, "--port", str(port)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"serve --exported exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr.read()[-2000:]}")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        worst = 0.0
        for x, want in zip(requests, expected):
            y = post(port, x)
            np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL)
            worst = max(worst, float(np.abs(y - want).max()))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"up_s": up_s, "health": health, "requests": len(requests),
            "max_abs_err_vs_cpu": worst}


def test_mosi_check(params, cfg, reference):
    """``test_mosi`` on a checkpoint of ``params``: the score block, the
    probe and the on-device latency lines; its mae against the CPU
    ``reference``'s on the same (synthetic MOSI) test set."""
    import contextlib
    import io

    from factorized_tpu_torch import cli
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint
    from factorized_tpu_torch.utils.metrics import regression_metrics

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, params, config=cfg.to_dict())
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["test_mosi", "--checkpoint", ckpt])
        seconds = time.perf_counter() - t0
    lines = {}
    for line in out.getvalue().splitlines():
        key, _, value = line.partition(":")
        if key in ("mae", "inference probe", "on-device latency"):
            lines[key] = value.strip()
    if rc != 0 or set(lines) != {"mae", "inference probe",
                                 "on-device latency"}:
        raise AssertionError(f"test_mosi gave {rc}: {out.getvalue()[-2000:]}")
    _, _, _, _, X_test, y_test = cli.load_mosi(cfg.seqlength)
    want = regression_metrics(reference.predict(X_test), y_test)["mae"]
    mae = float(lines["mae"])
    if not abs(mae - want) <= ATOL + RTOL * abs(want):
        raise AssertionError(f"test_mosi mae {mae}, the CPU's {want}")
    return {"rc": rc, "seconds": seconds, "mae": mae, "cpu_mae": want,
            "probe": json.loads(lines["inference probe"]),
            "device_latency": json.loads(lines["on-device latency"])}


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
    from factorized_tpu_torch.ops import _build, cuda_lstm, cuda_mfn

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

    # ---- 4. serve every model through its CUDA graphs (serving_phase)
    t0 = time.perf_counter()
    served = serving_phase(cfg, dev, smi)
    log({"phase": "seconds", "step": 4, "seconds": time.perf_counter() - t0})

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
         "launches": sum(served[m]["mfm_encode_fwd"] for m in served),
         "max_abs_err": err_enc["max_abs_err"], "ms": enc_ms,
         "device_ms": enc_dev_ms, "plain_ms": enc_plain_ms,
         "bound_ms": enc_bound[0], "bound_by": enc_bound[1],
         "library_ms": None},
    ]
    # the decoder forward runs on the training path only since the
    # serving forward reads y_hat alone (its kernels-line entry is
    # train_phase's, at n = 32); at n = 256 for the record
    log({"phase": "decoder_lstm_fwd_n256", "nvidia_smi": smi, "n": n,
         "max_abs_err": err_dec["max_abs_err"], "ms": dec_ms,
         "device_ms": dec_dev_ms, "plain_ms": dec_plain_ms,
         "bound_ms": dec_bound[0], "bound_by": dec_bound[1],
         "library_ms": dec_library_ms})

    from factorized_tpu_torch.data import mosi

    data = mosi.get_data(cfg.seqlength)
    phases = {6: lambda: train_phase(cfg, dev, smi),
              8: lambda: variants_phase(cfg, dev, smi,
                                        served["kl_ef"]["multi_lstm_fwd"]),
              10: lambda: probe_phase(cfg, dev, smi),
              11: lambda: cluster_phase(cfg, dev, smi),
              12: lambda: loop_phase(cfg, dev, smi),
              13: lambda: ablation_phase(cfg, dev, smi, data),
              14: lambda: zeros_phase(cfg, dev, smi, data),
              15: lambda: released_phase(smi),
              16: lambda: (c1_phase(cfg, dev, smi),
                           c1_train_phase(cfg, smi, tmp)),
              17: lambda: cli_phase(smi, tmp),
              18: lambda: baseline_phase(cfg, dev, smi, data, tmp)}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for step, run in phases.items():
            t0 = time.perf_counter()
            results[step] = run()
            log({"phase": "seconds", "step": step,
                 "seconds": time.perf_counter() - t0})
    train_kernels, variant_kernels, probe_kernels = (results[6], results[8],
                                                     results[10])
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
    """Steps 6 and 7; returns the kernels-line entries of the decoder
    forward (at n = 32) and the three backward kernels."""
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
    step_ms = cuda_ms(lambda: program.step(tree, opt, Xb[0], yb[0], gen),
                      30)
    epoch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        program.run_epoch(tree, opt, Xb, yb, gen)
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
        # the decoder forward at the training batch, its main path since
        # serving reads y_hat alone
        def decf():
            return cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)

        err_decf = compare_all("decoder_lstm_fwd.n32",
                               zip(("allh", "allc", "gates"), decf(),
                                   (allh, allc, gates)))
        decf_ms, decf_dev_ms = cuda_ms(decf, 50), queued_ms(decf)
        decf_plain_ms = cuda_ms(lambda: cuda_lstm.decoder_lstm_plain(
            h0, c0, wsum, b, t), 10)
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
    decf_library_ms = decoder_library_ms(h0, c0, wsum, b, t, dec_dims)

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
        entry("decoder_lstm_fwd", "lstm_fwd.cu",
              "factorized_tpu/ops/pallas_lstm.py:272", err_decf, decf_ms,
              decf_dev_ms, decf_plain_ms, decf_bound, decf_library_ms),
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
    and beside the k per-cell cuDNN LSTMs, at both models' widths (the
    eval variant of ``kl_ef`` at its serving forward's one cell).
    Returns {model type: numbers}."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.predict import pack
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
        # the eval variant at the serving path's operands: kl_ef's
        # early-fusion cell alone (the y_hat forward's), missing's six
        # surrogate cells (no path serves them since the y_hat forward)
        with torch.inference_mode():
            if model_type == "kl_ef":
                ops, e_dims, _ = pack(params, cfg, model_type)
                e_cells, e_xs = [params["ef_encoder"]["lstm"]], [x_eval]
                e_xp = (x_eval.reshape(-1, cfg.d_total) @ ops["wx"]
                        + ops["bx"]).reshape(t, N_SERVE, -1)
                e_wh = ops["wh"]
            else:
                e_cells, e_xs = mfm.fused_cells(params, x_eval, cfg,
                                                model_type)
                e_xp, e_wh, e_dims = mfm.multi_lstm_operands(
                    params, x_eval, cfg, model_type)
            h_last = cuda_lstm.multi_lstm_fwd(e_xp, e_wh, e_dims)
            torch.cuda.synchronize()
            err_fwd = compare(f"multi_lstm_fwd.{model_type}.h_last",
                              h_last, cuda_lstm.multi_lstm_plain(e_xp, e_wh))
            fwd_ms = cuda_ms(lambda: cuda_lstm.multi_lstm_fwd(e_xp, e_wh,
                                                              e_dims), 50)
            fwd_dev_ms = queued_ms(lambda: cuda_lstm.multi_lstm_fwd(
                e_xp, e_wh, e_dims))
            fwd_plain_ms = cuda_ms(
                lambda: cuda_lstm.multi_lstm_plain(e_xp, e_wh), 10)
            xp32, wh, h_dims = mfm.multi_lstm_operands(params, x_train, cfg,
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
        # backward at n = 32
        lib_fwd_ms = cell_library_ms(e_cells, e_xs)
        lib_bwd_ms = cell_library_ms(*mfm.fused_cells(params, x_train, cfg,
                                                      model_type),
                                     backward=True)

        # products over the diagonal blocks only, none with the zero
        # state of step 0 (forward) or into it (backward)
        hh = 4 * sum(h * h for h in h_dims)
        wh_bytes = diag_bytes(h_dims)
        fwd_bound = bound(2 * (t - 1) * N_SERVE * 4 * sum(h * h
                                                          for h in e_dims),
                          nbytes(e_xp, h_last) + diag_bytes(e_dims))
        train_bound = bound(2 * (t - 1) * N_TRAIN * hh,
                            nbytes(xp32, *res) + wh_bytes)
        bwd_bound = bound(2 * (t - 1) * N_TRAIN * hh,
                          nbytes(gates, allc, dh, dxp) + wh_bytes)
        out[model_type] = {
            "h_dims": h_dims, "H": sum(h_dims), "nvidia_smi": smi,
            "fwd": {"n": N_SERVE, "h_dims": e_dims, "ms": fwd_ms,
                    "device_ms": fwd_dev_ms,
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


def variants_phase(cfg, dev, smi, serve_multi):
    """Steps 8 and 9; returns the kernels-line entries of the two fused
    encoder-cell kernels, ``multi_lstm_fwd``'s launches with the
    ``serve_multi`` of step 4's ``kl_ef`` serving path."""
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn
    from factorized_tpu_torch.train import TrainProgram, make_optimizer
    from factorized_tpu_torch.trainers import (train_beta_vae,
                                               train_mfm_missing)
    from factorized_tpu_torch.utils.logging import RunLogger

    kernels = multi_lstm_phase(cfg, dev, smi)
    t, n = cfg.seqlength, N_TRAIN
    cfgs = {"kl_ef": cfg.replace(model_type="kl_ef"),
            "missing": cfg.replace(missing=1)}
    # the kernels each training path runs
    trains = {"kl_ef": ("multi_lstm_fwd", "decoder_lstm_fwd",
                        "multi_lstm_bwd", "decoder_lstm_bwd"),
              "missing": tuple(k for k in counters()
                               if k not in PROBE_KERNELS)}
    multi = {"multi_lstm_fwd": serve_multi, "multi_lstm_bwd": 0}

    # ---- 9a. one train step's gradients of each, card against the CPU
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

    # ---- 9b. the training paths on the synthetic MOSI set
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

    # ---- 9c. each model's train step, timed and profiled
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
                lambda: program.step(tree, opt, Xb[0], yb[0], gen))
            decoder = {k: step_launches[k] for k in ("decoder_lstm_fwd",
                                                     "decoder_lstm_bwd")}
            log({"phase": "missing_step_launches", **decoder})
            if decoder != {"decoder_lstm_fwd": 1, "decoder_lstm_bwd": 1}:
                raise AssertionError(f"a missing step launched the decoder "
                                     f"kernels {decoder} times, not once")
        step_ms = cuda_ms(lambda: program.step(tree, opt, Xb[0], yb[0],
                                               gen), 30)
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
            bwd_residual_probe.main(["--iters", "3", "--groups", "1"]),
            twostep_bwd_probe.main(["--groups", "1", "--epochs", "1"])))
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


def per_kernel(delta):
    """An ``ops.counts.since`` delta by kernel name."""
    return {name: delta[key] for name, key in counters().items()}


def same_bits(a, b):
    """Equal bit for bit, NaN where NaN."""
    a, b = (np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v) for v in (a, b))
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def trainer_run(trainer, data, mcfg, dev, host, **kw):
    """One trainer run through the chunked loop (on the card, one graph
    replay an epoch after the first) or, ``host``, through the per-epoch
    host loop (``FACTORIZED_TPU_HOST_LOOP=1``), from the seed ``SEED``:
    (results, the run's ``_Setup``, each epoch's launches by kernel, the
    chunked loops it made). The host loop's epochs end at their eval."""
    import os

    from factorized_tpu_torch import train, trainers
    from factorized_tpu_torch.ops import counts
    from factorized_tpu_torch.utils.logging import RunLogger

    setups, loops, marks = [], [], []
    real = (trainers._Setup, trainers.ChunkedLoop,
            train.TrainProgram.evaluate)

    class Setup(real[0]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            setups.append(self)
            marks.append(counts.snapshot())

    class Loop(real[1]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            loops.append(self)

    def evaluate(self, *a):
        out = real[2](self, *a)
        marks.append(counts.snapshot())
        return out

    trainers._Setup, trainers.ChunkedLoop = Setup, Loop
    if host:
        train.TrainProgram.evaluate = evaluate
        os.environ["FACTORIZED_TPU_HOST_LOOP"] = "1"
    try:
        res = trainer(*data, mcfg, seed=SEED, logger=RunLogger(echo=False),
                      device=dev, **kw)
    finally:
        (trainers._Setup, trainers.ChunkedLoop,
         train.TrainProgram.evaluate) = real
        os.environ.pop("FACTORIZED_TPU_HOST_LOOP", None)
    if host:
        epochs = [counts.since(a, b) for a, b in zip(marks, marks[1:])]
    else:
        epochs = [e for loop in loops for e in loop.epoch_launches]
    return res, setups[0], [per_kernel(e) for e in epochs], loops


def loops_agree(label, host, graph):
    """The graph loop's run against the host loop's: history, best and
    final parameters, Adam's state and the scheduler's, bit for bit (the
    lr as float32).
    Returns {what: equal}; raises if any differs."""
    from factorized_tpu_torch.convert import to_state_dict

    (hres, hset, _, _), (gres, gset, _, _) = host, graph

    def trees(a, b):
        a, b = to_state_dict(a), to_state_dict(b)
        return list(a) == list(b) and all(same_bits(a[k], b[k]) for k in a)

    def same(k, a, b):
        # the host loop records the host scheduler's float, the graph loop
        # the float32 the step read (as the JAX package's two loops do)
        if k == "lr":
            return np.float32(a) == np.float32(b)
        return same_bits(a, b)

    def sched(s):
        return {**vars(s), "lr": np.float32(s.lr)}

    hh, gh = hres["history"], gres["history"]
    agree = {
        "history": len(hh) == len(gh) and all(
            a.keys() == b.keys() and all(same(k, a[k], b[k]) for k in a)
            for a, b in zip(hh, gh)),
        "best_params": trees(hres["params"], gres["params"]),
        "final_params": trees(hset.params, gset.params),
        "adam": all(same_bits(v, gset.optimizer.state_dict()["state"][k])
                    for k, v in hset.optimizer.state_dict()["state"].items()),
        "scheduler": sched(hset.scheduler) == sched(gset.scheduler),
    }
    if not all(agree.values()):
        diff = float((hset.optimizer.flat - gset.optimizer.flat).abs()
                     .nan_to_num(nan=float("inf")).max())
        log({"phase": "train_loop_mismatch", "model": label, **agree,
             "final_params_max_abs_diff": diff, "host": hh, "graph": gh})
        raise AssertionError(f"{label}: the graph loop and the host loop "
                             f"differ: {agree}")
    return agree


def loop_times(program, tree, opt, Xb, yb, Xv, yv, gen):
    """One model's eager and replayed times at its training batch: epoch s
    (host clock around an epoch and its eval, ended by a sync; replayed:
    one ``ChunkedLoop.run(1)``, its host read included), step ms (CUDA
    events over 30 eager steps and over 30 replays of one step's graph),
    the device's idle share and device ms (torch.profiler over 10 eager
    steps and over one replayed epoch; a replay's share also against the
    wall of the epochs timed without it), the epoch graph's capture ms and
    pool bytes, and the generator's offset over an eager and a replayed
    epoch (the draws the replay consumed)."""
    from torch.profiler import ProfilerActivity, profile

    from factorized_tpu_torch.train import ChunkedLoop, Graphed
    from factorized_tpu_torch.utils.checkpoint import BestKeeper
    from factorized_tpu_torch.utils.scheduler import ReduceLROnPlateau

    x, y = Xb[0], yb[0]
    nb = Xb.shape[0]
    opt.set_lr(1e-3)
    eager_step_ms = cuda_ms(lambda: program.step(tree, opt, x, y, gen), 30)
    prof = profile_steps(program, tree, opt, x, y, gen)

    def eager_epoch():
        program.train_epoch(tree, opt, Xb, yb, gen)
        program.evaluate(tree, Xv, yv, gen)

    eager_epoch_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_epoch()
        torch.cuda.synchronize()
        eager_epoch_s.append(time.perf_counter() - t0)
    step_graph = Graphed(lambda: program.step(tree, opt, x, y, gen), (gen,))
    replay_step_ms = cuda_ms(step_graph, 30)

    loop = ChunkedLoop(program, tree, opt, Xb, yb, None, Xv, yv, gen,
                       epochs=1)
    loop.load(ReduceLROnPlateau(1e-3), BestKeeper("min"))
    loop.run(1)  # the warm-up, eager
    loop.run(1)  # the capture, then its replay
    offsets = [gen.get_offset()]
    eager_epoch()
    torch.cuda.synchronize()
    offsets.append(gen.get_offset())
    loop.run(1)
    offsets.append(gen.get_offset())
    replay_epoch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        loop.run(1)
        replay_epoch_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        loop.run(1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in p.key_averages() if on_device(e)]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    eager = {"epoch_s": float(np.median(eager_epoch_s)),
             "step_ms": eager_step_ms,
             "device_idle_share": prof["device_idle_share"],
             "device_ms_per_step": prof["device_ms_per_step"],
             "launches_per_step": prof["kernel_launches_per_step"]}
    # the profiler's tracing of every kernel slows a replay: its wall
    # reads the idle share high, so the share is also taken against the
    # epoch's wall without it
    epoch_s = float(np.median(replay_epoch_s))
    replayed = {"epoch_s": epoch_s, "step_ms": replay_step_ms,
                "epoch_ms_per_step": epoch_s * 1e3 / nb,
                "device_ms_per_epoch": device_ms,
                "device_idle_share": 1.0 - device_ms / (epoch_s * 1e3),
                "device_idle_share_profiled_wall": 1.0 - device_ms / wall_ms,
                "kernels_seen_per_epoch": sum(e.count for e in kernels)}
    if not kernels:
        raise AssertionError("torch.profiler saw no kernel of a replay")
    return {"eager": eager, "replayed": replayed,
            "capture_ms": loop.epoch.capture_ms,
            "graph_pool_bytes": loop.epoch.pool_bytes,
            "step_capture_ms": step_graph.capture_ms,
            "step_graph_pool_bytes": step_graph.pool_bytes,
            "generator_offset_per_epoch": {
                "eager": offsets[1] - offsets[0],
                "replayed": offsets[2] - offsets[1]}}


def masks_phase(cfg, dev):
    """Two replays of a graph that draws the encode's dropout masks and
    the MMD noise draw different ones, each the draw an eager call makes
    from the same seed at that point."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn
    from factorized_tpu_torch.train import Graphed

    t, n = cfg.seqlength, N_TRAIN
    sizes = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
             cfg.gamma2_shape)

    def draw(gen):
        return torch.cat([
            cuda_mfn.make_dropout_masks(gen, t, n, sizes,
                                        mfn_drops(cfg)).reshape(-1),
            torch.randn(mfm.mmd_noise_shape(cfg, n), generator=gen,
                        device=dev).reshape(-1)])

    eager_gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    eager = [draw(eager_gen) for _ in range(3)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    out = torch.empty_like(eager[0])
    graph = Graphed(lambda: out.copy_(draw(gen)), (gen,))
    got = []
    for _ in range(3):  # eager warm-up, capture and replay, replay
        graph()
        got.append(out.clone())
    if torch.equal(got[1], got[2]):
        raise AssertionError("two replays drew the same masks")
    if not all(torch.equal(a, b) for a, b in zip(got, eager)):
        raise AssertionError("the replays' masks are not the eager draws")
    return {"replays_differ": True, "equal_eager_draws": True,
            "values_drawn": out.numel()}


def loop_phase(cfg, dev, smi):
    """Step 12: the chunked training loop. ``mfm``, ``kl_ef`` (both
    stages) and ``missing`` train on the synthetic MOSI set at batch 32
    through the graph loop and through the host loop from one seed: equal
    histories, best and final parameters, Adam's state, and each kernel's
    launches epoch for epoch; a forced divergence truncates both at the
    same epoch; two replays draw different masks; each model's epoch s,
    step ms and device idle share, eager and replayed, with the capture's
    ms and the graph pool's bytes."""
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.train import TrainProgram, make_optimizer

    t, n = cfg.seqlength, N_TRAIN
    data = mosi.get_data(t)
    runs = {
        "mfm": (trainers.train_mfm, cfg, LOOP_EPOCHS, mfm.mfm_apply,
                ("joint", 0),
                ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
                 "decoder_lstm_fwd", "decoder_lstm_bwd")),
        "kl_ef": (trainers.train_beta_vae, cfg.replace(model_type="kl_ef"),
                  LOOP_EPOCHS, mfm.mfm_kl_ef_apply, ("beta_vae", 1),
                  ("multi_lstm_fwd", "multi_lstm_bwd", "decoder_lstm_fwd",
                   "decoder_lstm_bwd")),
        "missing": (trainers.train_mfm_missing, cfg.replace(missing=1),
                    LOOP_EPOCHS, mfm.mfm_missing_apply, ("missing", 0),
                    ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
                     "multi_lstm_fwd", "multi_lstm_bwd", "decoder_lstm_fwd",
                     "decoder_lstm_bwd")),
    }
    Xb = torch.from_numpy(np.ascontiguousarray(
        data[0][:19 * n].reshape(19, n, t, -1).transpose(0, 2, 1, 3))).to(dev)
    yb = torch.from_numpy(data[1][:19 * n].reshape(19, n)).to(dev)
    Xv = torch.from_numpy(np.ascontiguousarray(
        data[2].transpose(1, 0, 2), dtype=np.float32)).to(dev)
    yv = torch.from_numpy(data[3].astype(np.float32)).to(dev)
    for model_type, (trainer, mcfg, epochs, apply_fn, (variant, stage),
                     kernels) in runs.items():
        mcfg = mcfg.replace(num_epochs=epochs)
        host = trainer_run(trainer, data, mcfg, dev, True)
        graph = trainer_run(trainer, data, mcfg, dev, False)
        agree = loops_agree(model_type, host, graph)
        if host[2] != graph[2]:
            raise AssertionError(f"{model_type}: launches per epoch differ: "
                                 f"host {host[2]}, graph {graph[2]}")
        for name in kernels:
            if sum(e[name] for e in graph[2]) < 1:
                raise AssertionError(f"{name} was not launched by the "
                                     f"{model_type} graph loop")
        hist = graph[0]["history"]
        if len(hist) != epochs * (2 if model_type == "kl_ef" else 1) or \
                not np.all(np.isfinite([e["train_loss"] for e in hist])):
            raise AssertionError(f"{model_type} did not train clean: {hist}")
        program = TrainProgram(apply_fn, mcfg, variant, stage=stage)
        tree = mfm.MFM(mcfg, seed=SEED, device=dev,
                       model_type=model_type).tree()
        opt = make_optimizer(tree, 1e-3)
        gen = torch.Generator(device=dev).manual_seed(SEED + 71)
        times = loop_times(program, tree, opt, Xb, yb, Xv, yv, gen)
        offsets = times["generator_offset_per_epoch"]
        if not offsets["eager"] == offsets["replayed"] > 0:
            raise AssertionError(f"{model_type}: a replayed epoch drew "
                                 f"otherwise than an eager one: {offsets}")
        log({"phase": "train_loop", "model_type": model_type,
             "nvidia_smi": smi, "batch": n, "epoch_batches": 19,
             "epochs": epochs, "bitwise": agree,
             "graphs": [loop.epoch.capture_ms is not None
                        for loop in graph[3]],
             "launches_per_epoch": graph[2],
             "history": hist, **times})

    # a forced divergence truncates both loops at the same epoch, the live
    # parameters equal (NaN where NaN)
    mcfg = cfg.replace(num_epochs=LOOP_EPOCHS)
    host = trainer_run(trainers.train_mfm, data, mcfg, dev, True, lr=1e18)
    graph = trainer_run(trainers.train_mfm, data, mcfg, dev, False, lr=1e18)
    agree = loops_agree("mfm diverging", host, graph)
    if not graph[0]["history"][-1].get("diverged"):
        raise AssertionError(f"lr 1e18 did not diverge: "
                             f"{graph[0]['history']}")
    log({"phase": "train_loop_divergence", "lr": 1e18, "bitwise": agree,
         "diverged_at": graph[0]["history"][-1]["epoch"],
         "launches_per_epoch": {"host": host[2], "graph": graph[2]}})
    log({"phase": "train_loop_masks", **masks_phase(cfg, dev)})


# the ablations: the kernels each one's training path launches, and the
# one its serving path launches once a padded chunk
ABLATION_TRAIN = {
    "m_a": ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
            "decoder_lstm_fwd", "decoder_lstm_bwd"),
    "m_b": ("multi_lstm_fwd", "multi_lstm_bwd", "decoder_lstm_fwd",
            "decoder_lstm_bwd"),
    "m_c": ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
            "decoder_lstm_fwd", "decoder_lstm_bwd"),
    "m_d": ("multi_lstm_fwd", "multi_lstm_bwd"),
}
ABLATION_SERVE = {"m_a": "mfm_encode_fwd", "m_b": "multi_lstm_fwd",
                  "m_c": "mfm_encode_fwd", "m_d": "multi_lstm_fwd"}
ABLATION_SIZES = (1, 3, 64, 256, 300)


def timed(fn, plain):
    """A kernel's ms (CUDA events over 50 back-to-back calls), device ms
    (50 calls queued behind a sleeping kernel) and its plain version's ms
    (CUDA events over 10 calls)."""
    return {"ms": cuda_ms(fn, 50), "device_ms": queued_ms(fn),
            "plain_ms": cuda_ms(plain, 10)}


def cell_library_ms(cells, xs, backward=False):
    """The yardstick of the fused encoder-cell kernels, used nowhere in the
    port: one ``torch.nn.LSTM`` (cuDNN) per cell over its input (the input
    projection included); forward ms, or with ``backward`` (forward +
    backward) - forward, the last hidden states' cotangent all ones."""
    dev = xs[0].device
    lstms = [torch.nn.LSTM(xi.shape[2], c["wh"].shape[0]).to(dev)
             for c, xi in zip(cells, xs)]
    # copies outside inference mode, which autograd can record
    xs = [xi.clone() for xi in xs]
    if not backward:
        with torch.inference_mode():
            return cuda_ms(lambda: [m(xi) for m, xi in zip(lstms, xs)], 50)
    xs = [xi.requires_grad_() for xi in xs]

    def forward():
        return [m(xi)[1][0] for m, xi in zip(lstms, xs)]

    def both():
        hs = forward()
        torch.autograd.backward(hs, [torch.ones_like(h) for h in hs])

    return cuda_ms(both, 50) - cuda_ms(forward, 50)


def ablation_kernels(model_type, cfg, params, dev, smi):
    """The kernels at the shapes ``model_type`` gives them, against their
    plain versions and timed beside their bounds and library yardsticks:
    the encode (m_a: one encoder cell over the whole input, z_tot 32;
    m_c: none, z_tot 0) eval at n = 256, train forward, reverse pass and
    weight gradients at n = 32; the encoder trio (m_b, m_d) eval at n =
    256, train forward and backward at n = 32; the decoder trio forward
    and backward at n = 32. Returns {kernel: numbers}."""
    from factorized_tpu_torch.models import ablations
    from factorized_tpu_torch.models.common import (mfn_drops,
                                                    split_modalities)
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    t = cfg.seqlength
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    out = {}

    library = {}  # each yardstick runs after the inference-mode block

    def record(name, n, err, times, bnd, library_ms=None, **extra):
        out[name] = {"n": n, "max_abs_err": err["max_abs_err"], **times,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": None, **extra}
        if library_ms is not None:
            library[name] = library_ms

    with torch.inference_mode():
        x256, x32 = (torch.randn((t, n, cfg.d_total), generator=gen,
                                 device=dev) for n in (N_SERVE, N_TRAIN))
        ops256 = ablations.kernel_operands(params, x256, cfg, model_type)
        ops32 = ablations.kernel_operands(params, x32, cfg, model_type)
        if "encode" in ops256:
            xp, weights, z_tot, h_dims = ops256["encode"]
            got = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
            err = compare_all(f"{model_type}.mfm_encode_fwd.eval", zip(
                ("h_last", "mem_last"), got,
                cuda_mfn.mfm_encode_plain(xp, weights, z_tot)))
            n = N_SERVE
            bnd = bound(2 * n * (t * encode_macs_per_row(weights, h_dims,
                                                         z_tot)
                                 - 4 * sum(h * h for h in h_dims)),
                        nbytes(xp, *off_diag(weights), *got)
                        + diag_bytes(h_dims))
            record("mfm_encode_fwd_eval", n, err, timed(
                lambda: cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
                lambda: cuda_mfn.mfm_encode_plain(xp, weights, z_tot)), bnd,
                h_dims=h_dims, z_tot=z_tot,
                clusters=list(cuda_mfn.CLUSTERS["mfm_encode_fwd"]))
            xp, weights, z_tot, h_dims = ops32["encode"]
            n = N_TRAIN
            masks = cuda_mfn.make_dropout_masks(
                gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(cfg))
            fwd = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
            fwd_ref = cuda_mfn.mfm_encode_res_plain(xp, masks, weights,
                                                    z_tot)
            err = compare_all(f"{model_type}.mfm_encode_fwd.train",
                              zip(("h_last", "mem_last", "allh", "allc",
                                   "allmem", "res"), fwd, fwd_ref))
            recur = 4 * sum(h * h for h in h_dims)
            bnd = bound(2 * (t * n * encode_macs_per_row(weights, h_dims,
                                                         z_tot) - n * recur),
                        nbytes(xp, masks, *off_diag(weights), *fwd)
                        + diag_bytes(h_dims))
            record("mfm_encode_fwd_train", n, err, timed(
                lambda: cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot,
                                                h_dims),
                lambda: cuda_mfn.mfm_encode_res_plain(xp, masks, weights,
                                                      z_tot)), bnd)
            res = fwd_ref[2:]
            dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
            dmem = torch.randn((n, cfg.memsize), generator=gen, device=dev)

            def bwd():
                return cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem,
                                            z_tot, h_dims)

            dxp, deltas = bwd()
            dxp_ref, deltas_ref = cuda_mfn.mfm_encode_bwd_steps_plain(
                xp, weights, *res, dh, dmem, z_tot)
            err = compare_all(f"{model_type}.mfm_encode_bwd",
                              [("dxp", dxp, dxp_ref),
                               ("deltas", deltas, deltas_ref)],
                              GRAD_RTOL, GRAD_ATOL)
            s1, s2, s3, s4, mem = cuda_mfn.sizes(weights)
            m2 = 2 * (sum(h_dims) - z_tot)
            bwd_macs = ((t - 1) * n * 2 * recur
                        + t * n * ((s3 + s4) * mem + s2 * mem
                                   + (m2 + mem) * (s3 + s4) + m2 * s2
                                   + 2 * s1 * m2))
            used = ("a1w1", "a1w2", "a2w1", "a2w2", "gw1", "g1w2", "g2w2")
            bnd = bound(2 * bwd_macs, nbytes(
                xp, *res, dh, dmem, *[weights[k] for k in used], dxp,
                deltas) + diag_bytes(h_dims))
            record("mfm_encode_bwd", n, err, timed(
                bwd, lambda: cuda_mfn.mfm_encode_bwd_steps_plain(
                    xp, weights, *res, dh, dmem, z_tot)), bnd,
                clusters=list(cuda_mfn.CLUSTERS["mfm_encode_bwd"]))

            def dw():
                return cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                           deltas_ref, z_tot)

            dw_out = dw()
            err = compare_all(f"{model_type}.mfm_encode_dw", [
                (k, dw_out[k], v) for k, v in cuda_mfn.mfm_encode_dw_plain(
                    res[1], res[2], res[3], deltas_ref, weights,
                    z_tot).items()], GRAD_RTOL, GRAD_ATOL)
            record("mfm_encode_dw", n, err, timed(
                dw, lambda: cuda_mfn.mfm_encode_dw_plain(
                    res[1], res[2], res[3], deltas_ref, weights, z_tot)),
                dw_bound_of(res, deltas_ref, dw_out),
                plan=dict(cuda_mfn.DW_PLAN))
        else:
            enc = params["enc"]
            cells = [enc[k]["lstm"] for k in
                     ("encoder_l", "encoder_a", "encoder_v")]
            xp, wh, h_dims = ops256["multi_lstm"]
            n = N_SERVE
            got = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims)
            err = compare(f"{model_type}.multi_lstm_fwd.eval", got,
                          cuda_lstm.multi_lstm_plain(xp, wh))
            hh = 4 * sum(h * h for h in h_dims)
            bnd = bound(2 * (t - 1) * n * hh,
                        nbytes(xp, got) + diag_bytes(h_dims))
            record("multi_lstm_fwd_eval", n, err, timed(
                lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims),
                lambda: cuda_lstm.multi_lstm_plain(xp, wh)), bnd,
                functools.partial(cell_library_ms, cells,
                                  split_modalities(x256, cfg.input_dims)),
                h_dims=h_dims, cluster=cuda_lstm.CLUSTERS["multi_lstm_fwd"])
            xp, wh, h_dims = ops32["multi_lstm"]
            n = N_TRAIN
            res = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims, with_res=True)
            res_ref = cuda_lstm.multi_lstm_plain(xp, wh, with_res=True)
            err = compare_all(f"{model_type}.multi_lstm_fwd.train",
                              zip(("h_last", "allh", "allc", "gates"), res,
                                  res_ref))
            bnd = bound(2 * (t - 1) * n * hh,
                        nbytes(xp, *res) + diag_bytes(h_dims))
            record("multi_lstm_fwd_train", n, err, timed(
                lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims, True),
                lambda: cuda_lstm.multi_lstm_plain(xp, wh, True)), bnd)
            _, _, allc, gates = res_ref
            dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
            dxp = cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims)
            err = compare(f"{model_type}.multi_lstm_bwd.dxp", dxp,
                          cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh),
                          GRAD_RTOL, GRAD_ATOL)
            bnd = bound(2 * (t - 1) * n * hh,
                        nbytes(gates, allc, dh, dxp) + diag_bytes(h_dims))
            record("multi_lstm_bwd", n, err, timed(
                lambda: cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims),
                lambda: cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh)),
                bnd, functools.partial(cell_library_ms, cells,
                                       split_modalities(x32, cfg.input_dims),
                                       backward=True),
                cluster=cuda_lstm.CLUSTERS["multi_lstm_bwd"])
        if "decoder" in ops32:
            h0, c0, wsum, b, dec_dims = ops32["decoder"]
            n = N_TRAIN
            outs = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)
            cluster = cuda_lstm.CLUSTERS["decoder_lstm_fwd"]
            allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b,
                                                             t)
            err = compare_all(f"{model_type}.decoder_lstm_fwd",
                              zip(("allh", "allc", "gates"), outs,
                                  (allh, allc, gates)))
            macs = (t - 1) * n * 4 * sum(h * h for h in dec_dims)
            bnd = bound(2 * macs, nbytes(h0, c0, b, *outs)
                        + diag_bytes(dec_dims))
            times = timed(
                lambda: cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t,
                                                   dec_dims),
                lambda: cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t))
            lib = functools.partial(decoder_library_ms, h0, c0, wsum, b, t,
                                    dec_dims)
            record("decoder_lstm_fwd", n, err, times, bnd, lib,
                   dec_dims=dec_dims, cluster=cluster)
            dallh = torch.randn(allh.shape, generator=gen, device=dev)
            dec = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                             dec_dims)
            err = compare_all(f"{model_type}.decoder_lstm_bwd",
                              zip(("dgates", "dh0", "dc0"), dec,
                                  cuda_lstm.decoder_lstm_bwd_plain(
                                      wsum, gates, allc, dallh)),
                              GRAD_RTOL, GRAD_ATOL)
            bnd = bound(2 * macs, nbytes(gates, allc, dallh, *dec)
                        + diag_bytes(dec_dims))
            times = timed(
                lambda: cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                                   dec_dims),
                lambda: cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc,
                                                         dallh))
            record("decoder_lstm_bwd", n, err, times, bnd,
                   functools.partial(decoder_library_ms, h0, c0, wsum, b, t,
                                     dec_dims, backward=True),
                   cluster=cuda_lstm.CLUSTERS["decoder_lstm_bwd"])
    torch.cuda.synchronize()
    for name, run in library.items():
        out[name]["library_ms"] = run()
    log({"phase": "ablation_kernels", "model_type": model_type,
         "nvidia_smi": smi, **out})
    return out


def ablation_draws(cfg, model_type, n, generator):
    """Every random draw of one train step of ``model_type``, on the CPU:
    the MFN's masks, the MMD samples, the z->f and y-head masks."""
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn

    t = cfg.seqlength

    def mask(f, rate):
        return ((torch.rand((n, f), generator=generator) >= rate).float()
                / (1.0 - rate))

    def noise(*dims):
        return [torch.randn((n, d), generator=generator) for d in dims]

    encode = cuda_mfn.make_dropout_masks(
        generator, t, n, (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
                          cfg.gamma2_shape), mfn_drops(cfg))
    y_mask = mask(cfg.fy_size, cfg.fy_to_y_dropout)
    trio = [mask(cfg.fl_size, cfg.zl_to_fl_dropout),
            mask(cfg.fa_size, cfg.za_to_fa_dropout),
            mask(cfg.fv_size, cfg.zv_to_fv_dropout)]
    return {
        "m_a": dict(encode_masks=encode,
                    mmd_noise=noise(cfg.zl_size, cfg.zy_size),
                    zf_masks=[mask(cfg.fy_size, cfg.zy_to_fy_dropout),
                              trio[0]], y_mask=y_mask),
        "m_b": dict(mmd_noise=noise(cfg.zl_size, cfg.za_size, cfg.zv_size),
                    zf_masks=trio, y_mask=y_mask),
        "m_c": dict(encode_masks=encode, mmd_noise=noise(cfg.zy_size),
                    zf_masks=[mask(cfg.fy_size, cfg.zy_to_fy_dropout)],
                    y_mask=y_mask),
        "m_d": dict(zf_masks=trio),
    }[model_type]


@contextlib.contextmanager
def chunked_loops():
    """Yields a list that gathers each ``train.ChunkedLoop`` the trainers
    build while the block runs."""
    from factorized_tpu_torch import trainers

    loops = []
    real = trainers.ChunkedLoop

    class Loop(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loops.append(self)

    trainers.ChunkedLoop = Loop
    try:
        yield loops
    finally:
        trainers.ChunkedLoop = real


def ablation_phase(cfg, dev, smi, data):
    """Step 13: each ablation at full width. Its kernels at its shapes
    against their plain versions (``ablation_kernels``); one train step's
    gradients on the card against the CPU's with the same injected draws;
    2 epochs of synthetic MOSI through ``trainers.train_mfm_ablation``
    (the chunked loop: the second epoch a graph replay), finite falling
    losses, every kernel of its path launched; then its trained
    parameters served from a checkpoint through the ``Predictor``'s graphs
    over HTTP, each reply against the CPU ``Predictor``, one launch of its
    serving kernel a padded chunk and no other recurrence, and the padded
    256-row predict's median ms, ``device_latency``, the capture's ms and
    pool bytes. Returns {model: {path: launches}, "kernels": ...}."""
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.models import get_model, mfm
    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.train import make_loss_fn
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint
    from factorized_tpu_torch.utils.logging import RunLogger

    t, d = cfg.seqlength, cfg.d_total
    rng = np.random.default_rng(SEED + 80)
    X = np.round(rng.normal(size=(N_SERVE, t, d)), 3).astype(np.float32)
    out = {}
    for k, model_type in enumerate(ABLATION_TRAIN):
        mcfg = cfg.replace(model_type=model_type)
        seconds = {}
        t0 = time.perf_counter()
        params = mfm.MFM(mcfg, seed=SEED + 90 + k, device=dev).tree()
        kernels = ablation_kernels(model_type, mcfg, params, dev, smi)
        seconds["kernels"] = time.perf_counter() - t0
        # one train step's gradients, card against the CPU
        cpu = torch.Generator().manual_seed(SEED + 100 + k)
        x = torch.randn((t, N_TRAIN, d), generator=cpu)
        y = torch.randn((N_TRAIN,), generator=cpu)
        t0 = time.perf_counter()
        grads = grads_vs_cpu(f"{model_type}.train_step_grads_vs_cpu",
                             make_loss_fn(get_model(model_type)[1], mcfg),
                             params, x, y,
                             ablation_draws(mcfg, model_type, N_TRAIN, cpu),
                             dev)
        seconds["grads_vs_cpu"] = time.perf_counter() - t0
        # the training path through the trainer
        with chunked_loops() as loops:
            run, seconds["train"], launches = counted(
                f"train {model_type}", ABLATION_TRAIN[model_type],
                lambda: trainers.train_mfm_ablation(
                    *data, mcfg.replace(num_epochs=TRAIN_EPOCHS), seed=SEED,
                    logger=RunLogger(echo=False), device=dev))
        losses = [e["train_loss"] for e in run["history"]]
        if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{model_type} did not train clean: "
                                 f"{run['history']}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{model_type} train loss did not fall: "
                                 f"{losses}")
        if not (len(loops) == 1 and loops[0].epoch.graph is not None):
            raise AssertionError(f"{model_type}: the second epoch was not "
                                 f"a graph replay")
        # serving its trained parameters
        requests = [np.round(rng.normal(size=(r, t, d)), 3)
                    .astype(np.float32) for r in ABLATION_SIZES]
        kernel = ABLATION_SERVE[model_type]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt:
            save_checkpoint(ckpt, run["params"], config=mcfg.to_dict())
            predictor = Predictor.from_checkpoint(ckpt)
            reference = Predictor.from_checkpoint(ckpt, device="cpu")
        expected = split_rows(reference.predict(np.concatenate(requests)),
                              requests)
        seconds["serve_setup"] = time.perf_counter() - t0
        (worst, batches), seconds["http"], served = counted(
            f"serve {model_type}", (kernel,),
            lambda: serve_requests(predictor, expected, requests))
        idle = {name: served[name] for name in SERVE_IDLE
                if name != kernel and served[name]}
        if idle:
            raise AssertionError(f"serving {model_type} launched {idle}")
        y, _, per_predict = counted(f"predict {model_type}", (kernel,),
                                    lambda: predictor.predict(X))
        per_predict = {name: per_predict[name] for name in SERVE_IDLE}
        if per_predict[kernel] != 1:
            raise AssertionError(f"one padded predict of {model_type} "
                                 f"launched {per_predict}")
        err = compare(f"serve.{model_type}.predict", torch.from_numpy(y),
                      torch.from_numpy(reference.predict(X)))
        out[model_type] = {
            "train": {k: launches[k] for k in ABLATION_TRAIN[model_type]},
            "serve": {kernel: served[kernel]}, "kernels": kernels}
        log({"phase": "ablation", "model_type": model_type,
             "nvidia_smi": smi, "history": run["history"],
             "metrics": run["metrics"], "train_launches": out[model_type][
                 "train"], "epoch_launches": [
                     per_kernel(e) for e in loops[0].epoch_launches],
             "capture_ms": loops[0].epoch.capture_ms,
             "graph_pool_bytes": loops[0].epoch.pool_bytes,
             "grads_max_abs_err": grads["max_abs_err"],
             "requests": len(requests), "batches_run": batches[0],
             "max_abs_err_vs_cpu": max(worst, err["max_abs_err"]),
             "serve_launches": {name: served[name] for name in SERVE_IDLE},
             "launches_per_padded_predict": per_predict,
             "predict_ms": median_ms(lambda: predictor.predict(X)),
             "device_latency": predictor.device_latency(X, iters=100),
             **predictor.graph_stats()[N_SERVE], "seconds": seconds})
        del predictor
    return out


def zeros_phase(cfg, dev, smi, data):
    """Step 14: ``--zeros 1``'s trainer (``train_mfm_test_zeros``) for 2
    epochs at full width on synthetic MOSI, every kernel of MFM's training
    path launched; its three scores, each with one modality's slice of the
    test set zeroed, against the CPU's ``YHat`` on the same parameters,
    within 1e-5."""
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.models.predict import YHat
    from factorized_tpu_torch.utils.checkpoint import to_cpu
    from factorized_tpu_torch.utils.logging import RunLogger
    from factorized_tpu_torch.utils.metrics import regression_metrics

    mcfg = cfg.replace(zeros=1, num_epochs=TRAIN_EPOCHS)
    run, seconds, launches = counted(
        "train zeros", ABLATION_TRAIN["m_a"],
        lambda: trainers.train_mfm_test_zeros(
            *data, mcfg, seed=SEED, logger=RunLogger(echo=False),
            device=dev))
    d_l, d_a, _ = cfg.input_dims
    forward = YHat(mcfg, to_cpu(run["params"]), "mfm")
    worst = 0.0
    for tag, (lo, hi) in (("y_hat_nol", (0, d_l)),
                          ("y_hat_noa", (d_l, d_l + d_a)),
                          ("y_hat_nov", (d_l + d_a, cfg.d_total))):
        X = np.ascontiguousarray(data[4].swapaxes(0, 1), dtype=np.float32)
        X[..., lo:hi] = 0.0
        with torch.no_grad():
            want = regression_metrics(forward(torch.from_numpy(X)).numpy(),
                                      data[5])
        got = run["metrics"][tag]
        for key, v in want.items():
            if not abs(got[key] - v) <= 1e-5:
                raise AssertionError(f"zeros {tag} {key}: the card's "
                                     f"{got[key]}, the CPU's {v}")
            worst = max(worst, abs(got[key] - v))
    log({"phase": "zeros", "nvidia_smi": smi, "seconds": seconds,
         "history": run["history"], "metrics": run["metrics"],
         "launches": {k: launches[k] for k in ABLATION_TRAIN["m_a"]},
         "max_abs_metric_diff_vs_cpu": worst})
    return {k: launches[k] for k in ABLATION_TRAIN["m_a"]}


def released_phase(smi):
    """Step 15: the released checkpoints ``factorized_tpu_torch/released/
    mfn_mae`` and ``mfn_acc``: ``test_mosi --checkpoint`` on the card, its
    printed score (``mfn_mae``: mae and binary accuracy; ``mfn_acc``:
    accuracy) against the CPU ``Predictor``'s on the same synthetic MOSI
    test set within 1e-5; and ``serve`` of each over HTTP, every reply
    against the CPU's. Returns {name: the encode's launches}."""
    import contextlib
    import io
    import os

    from factorized_tpu_torch import cli
    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.utils.metrics import (classification_metrics,
                                                    regression_metrics)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "factorized_tpu_torch", "released")
    _, _, _, _, X_test, y_test = cli.load_mosi(20)
    rng = np.random.default_rng(SEED + 110)
    out = {}
    for name in ("mfn_mae", "mfn_acc"):
        path = os.path.join(root, name)
        reference = Predictor.from_checkpoint(path, device="cpu")
        y_cpu = reference.predict(X_test)
        if reference.cfg.task == "regression":
            m = regression_metrics(y_cpu, y_test)
            want = {"mae": m["mae"], "Accuracy": m["binary_accuracy"]}
        else:
            m = classification_metrics(y_cpu, (y_test >= 0).astype(np.int64))
            want = {"Accuracy": m["accuracy"]}
        text = io.StringIO()

        def test_mosi():
            with contextlib.redirect_stdout(text):
                return cli.main(["test_mosi", "--checkpoint", path])

        rc, seconds, launches = counted(f"test_mosi {name}",
                                        ("mfm_encode_fwd",), test_mosi)
        got = {}
        for line in text.getvalue().splitlines():
            if line.startswith("mae:"):
                got["mae"] = float(line.split()[1])
            elif line.startswith("Accuracy "):
                got["Accuracy"] = float(line.split()[1])
        if rc != 0 or set(got) != set(want):
            raise AssertionError(f"test_mosi {name} gave {rc}: "
                                 f"{text.getvalue()[-2000:]}")
        for key, v in want.items():
            if not abs(got[key] - v) <= 1e-5:
                raise AssertionError(f"test_mosi {name} {key}: the card's "
                                     f"{got[key]}, the CPU's {v}")
        requests = [np.round(rng.normal(size=(r, 20, 325)), 3)
                    .astype(np.float32) for r in (1, 17, 256, 300)]
        expected = split_rows(reference.predict(np.concatenate(requests)),
                              requests)
        predictor = Predictor.from_checkpoint(path)
        (worst, batches), _, served = counted(
            f"serve {name}", ("mfm_encode_fwd",),
            lambda: serve_requests(predictor, expected, requests))
        out[name] = launches["mfm_encode_fwd"] + served["mfm_encode_fwd"]
        log({"phase": "released", "name": name, "nvidia_smi": smi,
             "test_mosi": got, "cpu": want, "seconds": seconds,
             "serve_max_abs_err_vs_cpu": worst, "batches_run": batches[0],
             "launches": {"test_mosi": launches["mfm_encode_fwd"],
                          "serve": served["mfm_encode_fwd"]}})
        del predictor
    return out


# Step 16: each chain just past the width at which its per-row state
# alone passed a block (and the launch was refused before the scratch
# plan): (label, kernel, cells, n)
C1_CHAINS = (
    ("encode_eval", "mfm_encode_fwd", [600, 64, 48], N_SERVE),
    ("multi_eval", "multi_lstm_fwd", [600, 24], N_SERVE),
    ("encode_bwd", "mfm_encode_bwd", [1400, 64, 48], N_TRAIN),
    ("multi_bwd", "multi_lstm_bwd", [1700, 24], N_TRAIN),
    ("decoder_fwd", "decoder_lstm_fwd", [2200, 24], N_TRAIN),
    ("multi_train", "multi_lstm_fwd", [2200, 24], N_TRAIN),
    ("decoder_bwd", "decoder_lstm_bwd", [3000], N_TRAIN),
)
# the memory chain past its own limit: R (4 mem + 5 (s3 + s4)) floats a
# block in the 2-row eval forward, 13 mem + 3 (s3 + s4) in the 1-row
# backward, against 58,112
C1_MEM = 7400


def block_weight(dims, gen, dev):
    """A packed gate-major block-diagonal recurrent weight (H, 4H) over the
    cells ``dims``, each block scaled by 0.5 / sqrt(h)."""
    from factorized_tpu_torch.ops import cuda_lstm

    H = sum(dims)
    w = torch.zeros((H, 4 * H), device=dev)
    o = 0
    for h in dims:
        cols = cuda_lstm.cell_columns(H, o, h, dev)
        w[o:o + h, cols] = (0.5 / h ** 0.5) * torch.randn(
            (h, 4 * h), generator=gen, device=dev)
        o += h
    return w


def few_timed(fn, plain):
    """timed() with fewer calls, for chains of several ms a call."""
    return {"ms": cuda_ms(fn, 5, warmup=1),
            "device_ms": queued_ms(fn, reps=5, warmup=1),
            "plain_ms": cuda_ms(plain, 3, warmup=1)}


def c1_phase(cfg, dev, smi):
    """Step 16's kernels: each chain at a width just past the one at which
    its per-row state alone passed a block's shared memory, where the
    launch used to be refused, against its plain version with the
    step-3/6 tolerances: the plan it took (``cuda_lstm.SCRATCH``, counted
    in ``SCRATCH_LAUNCHES``), device ms, events ms, bound, plain ms and,
    for the recurrences, the per-cell ``nn.LSTM`` yardstick."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    t = cfg.seqlength
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    for module in (cuda_lstm, cuda_mfn):
        module.SCRATCH_LAUNCHES.clear()
    out, library = {}, {}

    def record(label, name, cells, n, err, times, bnd, lib=None, **kw):
        module = cuda_mfn if name.startswith("mfm") else cuda_lstm
        out[label] = {"kernel": name, "cells": cells, "n": n,
                      "plan": module.CLUSTERS[name],
                      "max_abs_err": err["max_abs_err"], **times,
                      "bound_ms": bnd[0], "bound_by": bnd[1],
                      "library_ms": None, **kw}
        if lib is not None:
            library[label] = lib

    def encode_case(h_dims, n, **widths):
        wide = cfg.replace(h_dims=h_dims, **widths)
        params = mfm.MFM(wide, seed=SEED + 91, device=dev).tree()
        x = torch.randn((t, n, wide.d_total), generator=gen, device=dev)
        (xp, weights, z_tot, dims), _ = mfm.kernel_operands(params, x, wide)
        return wide, xp, weights, z_tot, dims

    with torch.inference_mode():
        for label, name, cells, n in C1_CHAINS:
            H = sum(cells)
            if name == "mfm_encode_fwd":
                _, xp, weights, z_tot, dims = encode_case(cells, n)
                got = cuda_mfn.mfm_encode(xp, weights, z_tot, dims)
                err = compare_all(f"c1.{label}", zip(
                    ("h_last", "mem_last"), got,
                    cuda_mfn.mfm_encode_plain(xp, weights, z_tot)))
                bnd = bound(2 * n * (t * encode_macs_per_row(
                    weights, dims, z_tot) - 4 * sum(h * h for h in dims)),
                    nbytes(xp, *off_diag(weights), *got) + diag_bytes(dims))
                record(label, name, dims, n, err, few_timed(
                    lambda: cuda_mfn.mfm_encode(xp, weights, z_tot, dims),
                    lambda: cuda_mfn.mfm_encode_plain(xp, weights, z_tot)),
                    bnd)
            elif name == "mfm_encode_bwd":
                wide, xp, weights, z_tot, dims = encode_case(cells, n)
                H = sum(dims)
                masks = cuda_mfn.make_dropout_masks(
                    gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(wide))
                res = cuda_mfn.mfm_encode_res_plain(xp, masks, weights,
                                                    z_tot)[2:]
                dh = torch.randn((n, H), generator=gen, device=dev)
                dmem = torch.randn((n, wide.memsize), generator=gen,
                                   device=dev)

                def bwd():
                    return cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem,
                                                z_tot, dims)

                def bwd_plain():
                    return cuda_mfn.mfm_encode_bwd_steps_plain(
                        xp, weights, *res, dh, dmem, z_tot)

                got = bwd()
                err = compare_all(f"c1.{label}", zip(("dxp", "deltas"), got,
                                                     bwd_plain()),
                                  GRAD_RTOL, GRAD_ATOL)
                s1, s2, s3, s4, mem = cuda_mfn.sizes(weights)
                m2 = 2 * (H - z_tot)
                macs = ((t - 1) * n * 2 * 4 * sum(h * h for h in dims)
                        + t * n * ((s3 + s4) * mem + s2 * mem
                                   + (m2 + mem) * (s3 + s4) + m2 * s2
                                   + 2 * s1 * m2))
                used = ("a1w1", "a1w2", "a2w1", "a2w2", "gw1", "g1w2",
                        "g2w2")
                bnd = bound(2 * macs, nbytes(
                    xp, *res, dh, dmem, *[weights[k] for k in used], *got)
                    + diag_bytes(dims))
                record(label, name, dims, n, err, few_timed(bwd, bwd_plain),
                       bnd)
            elif name == "multi_lstm_fwd":
                wh = block_weight(cells, gen, dev)
                xp = torch.randn((t, n, 4 * H), generator=gen, device=dev)
                train = label == "multi_train"
                got = cuda_lstm.multi_lstm_fwd(xp, wh, cells, with_res=train)
                want = cuda_lstm.multi_lstm_plain(xp, wh, with_res=train)
                err = compare_all(f"c1.{label}", zip(
                    ("h_last", "allh", "allc", "gates"),
                    got if train else [got], want if train else [want]))
                bnd = bound(2 * (t - 1) * n * 4 * sum(h * h for h in cells),
                            nbytes(xp, *(got if train else [got]))
                            + diag_bytes(cells))
                xs = [torch.randn((t, n, cfg.d_total), generator=gen,
                                  device=dev) for _ in cells]
                record(label, name, cells, n, err, few_timed(
                    lambda: cuda_lstm.multi_lstm_fwd(xp, wh, cells,
                                                     with_res=train),
                    lambda: cuda_lstm.multi_lstm_plain(xp, wh,
                                                       with_res=train)),
                    bnd, lambda: cell_library_ms(
                        [{"wh": torch.empty((h, 0))} for h in cells], xs),
                    with_res=train)
            elif name == "multi_lstm_bwd":
                wh = block_weight(cells, gen, dev)
                xp = torch.randn((t, n, 4 * H), generator=gen, device=dev)
                _, _, allc, gates = cuda_lstm.multi_lstm_plain(
                    xp, wh, with_res=True)
                dh = torch.randn((n, H), generator=gen, device=dev)
                got = cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, cells)
                err = compare(f"c1.{label}", got, cuda_lstm.multi_lstm_bwd_plain(
                    gates, wh, allc, dh), GRAD_RTOL, GRAD_ATOL)
                bnd = bound(2 * (t - 1) * n * 4 * sum(h * h for h in cells),
                            nbytes(gates, allc, dh, got) + diag_bytes(cells))
                xs = [torch.randn((t, n, cfg.d_total), generator=gen,
                                  device=dev) for _ in cells]
                record(label, name, cells, n, err, few_timed(
                    lambda: cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh,
                                                     cells),
                    lambda: cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc,
                                                           dh)),
                    bnd, lambda: cell_library_ms(
                        [{"wh": torch.empty((h, 0))} for h in cells], xs,
                        backward=True))
            else:
                wsum = block_weight(cells, gen, dev)
                b = 0.1 * torch.randn((1, 4 * H), generator=gen, device=dev)
                h0 = torch.randn((n, H), generator=gen, device=dev)
                c0 = torch.randn((n, H), generator=gen, device=dev)
                allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0,
                                                                 wsum, b, t)
                macs = (t - 1) * n * 4 * sum(h * h for h in cells)
                if name == "decoder_lstm_fwd":
                    got = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t,
                                                     cells)
                    err = compare_all(f"c1.{label}", zip(
                        ("allh", "allc", "gates"), got, (allh, allc, gates)))
                    bnd = bound(2 * macs, nbytes(h0, c0, b, *got)
                                + diag_bytes(cells))
                    times = few_timed(
                        lambda: cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b,
                                                           t, cells),
                        lambda: cuda_lstm.decoder_lstm_plain(h0, c0, wsum,
                                                             b, t))
                    backward = False
                else:
                    dallh = torch.randn(allh.shape, generator=gen,
                                        device=dev)
                    got = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc,
                                                     dallh, cells)
                    err = compare_all(f"c1.{label}", zip(
                        ("dgates", "dh0", "dc0"), got,
                        cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc,
                                                         dallh)),
                        GRAD_RTOL, GRAD_ATOL)
                    bnd = bound(2 * macs, nbytes(gates, allc, dallh, *got)
                                + diag_bytes(cells))
                    times = few_timed(
                        lambda: cuda_lstm.decoder_lstm_bwd(
                            wsum, gates, allc, dallh, cells),
                        lambda: cuda_lstm.decoder_lstm_bwd_plain(
                            wsum, gates, allc, dallh))
                    backward = True
                record(label, name, cells, n, err, times, bnd,
                       functools.partial(decoder_library_ms, h0, c0, wsum,
                                         b, t, cells, backward=backward))

        # the memory chain past its limit, forward (eval) and backward
        n = N_TRAIN
        wide, xp, weights, z_tot, dims = encode_case(
            cfg.h_dims, n, memsize=C1_MEM, gamma1_shape=128,
            gamma2_shape=128)
        got = cuda_mfn.mfm_encode(xp, weights, z_tot, dims)
        err = compare_all("c1.memory_eval", zip(
            ("h_last", "mem_last"), got,
            cuda_mfn.mfm_encode_plain(xp, weights, z_tot)))
        bnd = bound(2 * n * (t * encode_macs_per_row(weights, dims, z_tot)
                             - 4 * sum(h * h for h in dims)),
                    nbytes(xp, *off_diag(weights), *got) + diag_bytes(dims))
        record("memory_eval", "mfm_encode_fwd", dims, n, err, few_timed(
            lambda: cuda_mfn.mfm_encode(xp, weights, z_tot, dims),
            lambda: cuda_mfn.mfm_encode_plain(xp, weights, z_tot)), bnd,
            mem=C1_MEM)
        masks = cuda_mfn.make_dropout_masks(
            gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(wide))
        res = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)[2:]
        dh = torch.randn((n, sum(dims)), generator=gen, device=dev)
        dmem = torch.randn((n, C1_MEM), generator=gen, device=dev)
        got = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot, dims)
        err = compare_all("c1.memory_bwd", zip(
            ("dxp", "deltas"), got, cuda_mfn.mfm_encode_bwd_steps_plain(
                xp, weights, *res, dh, dmem, z_tot)), GRAD_RTOL, GRAD_ATOL)
        s1, s2, s3, s4, mem = cuda_mfn.sizes(weights)
        m2 = 2 * (sum(dims) - z_tot)
        macs = ((t - 1) * n * 2 * 4 * sum(h * h for h in dims)
                + t * n * ((s3 + s4) * mem + s2 * mem + (m2 + mem) * (s3 + s4)
                           + m2 * s2 + 2 * s1 * m2))
        used = ("a1w1", "a1w2", "a2w1", "a2w2", "gw1", "g1w2", "g2w2")
        bnd = bound(2 * macs, nbytes(xp, *res, dh, dmem,
                                     *[weights[k] for k in used], *got)
                    + diag_bytes(dims))
        record("memory_bwd", "mfm_encode_bwd", dims, n, err, few_timed(
            lambda: cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                         dims),
            lambda: cuda_mfn.mfm_encode_bwd_steps_plain(
                xp, weights, *res, dh, dmem, z_tot)), bnd, mem=C1_MEM)
        torch.cuda.synchronize()
    # the yardsticks run outside inference mode (their backward records)
    for label, lib in library.items():
        out[label]["library_ms"] = lib()
    for label, numbers in out.items():
        log({"phase": "c1", "label": label, "nvidia_smi": smi, **numbers})
        plan = numbers["plan"]
        if cuda_lstm.SCRATCH not in (plan if isinstance(plan, tuple)
                                     else (plan,)):
            raise AssertionError(f"{label} did not keep its state in device "
                                 f"memory past a block: {numbers}")
    scratch = {**cuda_mfn.SCRATCH_LAUNCHES, **cuda_lstm.SCRATCH_LAUNCHES}
    if set(scratch) != {name for _, name, _, _ in C1_CHAINS}:
        raise AssertionError(f"a chain was not counted on the scratch "
                             f"plan: {scratch}")
    return out


def epoch_records(path):
    """The ``epoch`` records of a run's JSONL log, in order."""
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "epoch"]


def mosi_cli(argv, path, kernels, command="mosi"):
    """``python -m factorized_tpu_torch mosi`` (or ``command``) in this
    process (the card, the build and the kernels' counters shared),
    counted; fails unless it exits 0 and launches each of ``kernels``.
    Returns (seconds, launches, scratch launches by kernel)."""
    from factorized_tpu_torch import cli

    rc, seconds, launches = counted(path, kernels,
                                    lambda: cli.main([command, *argv]))
    if rc != 0:
        raise AssertionError(f"{command} {argv} exited {rc}")
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    return seconds, {k: launches[k] for k in kernels}, {
        **cuda_mfn.SCRATCH_LAUNCHES, **cuda_lstm.SCRATCH_LAUNCHES}


def finite(records):
    """Whether every epoch record's losses are finite (and there is one)."""
    return bool(records) and all(
        np.isfinite([r["train_loss"], r["valid_loss"]]).all()
        for r in records)


def falling_finite(records, label):
    """Every epoch's losses finite and the train loss falling."""
    losses = [r["train_loss"] for r in records]
    if not finite(records):
        raise AssertionError(f"{label}: a loss is not finite: {records}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the train loss did not fall: "
                             f"{losses}")
    return losses


def c1_train_phase(cfg, smi, tmp):
    """Step 16's run: ``mosi --config <json> --epochs 2`` whose JSON makes
    an MFN cell of 1,400 units (``h_dims`` [1400, 64, 48]), an encoder
    cell of 600 (``zl_size``) and a decoder cell of 3,000 (``fy_size`` +
    ``fv_size``), at batch 128 on the synthetic MOSI set: a finite,
    falling loss, every kernel of the path launched, and the chains past
    a block's state on the scratch plan (the eval encode of the
    validation, the reverse pass, both decoder kernels)."""
    import os

    wide = cfg.replace(h_dims=[1400, 64, 48], zl_size=600,
                       fv_size=3000 - cfg.fy_size, batchsize=128)
    path = os.path.join(tmp, "c1.json")
    with open(path, "w") as f:
        json.dump(wide.to_dict(), f)
    out = os.path.join(tmp, "c1_runs")
    kernels = ABLATION_TRAIN["m_a"]
    seconds, launches, scratch = mosi_cli(
        ["--config", path, "--epochs", "2", "--out", out,
         "--seed", str(SEED)], "mosi --config (C1 widths)", kernels)
    losses = falling_finite(epoch_records(os.path.join(out, "mosi_0.jsonl")),
                            "C1 widths")
    on_scratch = ("mfm_encode_fwd", "mfm_encode_bwd", "decoder_lstm_fwd",
                  "decoder_lstm_bwd")
    if any(scratch.get(k, 0) < 1 for k in on_scratch):
        raise AssertionError(f"a chain past a block's state did not run on "
                             f"the scratch plan: {scratch}")
    decoders = [wide.fy_size + f for f in (wide.fl_size, wide.fa_size,
                                           wide.fv_size)]
    log({"phase": "c1_train", "nvidia_smi": smi, "seconds": seconds,
         "h_dims": wide.h_dims, "zl_size": wide.zl_size,
         "decoders": decoders, "batchsize": wide.batchsize,
         "train_loss": losses, "launches": launches,
         "scratch_launches": scratch})


def cli_phase(smi, tmp):
    """Step 17: the ``mosi`` command's surface on the card.

    - ``--mode search --trials 3 --epochs 2 --seed S`` for ``mfm`` and
      ``kl_ef``: the ``config`` records equal ``sample_search_config``'s
      draws from ``random.Random(S)`` on the CPU, each trial's losses
      finite;
    - ``--config configs/mosi.json --epochs 2 --save-ckpt``, then
      ``--resume`` of that checkpoint with ``--epochs 4 --ckpt-every 1``:
      before the first resumed step the restored parameters and Adam
      state equal the checkpoint's bit for bit, the ``epoch`` records go
      on at 2, the first one's lr is the checkpoint's ``_resume_lr``, the
      losses are finite, and ``ckpt_auto_mosi_0`` is left at step 4;
    - ``--data-root`` on a fabricated MOSI root (the real files' layout,
      ``data.mosi.fabricate_root``), with ``--feature-selection`` 1 and
      0, finite losses."""
    import os
    import random

    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.config import sample_search_config
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.train import leaves
    from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    seed = SEED + 120
    for model_type, kernels in (("mfm", ABLATION_TRAIN["m_a"]),
                                ("kl_ef", ("multi_lstm_fwd", "multi_lstm_bwd",
                                           "decoder_lstm_fwd",
                                           "decoder_lstm_bwd"))):
        seed += 1
        runs = os.path.join(tmp, f"search_{model_type}")
        seconds, launches, _ = mosi_cli(
            ["--mode", "search", "--trials", "3", "--epochs", "2", "--type",
             model_type, "--seed", str(seed), "--out", runs],
            f"mosi --mode search --type {model_type}", kernels)
        rng = random.Random(seed)
        drawn = []
        for trial in range(3):
            want = sample_search_config("mosi", rng, model_type=model_type,
                                        missing=0, zeros=0).replace(
                input_dims=[300, 5, 20], num_epochs=2).to_dict()
            log_path = os.path.join(runs, f"mosi_{trial}.jsonl")
            with open(log_path) as f:
                got = next(r for r in map(json.loads, f)
                           if r["kind"] == "config")
            got = {k: v for k, v in got.items() if k in want}
            if got != json.loads(json.dumps(want)):
                raise AssertionError(f"search {model_type} trial {trial}: "
                                     f"{got} against the CPU's {want}")
            records = epoch_records(log_path)
            if not finite(records):
                raise AssertionError(f"search {model_type} trial {trial}: "
                                     f"a loss is not finite")
            drawn.append({k: want[k] for k in ("h_dims", "memsize",
                                               "batchsize", "zl_size")})
        out[f"search_{model_type}"] = {"seconds": seconds, "drawn": drawn,
                                       "launches": launches}

    # save, then resume: the state before the first resumed step
    runs = os.path.join(tmp, "resume")
    config = os.path.join(repo, "configs", "mosi.json")
    kernels = ABLATION_TRAIN["m_a"]
    seconds, _, _ = mosi_cli(["--config", config, "--epochs", "2",
                              "--save-ckpt", "--out", runs],
                             "mosi --save-ckpt", kernels)
    ckpt = os.path.join(runs, "ckpt_mosi_0")
    state, meta = restore_checkpoint(ckpt)
    seen = {}
    resume = trainers._maybe_resume

    def checked_resume(resume_from, run, logger):
        got = resume(resume_from, run, logger)
        opt = run.optimizer
        want = state["opt_state"]["state"]
        seen["same_bits"] = bool(
            all(torch.equal(a.cpu(), b) for a, b in zip(
                leaves(run.params), leaves(state["params"])))
            and torch.equal(opt.flat.cpu(),
                            opt.flatten(state["params"]).cpu())
            and torch.equal(opt.mu.cpu(), want["mu"])
            and torch.equal(opt.nu.cpu(), want["nu"])
            and int(opt.count) == int(want["count"]))
        seen["lr"] = float(opt.lr)
        return got

    trainers._maybe_resume = checked_resume
    try:
        more, _, _ = mosi_cli(["--config", config, "--epochs", "4",
                               "--resume", ckpt, "--ckpt-every", "1",
                               "--out", runs], "mosi --resume", kernels)
    finally:
        trainers._maybe_resume = resume
    records = epoch_records(os.path.join(runs, "mosi_0.jsonl"))
    resumed = records[2:]
    _, auto = restore_checkpoint(os.path.join(runs, "ckpt_auto_mosi_0"))
    first_lr = meta["config"]["_resume_lr"]
    if not (seen.get("same_bits") and meta["step"] == 2
            and [r["epoch"] for r in records] == [0, 1, 2, 3]
            and resumed[0]["lr"] == first_lr and auto["step"] == 4
            and finite(records)):
        raise AssertionError(f"resume: {seen}, step {meta['step']}, "
                             f"records {records}, auto step {auto['step']}")
    out["resume"] = {"seconds": [seconds, more], "restored_same_bits": True,
                     "resume_lr": first_lr, "epochs": [r["epoch"]
                                                       for r in records],
                     "train_loss": [r["train_loss"] for r in records],
                     "ckpt_auto_step": auto["step"]}

    # the real files' reader on a fabricated root
    root = mosi.fabricate_root(os.path.join(tmp, "mosi_root"))
    for fs in ("1", "0"):
        runs = os.path.join(tmp, f"root_fs{fs}")
        seconds, _, _ = mosi_cli(
            ["--mode", "best", "--data-root", root, "--feature-selection",
             fs, "--epochs", "2", "--out", runs],
            f"mosi --data-root --feature-selection {fs}", kernels)
        with open(os.path.join(runs, "mosi_0.jsonl")) as f:
            dims = next(r for r in map(json.loads, f)
                        if r["kind"] == "config")["input_dims"]
        records = epoch_records(os.path.join(runs, "mosi_0.jsonl"))
        if not finite(records):
            raise AssertionError(f"--data-root fs {fs}: {records}")
        out[f"data_root_fs{fs}"] = {"seconds": seconds, "input_dims": dims,
                                    "train_loss": [r["train_loss"]
                                                   for r in records]}
    log({"phase": "cli", "nvidia_smi": smi, **out})


# Step 18: the missing-modality baselines' trainers and the kernels their
# training path launches; the other datasets' commands and MOSI's
# accuracy variant, all through MFM's encode path
BASELINE_TRAIN = {"s2s": ABLATION_TRAIN["m_b"], "bm": ABLATION_TRAIN["m_d"]}
COMMANDS = ("moud", "you", "mmmo", "mosi_acc")


@contextlib.contextmanager
def draws_from(stand_in, source):
    """``torch.rand`` and ``torch.randn`` asked to draw from the generator
    ``stand_in`` draw from ``source`` instead (on its device) and bring
    the draw where it was asked for: a run on the CPU makes the card's
    draws."""
    real = torch.rand, torch.randn

    def routed(fn):
        def draw(*args, generator=None, device=None, **kw):
            if generator is not stand_in:
                return fn(*args, generator=generator, device=device, **kw)
            return fn(*args, generator=source, device=source.device,
                      **kw).to(device or "cpu")
        return draw

    torch.rand, torch.randn = routed(real[0]), routed(real[1])
    try:
        yield
    finally:
        torch.rand, torch.randn = real


def replay_vs_cpu(loop, label):
    """One more epoch of a trainer's chunked loop, its epoch graph
    captured (the remainder step inside it), replayed on the card against
    the same epoch run eagerly on the CPU's plain path from the same
    parameters, Adam state, lr and draws (``draws_from`` a copy of the
    card's generator): the epoch's tracked loss, then the parameters and
    Adam's first moment after it, within the gradients' tolerances.
    Returns the max abs errors."""
    from factorized_tpu_torch.train import make_optimizer

    opt, (Xb, yb, rem), gen = loop.opt, loop.batches, loop.generator
    params = opt.tree_of(opt.flat.detach().cpu())
    cpu_opt = make_optimizer(params, float(opt.lr))
    cpu_opt.load_state_dict(opt.state_dict())
    source = torch.Generator(device=gen.device)
    source.set_state(gen.get_state())
    stand_in = torch.Generator()
    with draws_from(stand_in, source):
        tracked = loop.program.train_epoch(
            params, cpu_opt, Xb.cpu(), yb.cpu(), stand_in,
            remainder=None if rem is None else (rem[0].cpu(), rem[1].cpu()))
    rows = loop.run(1)
    loss = compare(f"{label}.replayed_epoch_vs_cpu.tracked_loss",
                   torch.tensor(rows[0, 0], dtype=torch.float32),
                   tracked.detach().float(), GRAD_RTOL, GRAD_ATOL)
    state = compare_all(f"{label}.replayed_epoch_vs_cpu", (
        ("params", opt.flat.cpu(), cpu_opt.flat),
        ("adam_mu", opt.mu.cpu(), cpu_opt.mu)), GRAD_RTOL, GRAD_ATOL)
    return {"tracked_loss_abs_err": loss["max_abs_err"],
            "state_max_abs_err": state["max_abs_err"],
            "steps": int(Xb.shape[0]) + (rem is not None)}


def path_times(loop, steps=5, replays=3):
    """A training path's times from the chunked loop its trainer ran (its
    epoch graph captured): device ms and kernel launches a step and the
    device's idle share (torch.profiler over ``steps`` eager steps on the
    loop's first batch), replayed epoch s (host clock, median of
    ``replays`` ``run(1)``s, its host read included) and device ms of a
    replayed epoch (torch.profiler over one), with the idle share against
    the unprofiled epoch's wall."""
    from torch.profiler import ProfilerActivity, profile

    Xb, yb, rem = loop.batches
    prof = profile_steps(loop.program, loop.params, loop.opt, Xb[0], yb[0],
                         loop.generator, steps)
    replay_s = []
    for _ in range(replays):
        t0 = time.perf_counter()
        loop.run(1)
        replay_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        loop.run(1)
    kernels = [e for e in p.key_averages() if on_device(e)]
    if not kernels:
        raise AssertionError("torch.profiler saw no kernel of a replay")
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    epoch_s = float(np.median(replay_s))
    return {"batches": int(Xb.shape[0]), "batch": int(Xb.shape[2]),
            "remainder_rows": 0 if rem is None else int(rem[0].shape[1]),
            "device_ms_per_step": prof["device_ms_per_step"],
            "launches_per_step": prof["kernel_launches_per_step"],
            "eager_step_device_idle_share": prof["device_idle_share"],
            "replayed_epoch_s": epoch_s, "replayed_epoch_s_all": replay_s,
            "device_ms_per_replayed_epoch": device_ms,
            "replayed_device_idle_share": 1.0 - device_ms / (epoch_s * 1e3),
            "kernels_seen_per_replayed_epoch": sum(e.count for e in kernels),
            "capture_ms": loop.epoch.capture_ms,
            "graph_pool_bytes": loop.epoch.pool_bytes}


def graph_replayed(loops, label):
    """The one chunked loop of a 2-epoch run, its second epoch a replay."""
    if not (len(loops) == 1 and loops[0].epoch.graph is not None):
        raise AssertionError(f"{label}: the second epoch was not a graph "
                             f"replay")
    return loops[0]


def baseline_phase(cfg, dev, smi, data, tmp):
    """Step 18. ``s2s`` and ``bm`` (``--missing 1``) at
    ``best_acc_mosi_config``: one train step's gradients on the card
    against the CPU's with the same injected draws, then 2 epochs of
    synthetic MOSI through ``trainers.train_seq2seq`` and
    ``train_basic_missing`` (the second a graph replay): finite, falling
    losses and ``multi_lstm_fwd``/``_bwd`` launched, for ``s2s`` the
    decoder kernels too. Then ``moud``, ``you``, ``mmmo`` and ``mosi_acc
    --mode best --epochs 2`` through the command on their synthetic sets:
    finite, falling losses, MFM's encode and decoder kernels launched, a
    score block printed. The remainder batch of ``you`` (its ragged last
    batch, a step of its own inside the epoch graph): one train step's
    gradients at its rows on the card against the CPU's, and a third
    epoch replayed against the same epoch on the CPU (``replay_vs_cpu``).
    For each path its device ms and launches a step and its replayed
    epoch s (``path_times``)."""
    import os

    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.cli import DATASETS
    from factorized_tpu_torch.data import youtube
    from factorized_tpu_torch.models import baselines, get_model, mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn
    from factorized_tpu_torch.train import make_loss_fn
    from factorized_tpu_torch.utils.logging import RunLogger

    t, d = cfg.seqlength, cfg.d_total
    out = {}
    for k, (model_type, kernels) in enumerate(BASELINE_TRAIN.items()):
        mcfg = cfg.replace(model_type=model_type, missing=1)
        seconds = {}
        params = mfm.MFM(mcfg, seed=SEED + 130 + k, device=dev).tree()
        cpu = torch.Generator().manual_seed(SEED + 140 + k)
        x = torch.randn((t, N_TRAIN, d), generator=cpu)
        y = torch.randn((N_TRAIN,), generator=cpu)
        t0 = time.perf_counter()
        grads = grads_vs_cpu(
            f"{model_type}.train_step_grads_vs_cpu",
            make_loss_fn(get_model(model_type)[1], mcfg, model_type),
            params, x, y, baselines.train_draws(mcfg, N_TRAIN, cpu),
            dev)
        seconds["grads_vs_cpu"] = time.perf_counter() - t0
        trainer = {"s2s": trainers.train_seq2seq,
                   "bm": trainers.train_basic_missing}[model_type]
        with chunked_loops() as loops:
            run, seconds["train"], launches = counted(
                f"train {model_type}", kernels,
                lambda: trainer(*data, mcfg.replace(num_epochs=TRAIN_EPOCHS),
                                seed=SEED, logger=RunLogger(echo=False),
                                device=dev))
        falling_finite([{"train_loss": e["train_loss"],
                         "valid_loss": e["valid"]} for e in run["history"]],
                       model_type)
        loop = graph_replayed(loops, model_type)
        epoch_launches = [per_kernel(e) for e in loop.epoch_launches]
        t0 = time.perf_counter()
        times = path_times(loop)
        seconds["times"] = time.perf_counter() - t0
        out[model_type] = {k: launches[k] for k in kernels}
        log({"phase": "baseline", "model_type": model_type,
             "nvidia_smi": smi, "history": run["history"],
             "metrics": run["metrics"], "train_launches": out[model_type],
             "epoch_launches": epoch_launches,
             "grads_max_abs_err": grads["max_abs_err"], **times,
             "seconds": seconds})

    # the kernels of MFM's training path at the rows of the remainder
    # batch of `you` (three classes)
    info = DATASETS["you"]
    rcfg = cfg.replace(input_dims=info["input_dims"],
                       output_dim=info["output_dim"], task=info["task"])
    n_rem = youtube.get_data(t)[0].shape[0] % rcfg.batchsize
    cpu = torch.Generator().manual_seed(SEED + 150)
    x = torch.randn((t, n_rem, rcfg.d_total), generator=cpu)
    y = torch.randint(0, rcfg.output_dim, (n_rem,), generator=cpu,
                      dtype=torch.int32)
    t0 = time.perf_counter()
    remainder_grads = grads_vs_cpu(
        "you.remainder_rows.train_step_grads_vs_cpu",
        make_loss_fn(mfm.mfm_apply, rcfg),
        mfm.MFM(rcfg, seed=SEED + 151, device=dev).tree(), x, y, {
            "encode_masks": cuda_mfn.make_dropout_masks(
                cpu, t, n_rem, (rcfg.att1_shape, rcfg.att2_shape,
                                rcfg.gamma1_shape, rcfg.gamma2_shape),
                mfn_drops(rcfg)),
            "mmd_noise": torch.randn(mfm.mmd_noise_shape(rcfg, n_rem),
                                     generator=cpu),
            "zf_masks": zf_masks(rcfg, n_rem, cpu)}, dev)
    remainder_s = time.perf_counter() - t0
    replayed = {}
    for name in COMMANDS:
        runs = os.path.join(tmp, f"command_{name}")
        kernels = ABLATION_TRAIN["m_a"]
        argv = ["--mode", "best", "--epochs", str(TRAIN_EPOCHS)]
        printed = io.StringIO()
        with chunked_loops() as loops, contextlib.redirect_stdout(printed):
            seconds, launches, _ = mosi_cli(
                [*argv, "--seed", str(SEED), "--out", runs],
                f"{name} {' '.join(argv)}", kernels, command=name)
        records = epoch_records(os.path.join(runs, f"{name}_0.jsonl"))
        losses = falling_finite(records, name)
        if "Accuracy " not in printed.getvalue():
            raise AssertionError(f"{name}: no score block printed: "
                                 f"{printed.getvalue()[-2000:]}")
        loop = graph_replayed(loops, name)
        t0 = time.perf_counter()
        checks = {}
        if loop.batches[2] is not None:
            replayed[name] = checks["replay_vs_cpu"] = replay_vs_cpu(loop,
                                                                     name)
        if name == "you":
            checks["remainder_grads_max_abs_err"] = \
                remainder_grads["max_abs_err"]
            checks["remainder_grads_s"] = remainder_s
        checks["checks_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        times = path_times(loop)
        out[name] = launches
        log({"phase": "dataset_command", "command": [name, *argv],
             "nvidia_smi": smi,
             "train_loss": losses,
             "valid": [r["valid_loss"] for r in records],
             "lr": [r["lr"] for r in records],
             "score_lines": [line for line in
                             printed.getvalue().splitlines()
                             if line.startswith(("Accuracy", "mae"))],
             "launches": launches, "epoch_launches": [
                 per_kernel(e) for e in loop.epoch_launches],
             **checks, **times,
             "seconds": {"run": seconds, "times": time.perf_counter() - t0}})
    if "you" not in replayed:
        raise AssertionError(f"no replayed epoch with a remainder step was "
                             f"held against the CPU: {sorted(replayed)}")
    return out


def profile_steps(program, tree, opt, x, y, gen, steps=10):
    """torch.profiler over train steps: launches per step, device time,
    and the share of the wall in which the device was idle."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        program.step(tree, opt, x, y, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            program.step(tree, opt, x, y, gen)
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
