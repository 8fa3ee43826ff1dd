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
   ``missing``'s 4n stacked rows, the latter with its library yardstick;
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
    encoder cell of 600 and a decoder cell of 3,000, 2 epochs, on the
    fused path (forced: the config passes the FLOPs crossover): a finite,
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
19. the ``predictor`` command's baselines, the flat SGD,
    ``test_attention`` and ``multitrait``: the encode's kernels at both
    ``best_mfn_mosi_config``s (train, reverse and weight gradients at
    n = 128, eval at 256) and ``multi_lstm`` for one 128-unit cell over
    the 325-float input (n = 32 and 128), each against its plain version
    with its plan, bound and library yardstick (``predictor_kernels``
    lines); one train step's gradients of ``eflstm``,
    ``self_attention``, ``mfn`` (both configs) and ``multitrait``'s MFM
    on the card against the CPU's; ``predictor --kind eflstm --optimizer
    sgd``, ``--kind self_attention``, ``--kind mfn --mode best
    --save-ckpt``, ``test_attention`` and ``multitrait --style pom
    --save-ckpt`` and ``--style iemocap``, 2 epochs each through the
    command (finite falling losses, every kernel of the path launched,
    the second epoch a replay), the ``mfn`` checkpoint scored by
    ``test_mosi`` and both checkpoints served over HTTP against the CPU,
    each path's device ms and launches a step and replayed epoch s
    (``predictor`` lines); the flat SGD's graph loop against its host
    loop bit for bit (``predictor_sgd_loop``);
20. lanes of seeds (``--seeds K``, ``parallel/multiseed.py``): each of
    the seven kernel entry points over K = 8 lanes in one launch (lane k
    a model of its own seed) against its lane plain version at full
    width (the eval encode and ``m_b``'s eval trio at n = 256, the train
    encode, its reverse pass and weight gradients, the decoder trio and
    ``m_b``'s trio both ways at n = 32), each timed at 8 lanes, at 1 and
    without a lane axis, beside its plain version and its bound at 8
    (``lane_kernels``, with the library yardstick of each lane by
    lane, as step 21's); one K = 8 ``mfm`` step's gradients on the card
    against the CPU's with the same injected draws (``lane_grads``);
    ``mosi --type mfm --seeds 8``, ``mosi --type m_b --seeds 4`` and
    ``mosi_acc --seeds 4``, ``--mode best --epochs 2``, through the
    command: every lane's loss finite and falling, each kernel launched
    once a step for all the lanes, the second epoch a replay, each
    path's device ms and launches a step, replayed epoch s and idle
    share (``lanes``); ``--ckpt-every 1`` then ``--resume``, the
    restored state bit for bit (``lanes_resume``); ``check --dir`` on the
    ``mfm`` run printing the seeds' best (``lanes_check``); ``mfm`` at K
    = 1, 2, 4 and 8 (``lane_scaling``); one K = 8 step of ``m_a``,
    ``m_c``, ``kl``, ``m_d``, ``kl_ef`` (stages 1 and 2) and ``missing``
    each (``lane_models``): the gradients against the CPU's, the step's
    launches, and every lane kernel call of the step replayed lane by
    lane with no lane axis, lane k bit for bit;
21. the shape-bucketed and evolving searches (``--bucket``,
    ``--evolve``, ``parallel/multiconfig.py``) and the lane kernels past
    8 lanes: each of the seven entry points at K = 12, 16 and 32 against
    its lane plain version lane by lane at step 20's shapes and
    tolerances, each call launching once, lane k bit for bit its one-lane
    call, timed at 16 and 32 with its library yardstick
    lane by lane (7 ``torch.bmm`` and 7 sums, one ``nn.LSTM`` per cell and
    lane), the eval encode on the scratch plan at K = 12, and step 20g's
    check of ``kl_ef`` stage 1 at K = 12 (``lane_kernels``,
    ``lane_kernels_past_8`` lines);
    ``train_evolving_search`` at ``best_acc_mosi_config``, 8 configs x 2
    seeds, 3 rungs of 2 epochs: finite losses, the survivors' falling,
    the culls the ranks give, two launches of each kernel a step for all
    16 lanes, one capture for the whole search, the host ms of each rung
    boundary, a recycle leaving the survivors bit for bit, a re-seeded
    generator taking effect at the next replay, a recycled lane's first
    step a fresh Adam's (``evolve_search``); through the command ``mosi
    --mode search --evolve 2 --trials 4 --seeds 3 --ckpt-every 1`` (12
    lanes, its template's shapes and plans), its ``--resume`` repeating
    the second rung's records bit for bit, ``--bucket --trials 4 --seeds
    2`` and ``multitrait --style pom --evolve 2`` (``search_command``),
    ``mosi --type m_b --evolve 2`` over 12 lanes (``search_command``),
    ``check --dir`` (``search_check``); ``mfm``'s lane path at K = 16 and
    32 (``lane_scaling_past_8``);
22. prints one JSON line on the ten kernels (their launches with the
    paths of steps 19 to 21, 23 and 25 counted) and the seven lane entry
    points at K = 8 (``<kernel>.lanes8``, their launches step 20's and
    23's lane launches) and K = 16 (``<kernel>.lanes16``, step 21's), the
    ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``; a
    ``seconds`` line after each of steps 4, 6, 8, 10 to 21 and 23 to 25;
23. (run before step 22 prints) the CMU-MultimodalSDK sets
    (``data/mmsdk.py``) at ``best_acc_mosi_config``'s full width and their
    published feature widths, fabricated from the seed as ``.csd``
    sequences (CMU-MOSEI's 3,228 videos and about 23,500 segments; MOSI's
    93 and 2,199; the one cut: a few audio and visual rows a word), as
    files where h5py imports, else through a stand-in of ``read_csd`` so
    that everything below the read runs (``"h5py"`` on each ``sdk``
    line): ``mosei_sdk --type mfm --mode best --epochs 2 --save-ckpt``
    through the command, its read and alignment and a cache hit (host
    seconds), finite falling losses, every kernel of the path once a step
    of the replayed epoch, device ms and launches a step, replayed epoch s,
    the capture's ms and pool bytes, the eval encode at the validation and
    test row counts against its plain version, the checkpoint served on
    the test set against the CPU; at MOSI's size ``mosi_sdk --seeds 4``,
    ``--mode search --evolve 2 --trials 4``, ``multitrait --style
    mosei_sdk`` and ``pom_sdk``, ``predictor --dataset mosi_sdk --kind
    mfn`` and ``--kind eflstm --split 40,10``, and ``--profile`` (the
    trace names the path's kernels, a replay's too); ``warmup``, each
    leg's seconds; the FLOPs of a ``mfm`` step (``utils/flops.py``) and
    their share of the float32 peak (``sdk``, ``sdk_warmup``,
    ``sdk_flops`` lines);
24. (run before step 22 prints) the modular path above the FLOPs
    crossover (``models/mfm.py::fused_active``): (a) at the scale
    probe's configs A and B (``benchprog.scale_candidates``), one on
    either side of the crossover, one train step of ``mfm`` through each
    path with ``FUSED`` forced, the same seeded draws: the losses and
    every gradient of the modular step against the fused kernels' within
    rtol 1e-3 / atol 2e-5 (TF32 off), the chain kernels' launch counts 0
    on the modular step and 1 each on the fused one, the plans the
    launchers reported against ``benchprog.active_paths`` (``modular``
    lines); (b) ``benchprog.scale_cfg`` on the path the gate picks:
    ``make_chunk`` at ``SCALE_E`` epochs of ``SCALE_NB`` batches (the
    second epoch a capture and its replay), then ``SCALE_E`` more
    replays: ``active_paths`` against the launch counts, finite losses,
    the step's device ms (a replayed epoch by CUDA events over its
    batches), its model FLOPs and their share of the float32 peak,
    replay s, capture s, graph pool bytes and peak device memory
    (``scale_chunk``); and ``warmup``'s three bench legs, each leg's
    seconds and launches (``bench_legs``).
25. (run before step 22 prints) the JAX package's checkpoints read by
    the port, with no Orbax, tensorstore, zstd or msgpack package
    (``installed`` records which of them import): ``best/mfn_mae`` and
    ``best/mfn_acc`` read by ``restore_checkpoint`` (seconds), every leaf
    bit for bit ``released/``'s; ``test_mosi --checkpoint best/<name>``
    on the card, the release's scores within 1e-6 (MAE 0.6101879 and
    binary accuracy 0.8250729; accuracy 0.7813411), the eval encode
    counted; each served over HTTP against the CPU ``Predictor`` over
    ``released/`` (``jax_checkpoint`` lines); the C++ segment average
    (``native.py``) built with the host compiler and held bit for bit
    against ``data/segavg.py`` on 93 fabricated videos at the real MOSI
    files' FACET scale, empty, reversed, clipped and NaN / -inf / +inf
    windows included, the ms of both (``segavg`` line).
26. (run before step 22 prints) beyond one process, each rank a
    subprocess (``parallel/multiprocess.py``; ``tests/torch_ranks.py``
    for 26b and 26c), so no process group
    outlives the step: (a) ``verify_multiprocess`` with two gloo ranks on
    the card, each at batch 16, against one process at batch 32, at
    ``best_acc_mosi_config`` (dropout and the MMD on), 2 epochs of 19
    batches: the parameters within rtol 1e-3 / atol 2e-5, the ranks bit
    for bit each other's, each rank's launches of the training kernels
    beside the single process's (``distributed_dp``); (b) ``mosi --seeds
    8 --seed-parallel --multihost`` with ``WORLD_SIZE=1`` under NCCL
    (a world of one: NCCL joined, no collective issued) against
    ``--seeds 8``, bit for bit, one capture each, then two gloo
    ranks of 4 lanes on the card against the 8 lanes within 1e-5
    relative (``distributed_lanes``); (c) ``tp_param_shardings`` over two
    gloo ranks on the card: one epoch against the replicated epoch in
    this process (``distributed_tp``). Each sub-step's seconds. NCCL
    between two cards needs a second card.

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


def decoder_library_ms(h0, c0, wsum, b, t, dec_dims, backward=False,
                       reps=50):
    """The yardstick of the decoder kernels, used nowhere in the port: one
    ``torch.nn.LSTM`` (cuDNN) per decoder cell computes the same t - 1
    steps from (h0, c0), with a zero input of width 1, ``weight_ih``
    zero, ``weight_hh`` the cell's diagonal blocks of wsum transposed,
    ``bias_ih`` its b and ``bias_hh`` zero; with a lane dimension in front
    of every operand, one per cell and lane. Forward ms by CUDA events;
    with ``backward``, (forward + backward) - forward, the outputs'
    cotangent all ones; ``reps`` calls each."""
    from factorized_tpu_torch.ops import cuda_lstm

    lanes = (h0, c0, wsum, b) if h0.dim() == 3 else (
        h0[None], c0[None], wsum[None], b[None])
    n, H = lanes[0].shape[1:]
    dev = h0.device
    lstms, states = [], []
    for h0_k, c0_k, wsum_k, b_k in zip(*lanes):
        o = 0
        for h in dec_dims:
            cols = cuda_lstm.cell_columns(H, o, h, dev)
            m = torch.nn.LSTM(1, h).to(dev)
            with torch.no_grad():
                m.weight_ih_l0.zero_()
                m.weight_hh_l0.copy_(wsum_k[o:o + h][:, cols].T)
                m.bias_ih_l0.copy_(b_k.reshape(-1)[cols])
                m.bias_hh_l0.zero_()
            lstms.append(m)
            states.append((h0_k[None, :, o:o + h].clone(),
                           c0_k[None, :, o:o + h].clone()))
            o += h
    zeros = torch.zeros((t - 1, n, 1), device=dev)

    def forward():
        return [m(zeros, st)[0] for m, st in zip(lstms, states)]

    if not backward:
        with torch.inference_mode():
            return cuda_ms(forward, reps)

    def both():
        hs = forward()
        torch.autograd.backward(hs, [torch.ones_like(h) for h in hs])

    return cuda_ms(both, reps) - cuda_ms(forward, reps)


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
        module.LANE_LAUNCHES.clear()
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
    """``test_mosi`` on a checkpoint of ``params`` (``test_mosi_on``)."""
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, params, config=cfg.to_dict())
        return test_mosi_on(ckpt, cfg.seqlength, reference)


def test_mosi_on(ckpt, seqlength, reference):
    """``test_mosi`` on the checkpoint ``ckpt``: the score block, the
    probe and the on-device latency lines; its mae (a regression) or its
    accuracy on the binarized labels (a classification) against the CPU
    ``reference``'s on the same (synthetic MOSI) test set."""
    from factorized_tpu_torch import cli
    from factorized_tpu_torch.utils.metrics import (classification_metrics,
                                                    regression_metrics)

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["test_mosi", "--checkpoint", ckpt])
    seconds = time.perf_counter() - t0
    lines = {}
    for line in out.getvalue().splitlines():
        key, _, value = line.partition(":")
        if key in ("mae", "inference probe", "on-device latency"):
            lines[key] = value.strip()
        elif line.startswith("Accuracy "):
            lines["accuracy"] = line.split()[1]
    regression = reference.cfg.task == "regression"
    want_lines = {"accuracy", "inference probe", "on-device latency"} | (
        {"mae"} if regression else set())
    if rc != 0 or set(lines) != want_lines:
        raise AssertionError(f"test_mosi gave {rc}: {out.getvalue()[-2000:]}")
    _, _, _, _, X_test, y_test = cli.load_mosi(seqlength)
    y_cpu = reference.predict(X_test)
    if regression:
        m = regression_metrics(y_cpu, y_test)
        got, want = float(lines["mae"]), m["mae"]
    else:
        m = classification_metrics(y_cpu, (y_test >= 0).astype(np.int64))
        got, want = float(lines["accuracy"]), m["accuracy"]
    if not abs(got - want) <= ATOL + RTOL * abs(want):
        raise AssertionError(f"test_mosi {'mae' if regression else 'acc'} "
                             f"{got}, the CPU's {want}")
    return {"rc": rc, "seconds": seconds,
            "mae": float(lines["mae"]) if regression else None,
            "cpu_mae": m["mae"] if regression else None,
            "accuracy": float(lines["accuracy"]),
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
              18: lambda: baseline_phase(cfg, dev, smi, data, tmp),
              19: lambda: predictor_phase(cfg, dev, smi, tmp),
              20: lambda: lanes_phase(cfg, dev, smi, tmp),
              21: lambda: bucket_evolve_phase(cfg, dev, smi, tmp),
              23: lambda: sdk_phase(cfg, dev, smi, tmp),
              24: lambda: modular_phase(dev, smi),
              25: lambda: jax_checkpoint_phase(smi),
              26: lambda: distributed_phase(cfg, smi, tmp)}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for step, run in phases.items():
            t0 = time.perf_counter()
            results[step] = run()
            log({"phase": "seconds", "step": step,
                 "seconds": time.perf_counter() - t0})
    train_kernels, variant_kernels, probe_kernels = (results[6], results[8],
                                                     results[10])
    kernels = serve_kernels + train_kernels + variant_kernels + probe_kernels
    # step 19's, 20's, 21's, 23's, 25's and 26's paths launch the main path's
    # kernels at their shapes (steps 20's, 21's and some of 23's over lanes)
    lane_kernels, lane_paths, lane_launches = results[20]
    past_kernels, past_paths, past_launches = results[21]
    sdk_paths, sdk_lanes = results[23]
    dist_plain, dist_lanes = results[26]
    for entry in kernels:
        entry["launches"] += sum(path.get(entry["name"], 0)
                                 for path in [*results[19].values(),
                                              *lane_paths.values(),
                                              *past_paths.values(),
                                              *sdk_paths.values(),
                                              results[25], dist_plain])
    lane_launches = {k: lane_launches.get(k, 0) + sdk_lanes.get(k, 0)
                     + dist_lanes.get(k, 0)
                     for k in {*lane_launches, *sdk_lanes, *dist_lanes}}
    # each kernel entry point over 8 lanes (step 20a's train shapes) and
    # 16 (step 21a's), its launches the lane launches of step 20's and
    # 23's paths (up to 8 lanes: one launch a call) and of step 21's
    for lanes, launched in ((lane_kernels, lane_launches),
                            (past_kernels, past_launches)):
        for name, (source, replaces) in LANE_KERNELS.items():
            k = lanes[name]
            kernels.append({
                "name": f"{name}.lanes{k['lanes']}", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": launched.get(name, 0),
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k["library_ms"]})
    log({"kernels": kernels})
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
    decb4_library_ms = decoder_library_ms(h4, c4, wsum, b, t, dec_dims,
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
                                 "library_ms": decb4_library_ms,
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
    final parameters, the optimizer's state (Adam's or the SGD's trace)
    and the scheduler's, bit for bit (the lr as float32).
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
        "optimizer": all(
            same_bits(v, gset.optimizer.state_dict()["state"][k])
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


def cell_library_ms(cells, xs, backward=False, reps=50):
    """The yardstick of the fused encoder-cell kernels, used nowhere in the
    port: one ``torch.nn.LSTM`` (cuDNN) per cell over its input (the input
    projection included); forward ms, or with ``backward`` (forward +
    backward) - forward, the last hidden states' cotangent all ones;
    ``reps`` calls each."""
    dev = xs[0].device
    lstms = [torch.nn.LSTM(xi.shape[2], c["wh"].shape[0]).to(dev)
             for c, xi in zip(cells, xs)]
    # copies outside inference mode, which autograd can record
    xs = [xi.clone() for xi in xs]
    if not backward:
        with torch.inference_mode():
            return cuda_ms(lambda: [m(xi) for m, xi in zip(lstms, xs)],
                           reps)
    xs = [xi.requires_grad_() for xi in xs]

    def forward():
        return [m(xi)[1][0] for m, xi in zip(lstms, xs)]

    def both():
        hs = forward()
        torch.autograd.backward(hs, [torch.ones_like(h) for h in hs])

    return cuda_ms(both, reps) - cuda_ms(forward, reps)


def ablation_kernels(model_type, cfg, params, dev, smi):
    """The kernels at the shapes ``model_type`` gives them (``kernels_at``
    at n = 256 and 32): the encode (m_a: one encoder cell over the whole
    input, z_tot 32; m_c: none, z_tot 0), the encoder trio (m_b, m_d),
    the decoder trio."""
    from factorized_tpu_torch.models import ablations
    from factorized_tpu_torch.models.common import split_modalities

    enc = params.get("enc", {})
    return kernels_at(
        model_type, cfg,
        lambda x: ablations.kernel_operands(params, x, cfg, model_type),
        dev, smi, N_SERVE, N_TRAIN,
        cells=lambda x: ([enc[k]["lstm"] for k in
                          ("encoder_l", "encoder_a", "encoder_v")],
                         split_modalities(x, cfg.input_dims)))


def kernels_at(label, cfg, operands, dev, smi, n_eval, n_train, cells=None,
               phase="ablation_kernels"):
    """The kernels at the shapes ``operands(x)`` gives them (a dict as
    ``ablations.kernel_operands``'), against their plain versions and
    timed beside their bounds and library yardsticks: the encode eval at
    ``n_eval`` rows (None: not run), its train forward, reverse pass and
    weight gradients (beside 7 ``torch.mm`` and 7 ``sum(0)``) at
    ``n_train``; the fused encoder cells (``multi_lstm``) likewise, beside
    one ``nn.LSTM`` a cell of ``cells(x)`` (the cells, their inputs); the
    decoder trio forward and backward at ``n_train``. Each with the plan
    its chains took (``plan``, the wrapper's ``CLUSTERS`` entry: the
    cluster, 0 the weights read from L2, ``cuda_lstm.SCRATCH`` the state in
    device memory). Logs one ``phase`` line; returns {kernel: numbers}."""
    from factorized_tpu_torch import perf_probe
    from factorized_tpu_torch.models.common import mfn_drops
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

    def plan(module, kernel, chains=None):
        """The last call's plan: the encode's by chain (its launcher
        reports them in the order ``chains``), the recurrences' one."""
        entry = module.CLUSTERS[kernel]
        return dict(zip(chains, entry)) if chains else entry

    fwd_chains = ("lstm_chains", "memory_chain")
    bwd_chains = ("memory_chain", "lstm_chains")

    with torch.inference_mode():
        x_eval, x_train = (None if n is None else torch.randn(
            (t, n, cfg.d_total), generator=gen, device=dev)
            for n in (n_eval, n_train))
        ops_eval = {} if x_eval is None else operands(x_eval)
        ops_train = operands(x_train)
        if "encode" in ops_eval:
            xp, weights, z_tot, h_dims = ops_eval["encode"]
            n = n_eval
            got = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
            used_plan = plan(cuda_mfn, "mfm_encode_fwd", fwd_chains)
            err = compare_all(f"{label}.mfm_encode_fwd.eval", zip(
                ("h_last", "mem_last"), got,
                cuda_mfn.mfm_encode_plain(xp, weights, z_tot)))
            bnd = bound(2 * n * (t * encode_macs_per_row(weights, h_dims,
                                                         z_tot)
                                 - 4 * sum(h * h for h in h_dims)),
                        nbytes(xp, *off_diag(weights), *got)
                        + diag_bytes(h_dims))
            record("mfm_encode_fwd_eval", n, err, timed(
                lambda: cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
                lambda: cuda_mfn.mfm_encode_plain(xp, weights, z_tot)), bnd,
                h_dims=h_dims, z_tot=z_tot, plan=used_plan)
        if "encode" in ops_train:
            xp, weights, z_tot, h_dims = ops_train["encode"]
            n = n_train
            masks = cuda_mfn.make_dropout_masks(
                gen, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(cfg))
            fwd = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
            used_plan = plan(cuda_mfn, "mfm_encode_fwd", fwd_chains)
            fwd_ref = cuda_mfn.mfm_encode_res_plain(xp, masks, weights,
                                                    z_tot)
            err = compare_all(f"{label}.mfm_encode_fwd.train",
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
                                                      z_tot)), bnd,
                h_dims=h_dims, z_tot=z_tot, plan=used_plan)
            res = fwd_ref[2:]
            dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
            dmem = torch.randn((n, cfg.memsize), generator=gen, device=dev)

            def bwd():
                return cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem,
                                            z_tot, h_dims)

            dxp, deltas = bwd()
            used_plan = plan(cuda_mfn, "mfm_encode_bwd", bwd_chains)
            dxp_ref, deltas_ref = cuda_mfn.mfm_encode_bwd_steps_plain(
                xp, weights, *res, dh, dmem, z_tot)
            err = compare_all(f"{label}.mfm_encode_bwd",
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
                plan=used_plan)

            def dw():
                return cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                           deltas_ref, z_tot)

            dw_out = dw()
            dw_ref = cuda_mfn.mfm_encode_dw_plain(res[1], res[2], res[3],
                                                  deltas_ref, weights, z_tot)
            err = compare_all(f"{label}.mfm_encode_dw", [
                (k, dw_out[k], v) for k, v in dw_ref.items()],
                GRAD_RTOL, GRAD_ATOL)
            # the yardstick, used nowhere in the port, on operands built
            # here, before the timing
            lib = functools.partial(
                perf_probe.dw_library, cuda_mfn.dw_operands(
                    res[1], res[2], res[3], weights, z_tot), deltas_ref,
                weights)
            compare_all(f"{label}.mfm_encode_dw.library",
                        [(k, v, dw_ref[k].reshape(v.shape))
                         for k, v in lib().items()], GRAD_RTOL, GRAD_ATOL)
            record("mfm_encode_dw", n, err, timed(
                dw, lambda: cuda_mfn.mfm_encode_dw_plain(
                    res[1], res[2], res[3], deltas_ref, weights, z_tot)),
                dw_bound_of(res, deltas_ref, dw_out),
                functools.partial(cuda_ms, lib, 50),
                plan=dict(cuda_mfn.DW_PLAN))
        if "multi_lstm" in ops_eval:
            xp, wh, h_dims = ops_eval["multi_lstm"]
            n = n_eval
            got = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims)
            used_plan = plan(cuda_lstm, "multi_lstm_fwd")
            err = compare(f"{label}.multi_lstm_fwd.eval", got,
                          cuda_lstm.multi_lstm_plain(xp, wh))
            hh = 4 * sum(h * h for h in h_dims)
            bnd = bound(2 * (t - 1) * n * hh,
                        nbytes(xp, got) + diag_bytes(h_dims))
            record("multi_lstm_fwd_eval", n, err, timed(
                lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims),
                lambda: cuda_lstm.multi_lstm_plain(xp, wh)), bnd,
                functools.partial(cell_library_ms, *cells(x_eval)),
                h_dims=h_dims, plan=used_plan)
        if "multi_lstm" in ops_train:
            xp, wh, h_dims = ops_train["multi_lstm"]
            n = n_train
            hh = 4 * sum(h * h for h in h_dims)
            res = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims, with_res=True)
            used_plan = plan(cuda_lstm, "multi_lstm_fwd")
            res_ref = cuda_lstm.multi_lstm_plain(xp, wh, with_res=True)
            err = compare_all(f"{label}.multi_lstm_fwd.train",
                              zip(("h_last", "allh", "allc", "gates"), res,
                                  res_ref))
            bnd = bound(2 * (t - 1) * n * hh,
                        nbytes(xp, *res) + diag_bytes(h_dims))
            record("multi_lstm_fwd_train", n, err, timed(
                lambda: cuda_lstm.multi_lstm_fwd(xp, wh, h_dims, True),
                lambda: cuda_lstm.multi_lstm_plain(xp, wh, True)), bnd,
                functools.partial(cell_library_ms, *cells(x_train)),
                h_dims=h_dims, plan=used_plan)
            _, _, allc, gates = res_ref
            dh = torch.randn((n, sum(h_dims)), generator=gen, device=dev)
            dxp = cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims)
            used_plan = plan(cuda_lstm, "multi_lstm_bwd")
            err = compare(f"{label}.multi_lstm_bwd.dxp", dxp,
                          cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh),
                          GRAD_RTOL, GRAD_ATOL)
            bnd = bound(2 * (t - 1) * n * hh,
                        nbytes(gates, allc, dh, dxp) + diag_bytes(h_dims))
            record("multi_lstm_bwd", n, err, timed(
                lambda: cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims),
                lambda: cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh)),
                bnd, functools.partial(cell_library_ms, *cells(x_train),
                                       backward=True),
                plan=used_plan)
        if "decoder" in ops_train:
            h0, c0, wsum, b, dec_dims = ops_train["decoder"]
            n = n_train
            outs = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)
            used_plan = plan(cuda_lstm, "decoder_lstm_fwd")
            allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b,
                                                             t)
            err = compare_all(f"{label}.decoder_lstm_fwd",
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
                   dec_dims=dec_dims, plan=used_plan)
            dallh = torch.randn(allh.shape, generator=gen, device=dev)
            dec = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                             dec_dims)
            used_plan = plan(cuda_lstm, "decoder_lstm_bwd")
            err = compare_all(f"{label}.decoder_lstm_bwd",
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
                   plan=used_plan)
    torch.cuda.synchronize()
    for name, run in library.items():
        out[name]["library_ms"] = run()
    log({"phase": phase, "model_type": label, "nvidia_smi": smi, **out})
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


# Step 25: the release's scores on the synthetic MOSI test set
# (VALIDATION.md §4), within 1e-6
RELEASE_SCORES = {"mfn_mae": {"mae": 0.6101879, "accuracy": 0.8250729},
                  "mfn_acc": {"accuracy": 0.7813411}}
# the real MOSI files' scale for the segment average: CMU-MOSI's 93
# videos, FACET's 43 feature columns at 30 fps, about 280 words a video
SEGAVG_VIDEOS, SEGAVG_DIM, SEGAVG_FPS = 93, 43, 30


def jax_checkpoint_phase(smi):
    """Step 25: the JAX package's checkpoints read by the port. For
    ``best/mfn_mae`` and ``best/mfn_acc`` (Orbax stores: OCDBT, zarr
    chunks in zstd frames): the read by ``restore_checkpoint`` (no Orbax,
    tensorstore or zstd package needed; its seconds), every leaf
    bit for bit ``factorized_tpu_torch/released/<name>``'s; ``test_mosi
    --checkpoint best/<name>`` on the card through ``test_mosi_on``, its
    scores the release's within 1e-6, the eval encode launched and
    counted; ``Predictor.from_checkpoint("best/<name>")`` served over
    HTTP, every reply against the CPU ``Predictor`` over ``released/``.
    Then ``segavg_check``. Returns {"mfm_encode_fwd": launches}."""
    import importlib.util
    import os

    from factorized_tpu_torch.convert import to_state_dict
    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(SEED + 250)
    installed = {m: importlib.util.find_spec(m) is not None
                 for m in ("orbax", "tensorstore", "zstandard", "msgpack")}
    total = 0
    for name, scores in RELEASE_SCORES.items():
        path = os.path.join(root, "best", name)
        released = os.path.join(root, "factorized_tpu_torch", "released",
                                name)
        t0 = time.perf_counter()
        state, meta = restore_checkpoint(path)
        read_s = time.perf_counter() - t0
        kept, kept_meta = restore_checkpoint(released)
        got, want = to_state_dict(state["params"]), to_state_dict(
            kept["params"])
        if sorted(got) != sorted(want) or len(got) != 77:
            raise AssertionError(f"best/{name} holds {sorted(got)}")
        for k, v in want.items():
            if got[k].dtype != v.dtype or not torch.equal(got[k], v):
                raise AssertionError(f"best/{name} leaf {k} differs from "
                                     f"released/{name}")
        if (meta["format"] != "orbax" or meta["step"] != kept_meta["step"]
                or meta["config"] != kept_meta["config"]):
            raise AssertionError(f"best/{name} meta {meta}")
        reference = Predictor.from_checkpoint(released, device="cpu")
        scored, _, launches = counted(
            f"test_mosi best/{name}", ("mfm_encode_fwd",),
            lambda: test_mosi_on(path, 20, reference))
        for key, v in scores.items():
            if not abs(scored[key] - v) <= 1e-6:
                raise AssertionError(f"test_mosi best/{name} {key} "
                                     f"{scored[key]}, the release's {v}")
        requests = [np.round(rng.normal(size=(r, 20, 325)), 3)
                    .astype(np.float32) for r in (1, 17, 256, 300)]
        expected = split_rows(reference.predict(np.concatenate(requests)),
                              requests)
        predictor = Predictor.from_checkpoint(path)
        (worst, batches), _, served = counted(
            f"serve best/{name}", ("mfm_encode_fwd",),
            lambda: serve_requests(predictor, expected, requests))
        del predictor
        n = launches["mfm_encode_fwd"] + served["mfm_encode_fwd"]
        total += n
        log({"phase": "jax_checkpoint", "name": name, "nvidia_smi": smi,
             "installed": installed, "read_s": read_s, "leaves": len(got),
             "test_mosi": {k: scored[k] for k in ("mae", "accuracy")},
             "release": scores, "test_mosi_s": scored["seconds"],
             "serve_max_abs_err_vs_cpu": worst, "batches_run": batches[0],
             "launches": {"test_mosi": launches["mfm_encode_fwd"],
                          "serve": served["mfm_encode_fwd"]}})
    segavg_check(smi)
    return {"mfm_encode_fwd": total}


def segavg_frames(rng):
    """One video's FACET rows and word windows, fabricated at the real
    files' scale: 3,000 to 9,000 rows, about 280 words of 0.1 to 1 s at
    30 fps, with every kind of window: empty, reversed, clipped at either
    end, and over NaN, -inf and +inf rows."""
    n = int(rng.integers(3000, 9000))
    feats = rng.standard_normal((n, SEGAVG_DIM)).astype(np.float32)
    feats[rng.integers(0, n, 4)] = np.nan
    feats[rng.integers(0, n, 2), rng.integers(0, SEGAVG_DIM, 2)] = -np.inf
    feats[rng.integers(0, n, 2), rng.integers(0, SEGAVG_DIM, 2)] = np.inf
    words = int(rng.integers(200, 360))
    t = np.sort(rng.uniform(0, n / SEGAVG_FPS, words))
    starts = (t * SEGAVG_FPS).astype(np.int64)
    ends = ((t + rng.uniform(0.1, 1.0, words)) * SEGAVG_FPS).astype(np.int64)
    ends[:3] = starts[:3]                            # empty
    ends[3:5] = starts[3:5] - 2                      # reversed
    starts[5], ends[-1] = -7, n + 40                 # clipped
    return feats, starts, ends


def segavg_check(smi):
    """The C++ segment average (``native.py``, built here with the host
    compiler) against its numpy version (``data/segavg.py``) bit for bit
    on ``SEGAVG_VIDEOS`` fabricated videos, as the real MOSI reader calls
    it (once a video); the build's seconds and each version's ms over all
    the videos."""
    from factorized_tpu_torch import native
    from factorized_tpu_torch.data.segavg import segment_average

    rng = np.random.default_rng(SEED + 251)
    videos = [segavg_frames(rng) for _ in range(SEGAVG_VIDEOS)]
    t0 = time.perf_counter()
    native.load_library()
    build_s = time.perf_counter() - t0
    native_s = plain_s = 0.0
    for feats, starts, ends in videos:
        t0 = time.perf_counter()
        got = native.segment_average(feats, starts, ends)
        native_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = segment_average(feats, starts, ends)
        plain_s += time.perf_counter() - t0
        if got.dtype != want.dtype or not np.array_equal(
                got.view(np.uint32), want.view(np.uint32)):
            raise AssertionError("the C++ segment average differs from "
                                 "data/segavg.py")
    log({"phase": "segavg", "nvidia_smi": smi, "compiler":
         native.compiler(), "library": str(native.library_path()),
         "build_s": build_s, "videos": SEGAVG_VIDEOS,
         "frames": sum(len(v[0]) for v in videos),
         "words": sum(len(v[1]) for v in videos), "dim": SEGAVG_DIM,
         "native_ms": native_s * 1e3, "plain_ms": plain_s * 1e3,
         "bit_equal": True})


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
    validation, the reverse pass, both decoder kernels). Its step's
    estimated FLOPs pass the crossover, so the gate would train it on the
    modular path: the run forces the fused one (``models.mfm.FUSED``)."""
    import os

    from factorized_tpu_torch.models import mfm

    wide = cfg.replace(h_dims=[1400, 64, 48], zl_size=600,
                       fv_size=3000 - cfg.fy_size, batchsize=128)
    path = os.path.join(tmp, "c1.json")
    with open(path, "w") as f:
        json.dump(wide.to_dict(), f)
    out = os.path.join(tmp, "c1_runs")
    kernels = ABLATION_TRAIN["m_a"]
    gate_fused = mfm.fused_active(wide)
    saved, mfm.FUSED = mfm.FUSED, True
    try:
        seconds, launches, scratch = mosi_cli(
            ["--config", path, "--epochs", "2", "--out", out,
             "--seed", str(SEED)], "mosi --config (C1 widths)", kernels)
    finally:
        mfm.FUSED = saved
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
         "gate_fused": gate_fused, "forced_fused": True,
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


def path_times(loop, steps=5, replays=3, profile_replay=True):
    """A training path's times from the chunked loop its trainer ran (its
    epoch graph captured): device ms and kernel launches a step and the
    device's idle share (torch.profiler over ``steps`` eager steps on the
    loop's first batch), replayed epoch s (host clock, median of
    ``replays`` ``run(1)``s, its host read included) and, with
    ``profile_replay``, device ms of a replayed epoch (torch.profiler over
    one), with the idle share against the unprofiled epoch's wall (None
    without: at MOSEI's 415 steps the profiler's host work on a replay's
    389,000 kernels takes about 45 s)."""
    from torch.profiler import ProfilerActivity, profile

    Xb, yb, rem = loop.batches
    prof = profile_steps(loop.program, loop.params, loop.opt, Xb[0], yb[0],
                         loop.generator, steps)
    replay_s = []
    for _ in range(replays):
        t0 = time.perf_counter()
        loop.run(1)
        replay_s.append(time.perf_counter() - t0)
    epoch_s = float(np.median(replay_s))
    kernels, device_ms = [], None
    if profile_replay:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            loop.run(1)
        kernels = [e for e in p.key_averages() if on_device(e)]
        if not kernels:
            raise AssertionError("torch.profiler saw no kernel of a replay")
        device_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {"batches": int(Xb.shape[0]), "batch": int(Xb.shape[2]),
            "remainder_rows": 0 if rem is None else int(rem[0].shape[1]),
            "device_ms_per_step": prof["device_ms_per_step"],
            "launches_per_step": prof["kernel_launches_per_step"],
            "eager_step_device_idle_share": prof["device_idle_share"],
            "replayed_epoch_s": epoch_s, "replayed_epoch_s_all": replay_s,
            "device_ms_per_replayed_epoch": device_ms,
            "replayed_device_idle_share": (
                None if device_ms is None else 1.0 - device_ms / (epoch_s
                                                                  * 1e3)),
            "kernels_seen_per_replayed_epoch": (
                sum(e.count for e in kernels) if profile_replay else None),
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


# Step 19: the predictor command's baselines (eflstm and self_attention:
# one multi_lstm cell; mfn: the encode with no encoder cell), the flat SGD,
# test_attention and multitrait (MFM at a vector output)
PREDICTOR_TRAIN = {"eflstm": ("multi_lstm_fwd", "multi_lstm_bwd"),
                   "self_attention": ("multi_lstm_fwd", "multi_lstm_bwd"),
                   "mfn": ("mfm_encode_fwd", "mfm_encode_bwd",
                           "mfm_encode_dw")}
PREDICTOR_HIDDEN = 128
PREDICTOR_DROP = 0.5
# the best MFN configs' batch
N_MFN = 128


def serve_check(label, ckpt, kernel, rng):
    """A checkpoint served through the ``Predictor``'s graphs over HTTP,
    each reply against the CPU ``Predictor``'s; one launch of ``kernel`` a
    padded chunk and no other recurrence; the padded 256-row predict's
    median ms, ``device_latency``, the capture's ms and pool bytes.
    Returns (the line's numbers, the serving launches of ``kernel``)."""
    from factorized_tpu_torch.serve import Predictor

    predictor = Predictor.from_checkpoint(ckpt)
    reference = Predictor.from_checkpoint(ckpt, device="cpu")
    cfg = predictor.cfg
    t, d = cfg.seqlength, cfg.d_total
    requests = [np.round(rng.normal(size=(r, t, d)), 3).astype(np.float32)
                for r in ABLATION_SIZES]
    X = np.round(rng.normal(size=(N_SERVE, t, d)), 3).astype(np.float32)
    expected = split_rows(reference.predict(np.concatenate(requests)),
                          requests)
    (worst, batches), seconds, served = counted(
        f"serve {label}", (kernel,),
        lambda: serve_requests(predictor, expected, requests))
    idle = {name: served[name] for name in SERVE_IDLE
            if name != kernel and served[name]}
    if idle:
        raise AssertionError(f"serving {label} launched {idle}")
    y, _, per_predict = counted(f"predict {label}", (kernel,),
                                lambda: predictor.predict(X))
    per_predict = {name: per_predict[name] for name in SERVE_IDLE}
    if per_predict[kernel] != 1:
        raise AssertionError(f"one padded predict of {label} launched "
                             f"{per_predict}")
    err = compare(f"serve.{label}.predict", torch.from_numpy(y),
                  torch.from_numpy(reference.predict(X)))
    return {"reply_shape": list(y.shape), "requests": len(requests),
            "batches_run": batches[0],
            "max_abs_err_vs_cpu": max(worst, err["max_abs_err"]),
            "launches_per_padded_predict": per_predict,
            "predict_ms": median_ms(lambda: predictor.predict(X)),
            "device_latency": predictor.device_latency(X, iters=100),
            **predictor.graph_stats()[N_SERVE], "http_s": seconds,
            "test_mosi": (test_mosi_on(ckpt, t, reference)
                          if cfg.model_type == "mfn" else None)}, \
        served[kernel]


def predictor_loss(forward):
    """``train_predictor``'s regression loss over its ``forward``, with the
    draws injected: (loss, loss)."""
    from factorized_tpu_torch.ops.losses import l1_loss

    def loss_fn(params, x, y, draws=None):
        loss = l1_loss(forward(params, x, True, None, draws), y)
        return loss, loss

    return loss_fn


def command_run(command, argv, run_id, kernels, tmp, printed_key=None):
    """``python -m factorized_tpu_torch <command> <argv> --epochs 2`` in
    this process, counted (``mosi_cli``): finite, falling train losses in
    the run's log, every kernel of ``kernels`` launched, the second epoch
    a graph replay, ``printed_key`` (a score line's start) printed.
    Returns (its line's numbers, launches, the chunked loop, --out)."""
    import os

    runs = os.path.join(tmp, f"{command}_{run_id}")
    argv = [*argv, "--epochs", str(TRAIN_EPOCHS)]
    printed = io.StringIO()
    with chunked_loops() as loops, contextlib.redirect_stdout(printed):
        seconds, launches, _ = mosi_cli(
            [*argv, "--seed", str(SEED), "--out", runs],
            f"{command} {' '.join(argv)}", kernels, command=command)
    records = epoch_records(os.path.join(runs, f"{run_id}.jsonl"))
    losses = falling_finite(records, f"{command} {run_id}")
    score = [line for line in printed.getvalue().splitlines()
             if line.startswith(printed_key or "mae")]
    if not score:
        raise AssertionError(f"{command} {argv}: no score line printed: "
                             f"{printed.getvalue()[-2000:]}")
    loop = graph_replayed(loops, f"{command} {run_id}")
    return {"command": [command, *argv], "train_loss": losses,
            "valid": [r["valid_loss"] for r in records],
            "lr": [r["lr"] for r in records], "score_lines": score[:3],
            "launches": launches,
            "epoch_launches": [per_kernel(e) for e in loop.epoch_launches],
            "run_s": seconds}, launches, loop, runs


def predictor_phase(cfg, dev, smi, tmp):
    """Step 19. (a) The kernels at the shapes this step's paths give them
    (``kernels_at``): the encode's train forward, reverse pass and weight
    gradients at n = 128 for both ``best_mfn_mosi_config``s and its eval
    at n = 256 for ``mae``; ``multi_lstm``'s train forward and backward
    for one 128-unit cell over the 325-float MOSI input at n = 32 and 128.
    (b) One train step's gradients on the card against the CPU's with the
    same injected draws: ``eflstm`` and ``self_attention`` (n = 32),
    ``mfn`` at both configs (n = 128) and ``multitrait``'s MFM at 17
    traits (n = 32). (c) ``predictor --kind eflstm --optimizer sgd``,
    ``--kind self_attention`` and ``--kind mfn --mode best --best mae
    --save-ckpt``, 2 epochs each through the command: finite falling
    losses, every kernel launched, the second epoch a replay; the flat SGD
    through the graph loop against the host loop bit for bit; the ``mfn``
    checkpoint scored by ``test_mosi`` and served against the CPU. (d)
    ``test_attention``. (e) ``multitrait --style pom --save-ckpt`` and
    ``--style iemocap``, ``--mode best``: MFM's encode and decoder kernels
    launched, the ``mae: [..]`` line printed, the ``pom`` checkpoint
    served (n, 17) against the CPU. (f) For each path its device ms and
    launches a step, replayed epoch s, idle share, capture ms and pool
    bytes (``path_times``; ``predictor`` lines). Returns {path:
    launches}."""
    import os

    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.config import best_mfn_mosi_config
    from factorized_tpu_torch.data import mosi, multitrait
    from factorized_tpu_torch.models import baselines, mfm
    from factorized_tpu_torch.models.common import mfn_drops, split_modalities
    from factorized_tpu_torch.ops import cuda_mfn
    from factorized_tpu_torch.ops.fused import encode_operands, lstm_operands
    from factorized_tpu_torch.train import make_loss_fn

    t, d = cfg.seqlength, cfg.d_total
    rng = np.random.default_rng(SEED + 160)
    mfn_cfgs = {k: best_mfn_mosi_config(k) for k in ("mae", "acc")}
    out = {}

    # (a) the kernels at the new shapes
    t0 = time.perf_counter()
    for kind, mcfg in mfn_cfgs.items():
        mfn_params = mfm.MFM(mcfg, seed=SEED + 161, device=dev,
                             model_type="mfn").tree()["mfn"]
        kernels_at(
            f"mfn_{kind}", mcfg,
            lambda x: {"encode": encode_operands(
                [], mfn_params, *split_modalities(x, mcfg.input_dims), ())},
            dev, smi, N_SERVE if kind == "mae" else None, N_MFN,
            phase="predictor_kernels")
    cell = {k: v.to(dev) for k, v in baselines.eflstm_init(
        torch.Generator().manual_seed(SEED + 162), d, PREDICTOR_HIDDEN,
        1)["lstm"].items()}
    for n in (N_TRAIN, N_MFN):
        kernels_at(f"one_cell_n{n}", cfg,
                   lambda x: {"multi_lstm": lstm_operands([cell], [x])},
                   dev, smi, None, n, cells=lambda x: ([cell], [x]),
                   phase="predictor_kernels")
    log({"phase": "seconds", "step": "19a",
         "seconds": time.perf_counter() - t0})

    # (b) one train step's gradients, card against the CPU
    t0 = time.perf_counter()
    grads = {}
    cpu = torch.Generator().manual_seed(SEED + 163)
    for label, kind, pcfg, n in (
            ("eflstm", "eflstm", cfg, N_TRAIN),
            ("self_attention", "self_attention", cfg, N_TRAIN),
            ("mfn_mae", "mfn", mfn_cfgs["mae"], N_MFN),
            ("mfn_acc", "mfn", mfn_cfgs["acc"], N_MFN)):
        params, forward = trainers._predictor(
            kind, pcfg, d, PREDICTOR_HIDDEN, t, PREDICTOR_DROP, SEED)
        x = torch.randn((t, n, d), generator=cpu)
        y = torch.randn((n,), generator=cpu)
        grads[label] = grads_vs_cpu(
            f"{label}.train_step_grads_vs_cpu", predictor_loss(forward),
            params, x, y, baselines.predictor_draws(
                kind, pcfg, n, cpu, h=PREDICTOR_HIDDEN,
                drop=PREDICTOR_DROP), dev)["max_abs_err"]
    traits = len(multitrait.POM_TRAITS)
    mt_cfg = cfg.replace(input_dims=multitrait.INPUT_DIMS,
                         output_dim=traits)
    x = torch.randn((t, N_TRAIN, mt_cfg.d_total), generator=cpu)
    y = torch.randn((N_TRAIN, traits), generator=cpu)
    grads["multitrait_pom"] = grads_vs_cpu(
        "multitrait_pom.train_step_grads_vs_cpu",
        make_loss_fn(mfm.mfm_apply, mt_cfg),
        mfm.MFM(mt_cfg, seed=SEED + 164, device=dev).tree(), x, y, {
            "encode_masks": cuda_mfn.make_dropout_masks(
                cpu, t, N_TRAIN, (mt_cfg.att1_shape, mt_cfg.att2_shape,
                                  mt_cfg.gamma1_shape, mt_cfg.gamma2_shape),
                mfn_drops(mt_cfg)),
            "mmd_noise": torch.randn(mfm.mmd_noise_shape(mt_cfg, N_TRAIN),
                                     generator=cpu),
            "zf_masks": zf_masks(mt_cfg, N_TRAIN, cpu)}, dev)["max_abs_err"]
    log({"phase": "predictor_grads", "nvidia_smi": smi,
         "max_abs_err": grads, "seconds": time.perf_counter() - t0})

    # (c) the predictor command, (d) test_attention, (e) multitrait
    runs = {
        "eflstm_sgd": ("predictor", ["--kind", "eflstm", "--optimizer",
                                     "sgd", "--mode", "best"], "eflstm_0",
                       PREDICTOR_TRAIN["eflstm"], None),
        "self_attention": ("predictor", ["--kind", "self_attention",
                                         "--mode", "best"],
                           "self_attention_0",
                           PREDICTOR_TRAIN["self_attention"], None),
        "mfn_mae": ("predictor", ["--kind", "mfn", "--mode", "best",
                                  "--best", "mae", "--save-ckpt"], "mfn_0",
                    PREDICTOR_TRAIN["mfn"], "mfm_encode_fwd"),
        "test_attention": ("test_attention", [], "self_attention",
                           PREDICTOR_TRAIN["self_attention"], None),
        "multitrait_pom": ("multitrait", ["--style", "pom", "--mode", "best",
                                          "--save-ckpt"], "pom_0",
                           ABLATION_TRAIN["m_a"], "mfm_encode_fwd"),
        "multitrait_iemocap": ("multitrait", ["--style", "iemocap", "--mode",
                                              "best"], "iemocap_0",
                               ABLATION_TRAIN["m_a"], None),
    }
    for label, (command, argv, run_id, kernels, serving) in runs.items():
        t0 = time.perf_counter()
        line, launches, loop, out_dir = command_run(
            command, argv, run_id, kernels, tmp,
            "mae: [" if command == "multitrait" else "mae")
        out[label] = launches
        if serving is not None:
            ckpt = os.path.join(out_dir, "ckpt_" + run_id)
            line["serve"], served = serve_check(label, ckpt, serving, rng)
            out[f"{label}_serve"] = {serving: served}
        t1 = time.perf_counter()
        line.update(path_times(loop))
        log({"phase": "predictor", "path": label, "nvidia_smi": smi, **line,
             "grads_max_abs_err": grads.get(label.replace("_sgd", "")),
             "seconds": {"all": time.perf_counter() - t0,
                         "times": time.perf_counter() - t1}})

    # the flat SGD: the graph loop against the host loop from one seed
    t0 = time.perf_counter()

    def eflstm_sgd(*data_cfg, **kw):
        return trainers.train_predictor(
            *data_cfg[:6], "eflstm", data_cfg[6], h=PREDICTOR_HIDDEN,
            drop=PREDICTOR_DROP, lr=cfg.lr, optimizer="sgd", **kw)

    data = mosi.get_data(t)
    mcfg = cfg.replace(num_epochs=LOOP_EPOCHS)
    host = trainer_run(eflstm_sgd, data, mcfg, dev, True)
    graph = trainer_run(eflstm_sgd, data, mcfg, dev, False)
    agree = loops_agree("eflstm sgd", host, graph)
    if host[2] != graph[2]:
        raise AssertionError(f"eflstm sgd: launches per epoch differ: host "
                             f"{host[2]}, graph {graph[2]}")
    if set(graph[1].optimizer.state_dict()["state"]) != {"trace"}:
        raise AssertionError("the eflstm sgd run did not train on FlatSGD")
    log({"phase": "predictor_sgd_loop", "nvidia_smi": smi, "bitwise": agree,
         "launches_per_epoch": graph[2], "history": graph[0]["history"],
         "seconds": time.perf_counter() - t0})
    return out


# ---------------------------------------------------------- 20. lanes

LANES = 8
# the kernels of a lane path's train step and evaluation: mfm's and m_b's
LANE_PATHS = {"mfm": ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
                      "decoder_lstm_fwd", "decoder_lstm_bwd"),
              "m_b": ("multi_lstm_fwd", "multi_lstm_bwd", "decoder_lstm_fwd",
                      "decoder_lstm_bwd")}
# the seven kernel entry points with a lane axis, each's kernels-line
# name, source and the TPU kernel it replaces
LANE_KERNELS = {
    "mfm_encode_fwd": ("factorized_tpu_torch/csrc/mfm_encode_fwd.cu",
                       "factorized_tpu/ops/pallas_mfn.py:169"),
    "mfm_encode_bwd": ("factorized_tpu_torch/csrc/mfm_encode_bwd.cu",
                       "factorized_tpu/ops/pallas_mfn.py:269"),
    "mfm_encode_dw": ("factorized_tpu_torch/csrc/mfm_encode_bwd.cu",
                      "factorized_tpu/ops/pallas_mfn.py:269"),
    "decoder_lstm_fwd": ("factorized_tpu_torch/csrc/lstm_fwd.cu",
                         "factorized_tpu/ops/pallas_lstm.py:272"),
    "decoder_lstm_bwd": ("factorized_tpu_torch/csrc/lstm_bwd.cu",
                         "factorized_tpu/ops/pallas_lstm.py:298"),
    "multi_lstm_fwd": ("factorized_tpu_torch/csrc/lstm_fwd.cu",
                       "factorized_tpu/ops/pallas_lstm.py:88"),
    "multi_lstm_bwd": ("factorized_tpu_torch/csrc/lstm_bwd.cu",
                       "factorized_tpu/ops/pallas_lstm.py:116"),
}


def lane_stack(items):
    """Per-lane operands (tensors, dicts of tensors, or the same plain
    value in every lane) stacked along a new lane dimension in front."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items).contiguous()
    if isinstance(first, dict):
        return {k: lane_stack([it[k] for it in items]) for k in first}
    return first


def lane_first(tree):
    """The first lane of stacked operands, its lane dimension kept."""
    if isinstance(tree, torch.Tensor):
        return tree[:1]
    if isinstance(tree, dict):
        return {key: lane_first(v) for key, v in tree.items()}
    return tree


def lane_kernel_phase(cfg, dev, smi, K, timing=True, library=False):
    """Step 20a (and 21a past 8 lanes): each of the seven kernel entry
    points over K lanes at ``cfg``'s full width, lane k a model of its own
    seed and the input shared, against the lane plain version (each
    lane's plain version, on the card): the eval encode at n = 256, the
    train encode (masks, residuals), its reverse pass and weight
    gradients, the decoder trio both ways and ``m_b``'s encoder trio [32,
    8, 80] (``multi_lstm``, train and eval) both ways at n = 32; forward
    within rtol 1e-4 / atol 1e-5, gradients within rtol 1e-3 / atol 2e-5.
    Each call launches once for any K, counted; lane k of each kernel's
    K-lane calls equals lane k's call with a lane axis of one and with
    none bit for bit (``lane_bits``), each call's plan logged.
    With ``timing``, each timed at K lanes and at 1 (device ms, calls
    queued), beside its single-lane launch (no lane axis), its plain
    version at K and its bound at K (K times one lane's: K lanes' work and
    bytes); with ``library`` also its library yardstick lane by lane
    (``lane_library_ms``). Returns {kernel: numbers}; ``missing``'s
    decoder forward over 4n rows (``decoder_lstm_fwd.4n``) is checked and
    timed beside them."""
    from factorized_tpu_torch.models import ablations, mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    t, n, ne = cfg.seqlength, N_TRAIN, N_SERVE
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    x = torch.randn((t, n, cfg.d_total), generator=gen, device=dev)
    xe = torch.randn((t, ne, cfg.d_total), generator=gen, device=dev)
    x4 = torch.randn((t, 4 * n, cfg.d_total), generator=gen, device=dev)
    out = {}
    with torch.inference_mode():
        enc, dec, dec4, enc_e, multi, multi_e = [], [], [], [], [], []
        for k in range(K):
            p = mfm.MFM(cfg, seed=SEED + 100 + k, device=dev).tree()
            e, d = mfm.kernel_operands(p, x, cfg)
            enc.append(e[:2])
            dec.append(d[:4])
            dec4.append(mfm.kernel_operands(p, x4, cfg)[1][:4])
            enc_e.append(mfm.encode_operands(
                [p["enc"][m]["lstm"] for m in mfm._ENCODERS],
                p["mfn_enc"]["mfn"],
                *mfm.split_modalities(xe, cfg.input_dims))[:2])
            pb = mfm.MFM(cfg, seed=SEED + 200 + k, device=dev,
                         model_type="m_b").tree()
            multi.append(ablations.kernel_operands(pb, x, cfg,
                                                   "m_b")["multi_lstm"][:2])
            multi_e.append(ablations.kernel_operands(
                pb, xe, cfg, "m_b")["multi_lstm"][:2])
        z_tot, h_dims, dec_dims = e[2], e[3], d[4]
        m_dims = ablations.kernel_operands(pb, x, cfg, "m_b")["multi_lstm"][2]
        xp, w = lane_stack([a[0] for a in enc]), lane_stack([a[1] for a in
                                                            enc])
        xpe, we = lane_stack([a[0] for a in enc_e]), lane_stack(
            [a[1] for a in enc_e])
        h0, c0, wsum, b = (lane_stack([a[i] for a in dec]) for i in range(4))
        h04, c04, _, b4 = (lane_stack([a[i] for a in dec4])
                           for i in range(4))
        mxp, mwh = lane_stack([a[0] for a in multi]), lane_stack(
            [a[1] for a in multi])
        mxpe, mwhe = lane_stack([a[0] for a in multi_e]), lane_stack(
            [a[1] for a in multi_e])
        w0 = {k: v[0] for k, v in w.items()}
        s1, s2, s3, s4, mem = cuda_mfn.sizes(w0)
        H = sum(h_dims)
        masks = lane_stack([cuda_mfn.make_dropout_masks(
            gen, t, n, (s1, s2, s3, s4), mfn_drops(cfg)) for _ in range(K)])

        def lanes_plain(fn, *args):
            return cuda_lstm._per_lane(fn, K, *args)

        # the eval encode, n = 256
        got = cuda_mfn.mfm_encode_lanes(xpe, we, z_tot, h_dims)
        want = cuda_mfn.mfm_encode_lanes_plain(xpe, we, z_tot)
        err_eval = compare_all("lanes.mfm_encode_fwd.eval",
                               zip(("h_last", "mem_last"), got, want))
        # the train encode, n = 32
        fwd = cuda_mfn.mfm_encode_res_lanes(xp, masks, w, z_tot, h_dims)
        fwd_ref = cuda_mfn.mfm_encode_res_lanes_plain(xp, masks, w, z_tot)
        err_fwd = compare_all("lanes.mfm_encode_fwd.train", zip(
            ("h_last", "mem_last", "allh", "allc", "allmem", "res"), fwd,
            fwd_ref))
        res = fwd_ref[2:]
        dh = torch.randn((K, n, H), generator=gen, device=dev)
        dmem = torch.randn((K, n, mem), generator=gen, device=dev)
        dxp, deltas = cuda_mfn._launch_bwd(xp, w, *res, dh, dmem, z_tot,
                                           h_dims, lanes=K)
        bwd_ref = [cuda_mfn.mfm_encode_bwd_steps_plain(
            xp[k], {m: v[k] for m, v in w.items()}, *(r[k] for r in res),
            dh[k], dmem[k], z_tot) for k in range(K)]
        dxp_ref = torch.stack([r[0] for r in bwd_ref])
        deltas_ref = torch.stack([r[1] for r in bwd_ref])
        err_bwd = compare_all("lanes.mfm_encode_bwd",
                              [("dxp", dxp, dxp_ref),
                               ("deltas", deltas, deltas_ref)],
                              GRAD_RTOL, GRAD_ATOL)
        dw = cuda_mfn._launch_dw(w, res[1], res[2], res[3], deltas_ref,
                                 z_tot, K)
        dw_ref = [cuda_mfn.mfm_encode_dw_plain(
            res[1][k], res[2][k], res[3][k], deltas_ref[k],
            {m: v[k] for m, v in w.items()}, z_tot) for k in range(K)]
        err_dw = compare_all("lanes.mfm_encode_dw", [
            (m, dw[m], torch.stack([r[m] for r in dw_ref]))
            for m in cuda_mfn.DW_NAMES], GRAD_RTOL, GRAD_ATOL)
        # the decoder trio, n = 32
        dfwd = cuda_lstm.decoder_lstm_fwd_lanes(h0, c0, wsum, b, t,
                                                dec_dims)
        dfwd_ref = cuda_lstm.decoder_lstm_lanes_plain(h0, c0, wsum, b, t)
        err_decf = compare_all("lanes.decoder_lstm_fwd", zip(
            ("allh", "allc", "gates"), dfwd, dfwd_ref))
        # missing's four decodes stacked: the decoders over 4n rows
        dfwd4 = cuda_lstm.decoder_lstm_fwd_lanes(h04, c04, wsum, b4, t,
                                                 dec_dims)
        err_decf4 = compare_all("lanes.decoder_lstm_fwd.4n", zip(
            ("allh", "allc", "gates"), dfwd4,
            cuda_lstm.decoder_lstm_lanes_plain(h04, c04, wsum, b4, t)))
        allh, allc, gates = dfwd_ref
        dallh = torch.randn(allh.shape, generator=gen, device=dev)
        dbwd = cuda_lstm.decoder_lstm_bwd_lanes(wsum, gates, allc, dallh,
                                                dec_dims)
        dbwd_ref = cuda_lstm.decoder_lstm_bwd_lanes_plain(wsum, gates, allc,
                                                          dallh)
        err_decb = compare_all("lanes.decoder_lstm_bwd", zip(
            ("dgates", "dh0", "dc0"), dbwd, dbwd_ref), GRAD_RTOL, GRAD_ATOL)
        # m_b's encoder trio: train (residuals) at n = 32, eval at 256
        mf = cuda_lstm.multi_lstm_fwd_lanes(mxp, mwh, m_dims, True)
        mf_ref = cuda_lstm.multi_lstm_lanes_plain(mxp, mwh, True)
        err_mf = compare_all("lanes.multi_lstm_fwd.train", zip(
            ("h_last", "allh", "allc", "gates"), mf, mf_ref))
        mfe = cuda_lstm.multi_lstm_fwd_lanes(mxpe, mwhe, m_dims)
        mfe_ref = cuda_lstm.multi_lstm_lanes_plain(mxpe, mwhe)
        err_mfe = compare("lanes.multi_lstm_fwd.eval", mfe, mfe_ref)
        _, mallh, mallc, mgates = mf_ref
        dhl = torch.randn(mf_ref[0].shape, generator=gen, device=dev)
        mb = cuda_lstm.multi_lstm_bwd_lanes(mgates, mwh, mallc, dhl, m_dims)
        mb_ref = cuda_lstm.multi_lstm_bwd_lanes_plain(mgates, mwh, mallc,
                                                      dhl)
        err_mb = compare("lanes.multi_lstm_bwd", mb, mb_ref, GRAD_RTOL,
                         GRAD_ATOL)
        torch.cuda.synchronize()

        # each call at K lanes, at 1 lane, and (lane 0) with no lane axis
        calls = {
            "mfm_encode_fwd.eval": (
                lambda o: cuda_mfn.mfm_encode_lanes(o[0], o[1], z_tot,
                                                    h_dims),
                (xpe, we),
                lambda: cuda_mfn.mfm_encode(xpe[0], {m: v[0] for m, v in
                                                     we.items()}, z_tot,
                                            h_dims),
                lambda: cuda_mfn.mfm_encode_lanes_plain(xpe, we, z_tot)),
            "mfm_encode_fwd": (
                lambda o: cuda_mfn.mfm_encode_res_lanes(o[0], o[1], o[2],
                                                        z_tot, h_dims),
                (xp, masks, w),
                lambda: cuda_mfn.mfm_encode_res(xp[0], masks[0], w0, z_tot,
                                                h_dims),
                lambda: cuda_mfn.mfm_encode_res_lanes_plain(xp, masks, w,
                                                            z_tot)),
            "mfm_encode_bwd": (
                lambda o: cuda_mfn._launch_bwd(*o, z_tot, h_dims,
                                               lanes=o[0].shape[0]),
                (xp, w, *res, dh, dmem),
                lambda: cuda_mfn._launch_bwd(xp[0], w0, *(r[0] for r in res),
                                             dh[0], dmem[0], z_tot, h_dims),
                lambda: [cuda_mfn.mfm_encode_bwd_steps_plain(
                    xp[k], {m: v[k] for m, v in w.items()},
                    *(r[k] for r in res), dh[k], dmem[k], z_tot)
                    for k in range(K)]),
            "mfm_encode_dw": (
                lambda o: cuda_mfn._launch_dw(o[0], o[1], o[2], o[3], o[4],
                                              z_tot, o[1].shape[0]),
                (w, res[1], res[2], res[3], deltas_ref),
                lambda: cuda_mfn._launch_dw(w0, res[1][0], res[2][0],
                                            res[3][0], deltas_ref[0],
                                            z_tot),
                lambda: [cuda_mfn.mfm_encode_dw_plain(
                    res[1][k], res[2][k], res[3][k], deltas_ref[k],
                    {m: v[k] for m, v in w.items()}, z_tot)
                    for k in range(K)]),
            "decoder_lstm_fwd": (
                lambda o: cuda_lstm.decoder_lstm_fwd_lanes(*o, t, dec_dims),
                (h0, c0, wsum, b),
                lambda: cuda_lstm.decoder_lstm_fwd(h0[0], c0[0], wsum[0],
                                                   b[0], t, dec_dims),
                lambda: cuda_lstm.decoder_lstm_lanes_plain(h0, c0, wsum, b,
                                                           t)),
            "decoder_lstm_fwd.4n": (
                lambda o: cuda_lstm.decoder_lstm_fwd_lanes(*o, t, dec_dims),
                (h04, c04, wsum, b4),
                lambda: cuda_lstm.decoder_lstm_fwd(h04[0], c04[0], wsum[0],
                                                   b4[0], t, dec_dims),
                lambda: cuda_lstm.decoder_lstm_lanes_plain(h04, c04, wsum,
                                                           b4, t)),
            "decoder_lstm_bwd": (
                lambda o: cuda_lstm.decoder_lstm_bwd_lanes(*o, dec_dims),
                (wsum, gates, allc, dallh),
                lambda: cuda_lstm.decoder_lstm_bwd(wsum[0], gates[0],
                                                   allc[0], dallh[0],
                                                   dec_dims),
                lambda: cuda_lstm.decoder_lstm_bwd_lanes_plain(
                    wsum, gates, allc, dallh)),
            "multi_lstm_fwd": (
                lambda o: cuda_lstm.multi_lstm_fwd_lanes(*o, m_dims, True),
                (mxp, mwh),
                lambda: cuda_lstm.multi_lstm_fwd(mxp[0], mwh[0], m_dims,
                                                 True),
                lambda: cuda_lstm.multi_lstm_lanes_plain(mxp, mwh, True)),
            "multi_lstm_fwd.eval": (
                lambda o: cuda_lstm.multi_lstm_fwd_lanes(*o, m_dims),
                (mxpe, mwhe),
                lambda: cuda_lstm.multi_lstm_fwd(mxpe[0], mwhe[0], m_dims),
                lambda: cuda_lstm.multi_lstm_lanes_plain(mxpe, mwhe)),
            "multi_lstm_bwd": (
                lambda o: cuda_lstm.multi_lstm_bwd_lanes(*o, m_dims),
                (mgates, mwh, mallc, dhl),
                lambda: cuda_lstm.multi_lstm_bwd(mgates[0], mwh[0],
                                                 mallc[0], dhl[0], m_dims),
                lambda: cuda_lstm.multi_lstm_bwd_lanes_plain(mgates, mwh,
                                                             mallc, dhl)),
        }
        bits = lane_bits(K, calls)
        times = {}
        for name, (fn, ops, single, plain) in calls.items():
            kernel = name.split(".")[0]
            before = lane_counts().get(kernel, 0)
            fn(ops)
            launched = lane_counts().get(kernel, 0) - before
            if launched != 1:
                raise AssertionError(
                    f"{name} over {K} lanes launched {launched} times, not "
                    f"once")
            times[name] = {"launches_per_call": launched}
            if not timing:
                continue
            ops1 = tuple(lane_first(o) for o in ops)
            times[name].update({
                "device_ms": queued_ms(lambda: fn(ops)),
                "ms": cuda_ms(lambda: fn(ops), 20),
                "device_ms_1_lane": queued_ms(lambda: fn(ops1)),
                "device_ms_no_lane_axis": queued_ms(single),
                # past 8 lanes the plain versions take 0.1 to 0.6 s a call
                "plain_ms": (cuda_ms(plain, 2, warmup=1) if K <= 8
                             else cuda_ms(plain, 1, warmup=0))})
    if library:
        cells = [pb["enc"][m]["lstm"] for m in mfm._ENCODERS] * K
        lib = lane_library_ms(K, w, res, deltas_ref, z_tot,
                              (h0, c0, wsum, b, t, dec_dims), cells,
                              mfm.split_modalities(x, cfg.input_dims) * K,
                              mfm.split_modalities(xe, cfg.input_dims) * K,
                              dw_ref)

    # bounds at K lanes: K lanes' useful float32 work and each input read
    # once, each output written once (as steps 5-8 bound one lane)
    rows = t * n
    recur = 4 * sum(h * h for h in h_dims)
    m2 = 2 * (H - z_tot)
    dec_mac = (t - 1) * n * 4 * sum(h * h for h in dec_dims)
    mh = 4 * sum(h * h for h in m_dims)
    used = ("a1w1", "a1w2", "a2w1", "a2w2", "gw1", "g1w2", "g2w2")
    bounds = {
        "mfm_encode_fwd.eval": bound(
            2 * K * ne * (t * encode_macs_per_row(w0, h_dims, z_tot)
                          - recur),
            nbytes(xpe, *off_diag(we), *got) + K * diag_bytes(h_dims)),
        "mfm_encode_fwd": bound(
            2 * K * (rows * encode_macs_per_row(w0, h_dims, z_tot)
                     - n * recur),
            nbytes(xp, masks, *off_diag(w), *fwd[:5], fwd[5])
            + K * diag_bytes(h_dims)),
        "mfm_encode_bwd": bound(
            2 * K * ((t - 1) * n * 2 * recur
                     + rows * ((s3 + s4) * mem + s2 * mem
                               + (m2 + mem) * (s3 + s4) + m2 * s2
                               + 2 * s1 * m2)),
            nbytes(xp, *res, dh, dmem, *[w[k] for k in used], dxp, deltas)
            + K * diag_bytes(h_dims)),
        "mfm_encode_dw": bound(
            2 * rows * sum(g.numel() for g in dw.values()),
            nbytes(res[1], res[2], res[3], deltas_ref, *dw.values())),
        "decoder_lstm_fwd": bound(2 * K * dec_mac,
                                  nbytes(h0, c0, b, *dfwd)
                                  + K * diag_bytes(dec_dims)),
        "decoder_lstm_fwd.4n": bound(2 * K * 4 * dec_mac,
                                     nbytes(h04, c04, b4, *dfwd4)
                                     + K * diag_bytes(dec_dims)),
        "decoder_lstm_bwd": bound(2 * K * dec_mac,
                                  nbytes(gates, allc, dallh, *dbwd)
                                  + K * diag_bytes(dec_dims)),
        "multi_lstm_fwd": bound(2 * K * (t - 1) * n * mh,
                                nbytes(mxp, *mf) + K * diag_bytes(m_dims)),
        "multi_lstm_fwd.eval": bound(2 * K * (t - 1) * ne * mh,
                                     nbytes(mxpe, mfe)
                                     + K * diag_bytes(m_dims)),
        "multi_lstm_bwd": bound(2 * K * (t - 1) * n * mh,
                                nbytes(mgates, mallc, dhl, mb)
                                + K * diag_bytes(m_dims)),
    }
    errs = {"mfm_encode_fwd.eval": err_eval, "mfm_encode_fwd": err_fwd,
            "mfm_encode_bwd": err_bwd, "mfm_encode_dw": err_dw,
            "decoder_lstm_fwd": err_decf, "decoder_lstm_fwd.4n": err_decf4,
            "decoder_lstm_bwd": err_decb,
            "multi_lstm_fwd": err_mf, "multi_lstm_fwd.eval": err_mfe,
            "multi_lstm_bwd": err_mb}
    for name in calls:
        out[name] = {"lanes": K, "max_abs_err": errs[name]["max_abs_err"],
                     **times[name], "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1],
                     "single_lane_bound_ms": bounds[name][0] / K,
                     "library_ms": lib.get(name) if library else None,
                     "library_device_ms": (lib.get(f"{name}.device")
                                           if library else None)}
    log({"phase": "lane_kernels", "nvidia_smi": smi, "lanes": K,
         "n_train": n, "n_eval": ne, "h_dims": h_dims, "dec_dims": dec_dims,
         "multi_dims": m_dims, "lane_bits": bits, "kernels": out})
    return out


# the calls of lane_kernel_phase (every kernel takes its lanes by stride):
# lane k of each K-lane call bit for bit its one-lane call (lane_bits)
LANE_BIT_CALLS = ("mfm_encode_fwd.eval", "mfm_encode_fwd", "mfm_encode_bwd",
                  "mfm_encode_dw", "decoder_lstm_fwd", "decoder_lstm_fwd.4n",
                  "decoder_lstm_bwd", "multi_lstm_fwd", "multi_lstm_fwd.eval",
                  "multi_lstm_bwd")


def lane_plan(kernel):
    """The plan the last call of ``kernel`` took: the chains' rows, plan,
    the blocks the card holds at once and the waves they take, or the
    weight gradients' cluster and copy width."""
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    def rows(p):
        return {k: p[k] for k in ("rows", "plan", "wave", "waves")}

    if kernel == "mfm_encode_dw":
        return dict(cuda_mfn.DW_PLAN)
    if kernel in ("decoder_lstm_bwd", "multi_lstm_bwd"):
        return rows(cuda_lstm.BWD_PLAN[kernel])
    if kernel in ("decoder_lstm_fwd", "multi_lstm_fwd"):
        return rows(cuda_lstm.FWD_PLAN[kernel])
    plan = cuda_mfn.FWD_PLAN if kernel == "mfm_encode_fwd" else \
        cuda_mfn.BWD_PLAN
    return {c: rows(p) for c, p in plan.items()}


def lane_bits(K, calls):
    """Lane k of each ``LANE_BIT_CALLS`` call of ``lane_kernel_phase``
    (``calls``: {name: (fn over operands, the K lanes' operands, ...)})
    over K lanes, against lane k's call with a lane axis of one (K = 1)
    and with none, bit for bit (``lane_replays``: each lane's arithmetic
    does not depend on K); each K-lane call's plan and launches. Raises
    where a bit differs."""
    plans = {}
    with captured_lane_calls() as got:
        for name in LANE_BIT_CALLS:
            fn, ops = calls[name][:2]
            before = lane_counts()
            fn(ops)
            kernel = name.split(".")[0]
            plans[name] = {"plan": lane_plan(kernel),
                           "launches": lane_counts()[kernel]
                           - before.get(kernel, 0)}
    return {"lanes": K, "calls": plans,
            "one_lane": lane_replays(got, axis=True),
            "no_lane_axis": lane_replays(got), "same_bits": True}


def lane_library_ms(K, w, res, deltas, z_tot, dec, cells, xs, xs_eval,
                    dw_ref):
    """The lane kernels' library yardsticks, used nowhere in the port, by
    the one-lane rows' recipe lane by lane: the weight gradients as 7
    ``torch.bmm`` and 7 sums over the lanes' stacked operands (built
    before the timing; held against the plain version), the decoders and
    ``m_b``'s trio as one ``torch.nn.LSTM`` (cuDNN) per cell and lane
    (``decoder_library_ms``, ``cell_library_ms``). {call name: ms}."""
    from factorized_tpu_torch.ops import cuda_mfn

    ops = [cuda_mfn.dw_operands(res[1][k], res[2][k], res[3][k],
                                {m: v[k] for m, v in w.items()}, z_tot)
           for k in range(K)]
    A = {a: torch.stack([o[a] for o in ops]) for a in ops[0]}
    offs, _ = cuda_mfn.delta_layout({m: v[0] for m, v in w.items()})
    D = deltas.reshape(K, -1, deltas.shape[-1])

    def dw():
        out = {}
        for name, (a, d) in cuda_mfn.DW_PRODUCTS.items():
            o, wd = offs[d]
            out[name] = (D[:, :, o:o + wd].sum(1) if a == "ones" else
                         torch.bmm(A[a].transpose(1, 2), D[:, :, o:o + wd]))
        return out

    compare_all(f"lanes{K}.mfm_encode_dw.library", [
        (k, v, torch.stack([r[k] for r in dw_ref]).reshape(v.shape))
        for k, v in dw().items()], GRAD_RTOL, GRAD_ATOL)
    # 10 calls each: the cuDNN calls of K lanes take 3 to 36 ms; the
    # weight gradients' products also by device time (20 calls of 14
    # launches queued, as the kernel's own device ms are taken)
    return {"mfm_encode_dw": cuda_ms(dw, 20),
            "mfm_encode_dw.device": queued_ms(dw, reps=20),
            "decoder_lstm_fwd": decoder_library_ms(*dec, reps=10),
            "decoder_lstm_bwd": decoder_library_ms(*dec, backward=True,
                                                   reps=10),
            "multi_lstm_fwd": cell_library_ms(cells, xs, reps=10),
            "multi_lstm_fwd.eval": cell_library_ms(cells, xs_eval, reps=10),
            "multi_lstm_bwd": cell_library_ms(cells, xs, backward=True,
                                              reps=10)}


def lane_draws(cfg, K, n, generator):
    """Every random draw of one train step of K ``mfm`` lanes, on the CPU,
    each with the lane dimension in front: the encode's dropout masks, the
    MMD samples and the z->f masks (zy's rate is 0: None)."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn

    sizes = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
             cfg.gamma2_shape)
    return {
        "encode_masks": torch.stack([cuda_mfn.make_dropout_masks(
            generator, cfg.seqlength, n, sizes, mfn_drops(cfg))
            for _ in range(K)]),
        "mmd_noise": torch.randn((K, *mfm.mmd_noise_shape(cfg, n)),
                                 generator=generator),
        "zf_masks": [None] + [torch.stack(z) for z in zip(
            *(zf_masks(cfg, n, generator)[1:] for _ in range(K)))]}


def lane_grads_vs_cpu(cfg, dev, K):
    """Step 20b: one train step of K ``mfm`` lanes (``torch.func.vmap``
    over the joint loss, the lane kernels) on the card against the CPU's
    lane plain path, the same stacked parameters, batch and injected
    draws: every lane's gradients within rtol 1e-3 / atol 2e-5."""
    from factorized_tpu_torch.convert import to_state_dict
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.parallel.multiseed import _dims, stack_lanes
    from factorized_tpu_torch.train import make_loss_fn
    from torch.utils import _pytree as pytree

    t, n = cfg.seqlength, N_TRAIN
    cpu = torch.Generator().manual_seed(SEED + 95)
    x = torch.randn((t, n, cfg.d_total), generator=cpu)
    y = torch.randn((n,), generator=cpu)
    stacked = stack_lanes([mfm.MFM(cfg, seed=SEED + 300 + k,
                                   device="cpu").tree() for k in range(K)],
                          "cpu")
    draws = lane_draws(cfg, K, n, cpu)
    loss_fn = make_loss_fn(mfm.mfm_apply, cfg, "joint")
    grads = {}
    for where in ("cpu", dev):
        p = pytree.tree_map(lambda a: a.detach().to(where).requires_grad_(),
                            stacked)
        d = pytree.tree_map(lambda v: None if v is None else v.to(where),
                            draws)

        def lane(pp, xx, yy, dd):
            return loss_fn(pp, xx, yy, draws=dd)

        loss, _ = torch.func.vmap(lane, in_dims=(0, None, None, _dims(d)))(
            p, x.to(where), y.to(where), d)
        loss.sum().backward()
        grads[str(where)] = {k: v.grad.cpu()
                             for k, v in to_state_dict(p).items()}
    return compare_all(f"lanes.train_step_grads_vs_cpu.K{K}",
                       [(k, grads[str(dev)][k], grads["cpu"][k])
                        for k in grads["cpu"]], GRAD_RTOL, GRAD_ATOL)


# step 20g: the lanes of the models whose train steps reach the lane
# kernels at widths or through losses mfm's and m_b's lanes do not: m_a
# and m_c (the encode with one encoder cell or none), kl (the encode and
# the decoders under the KL term), m_d (the encoder trio alone, no
# decoder), kl_ef's two stages (multi_lstm both ways; stage 1 also the
# decoders) and missing (the decoders over 4n rows); each with the kernels
# its step launches
LANE_MODELS = {
    "m_a": ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
            "decoder_lstm_fwd", "decoder_lstm_bwd"),
    "m_c": ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
            "decoder_lstm_fwd", "decoder_lstm_bwd"),
    "kl": ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
           "decoder_lstm_fwd", "decoder_lstm_bwd"),
    "m_d": ("multi_lstm_fwd", "multi_lstm_bwd"),
    "kl_ef.1": ("multi_lstm_fwd", "multi_lstm_bwd", "decoder_lstm_fwd",
                "decoder_lstm_bwd"),
    "kl_ef.2": ("multi_lstm_fwd", "multi_lstm_bwd"),
    "missing": ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
                "decoder_lstm_fwd", "decoder_lstm_bwd"),
}


def lane_model(cfg, name, n, generator):
    """(model_type, its cfg, its loss, one lane's draws) of a
    ``LANE_MODELS`` entry: one train step's loss with every random draw
    injected, made on the CPU from ``generator``."""
    from factorized_tpu_torch.models import get_model, mfm
    from factorized_tpu_torch.models.common import mfn_drops
    from factorized_tpu_torch.ops import cuda_mfn
    from factorized_tpu_torch.train import make_loss_fn

    model_type = name.split(".")[0]
    if model_type in ("m_a", "m_c", "m_d"):
        mcfg = cfg.replace(model_type=model_type)
        return (model_type, mcfg,
                make_loss_fn(get_model(model_type)[1], mcfg),
                ablation_draws(mcfg, model_type, n, generator))
    if model_type == "kl":
        mcfg = cfg.replace(model_type="kl")
        sizes = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
                 cfg.gamma2_shape)
        return (model_type, mcfg, make_loss_fn(get_model("kl")[1], mcfg),
                {"encode_masks": cuda_mfn.make_dropout_masks(
                    generator, cfg.seqlength, n, sizes, mfn_drops(cfg)),
                 "zf_masks": zf_masks(cfg, n, generator)})
    if model_type == "kl_ef":
        mcfg = cfg.replace(model_type="kl_ef")
        return (model_type, mcfg,
                make_loss_fn(mfm.mfm_kl_ef_apply, mcfg, "beta_vae",
                             stage=int(name[-1])),
                {"zf_masks": zf_masks(cfg, n, generator)})
    mcfg = cfg.replace(missing=1)
    sizes = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
             cfg.gamma2_shape)
    return (model_type, mcfg,
            make_loss_fn(mfm.mfm_missing_apply, mcfg, "missing"),
            {"encode_masks": cuda_mfn.make_dropout_masks(
                generator, cfg.seqlength, n, sizes, mfn_drops(cfg)),
             "mmd_noise": torch.randn(mfm.mmd_noise_shape(cfg, n),
                                      generator=generator),
             "zf_masks": [zf_masks(cfg, n, generator) for _ in range(4)]})


def lane_launchers():
    """The lane wrappers' launchers, by kernel: {kernel: (module, name)};
    each takes ``lanes`` (0: no lane axis)."""
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    return {"mfm_encode_fwd": (cuda_mfn, "_launch_fwd"),
            "mfm_encode_bwd": (cuda_mfn, "_launch_bwd"),
            "mfm_encode_dw": (cuda_mfn, "_launch_dw"),
            "decoder_lstm_fwd": (cuda_lstm, "_launch"),
            "decoder_lstm_bwd": (cuda_lstm, "_launch_bwd"),
            "multi_lstm_fwd": (cuda_lstm, "_launch_multi"),
            "multi_lstm_bwd": (cuda_lstm, "_launch_multi_bwd")}


def tensor_map(fn, tree):
    """``fn`` over the tensors of nested dicts, lists and tuples; other
    leaves kept."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda v: fn(v) if isinstance(v, torch.Tensor) else v, tree)


@contextlib.contextmanager
def captured_lane_calls():
    """Yields a list that gathers each lane launch made while the block
    runs: (kernel, launcher, its bound arguments, lanes, its outputs
    cloned). Calls without a lane axis are not gathered."""
    import inspect

    calls, real = [], []
    for kernel, (module, attr) in lane_launchers().items():
        fn = getattr(module, attr)
        real.append((module, attr, fn))

        def wrapped(*a, _kernel=kernel, _fn=fn, **kw):
            out = _fn(*a, **kw)
            bound = inspect.signature(_fn).bind(*a, **kw)
            bound.apply_defaults()
            lanes = bound.arguments["lanes"]
            if lanes:
                calls.append((_kernel, _fn, bound, lanes,
                              tensor_map(lambda v: v.detach().clone(), out)))
            return out

        setattr(module, attr, wrapped)
    try:
        yield calls
    finally:
        for module, attr, fn in real:
            setattr(module, attr, fn)


def lane_replays(calls, axis=False):
    """Each gathered K-lane launch (``captured_lane_calls``) replayed lane
    by lane, lane k's operands alone (``axis``: with a lane axis of one,
    else none), its outputs held against lane k's of the K-lane launch
    bit for bit. Raises where a bit differs; returns {kernel: {"calls",
    "lanes"}}."""
    from torch.utils import _pytree as pytree

    out, differ = {}, []
    for kernel, fn, bound, lanes, got in calls:
        for k in range(lanes):
            def lane(v, k=k):
                return v[k:k + 1] if axis else v[k]

            args = {name: tensor_map(lane, value)
                    for name, value in bound.arguments.items()}
            args["lanes"] = 1 if axis else 0
            one = pytree.tree_leaves(fn(**args))
            for i, (v, w) in enumerate(zip(pytree.tree_leaves(got), one)):
                if not torch.equal(v[k], w[0] if axis else w):
                    differ.append(f"{kernel} lane {k} of {lanes} output {i}")
        seen = out.setdefault(kernel, {"calls": 0, "lanes": lanes})
        seen["calls"] += 1
    if differ:
        raise AssertionError(f"lane k of a K-lane launch differs from its "
                             f"one-lane call: {differ[:8]}")
    return out


def lane_model_check(cfg, dev, name, K, seed):
    """Step 20g (and 21's lane bits past 8): one train step of K lanes of
    a ``LANE_MODELS`` model (``torch.func.vmap`` over its loss, the lane
    kernels), lane k a model of its own seed with draws of its own, on
    the card against the CPU's lane plain path: every lane's gradients
    within rtol 1e-3 / atol 2e-5; the kernels the step launched, counted
    from 0 (each a lane launch); every K-lane kernel call of the card's
    step replayed lane by lane with no lane axis, lane k bit for bit
    (``lane_replays``)."""
    from factorized_tpu_torch.convert import to_state_dict
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.parallel.multiseed import _dims, stack_lanes
    from torch.utils import _pytree as pytree

    t, n = cfg.seqlength, N_TRAIN
    cpu = torch.Generator().manual_seed(seed)
    x = torch.randn((t, n, cfg.d_total), generator=cpu)
    y = torch.randn((n,), generator=cpu)
    draws = [lane_model(cfg, name, n, cpu)[3] for _ in range(K)]
    model_type, mcfg, loss_fn, _ = lane_model(cfg, name, n, cpu)
    draws = pytree.tree_map(
        lambda *v: None if v[0] is None else torch.stack(v), *draws)
    stacked = stack_lanes([mfm.MFM(mcfg, seed=seed + 1 + k, device="cpu",
                                   model_type=model_type).tree()
                           for k in range(K)], "cpu")
    grads, replays = {}, None
    for where in ("cpu", dev):
        p = pytree.tree_map(lambda a: a.detach().to(where).requires_grad_(),
                            stacked)
        d = pytree.tree_map(lambda v: None if v is None else v.to(where),
                            draws)

        def lane(pp, xx, yy, dd):
            return loss_fn(pp, xx, yy, draws=dd)

        def step():
            loss, _ = torch.func.vmap(lane, in_dims=(0, None, None,
                                                     _dims(d)))(
                p, x.to(where), y.to(where), d)
            loss.sum().backward()

        if where == "cpu":
            step()
        else:
            with captured_lane_calls() as calls:
                _, seconds, launches = counted(f"{name} lanes",
                                               LANE_MODELS[name], step)
            lane_launched = lane_counts()
            replays = lane_replays(calls)
        grads[str(where)] = {k: (torch.zeros_like(v) if v.grad is None
                                 else v.grad).cpu()
                             for k, v in to_state_dict(p).items()}
    err = compare_all(f"lanes.{name}.K{K}.train_step_grads_vs_cpu",
                      [(k, grads[str(dev)][k], grads["cpu"][k])
                       for k in grads["cpu"]], GRAD_RTOL, GRAD_ATOL)
    for kernel in LANE_MODELS[name]:
        if lane_launched.get(kernel, 0) < 1:
            raise AssertionError(f"{name} over {K} lanes launched no lane "
                                 f"{kernel}")
    return {"model": name, "lanes": K, "max_abs_err": err["max_abs_err"],
            "seconds": seconds,
            "launches": {k: launches[k] for k in LANE_MODELS[name]},
            "lane_launches": lane_launched, "lane_bits": replays}


@contextlib.contextmanager
def lane_loops():
    """Yields a list that gathers each ``multiseed.LaneLoop`` built while
    the block runs (by ``multiseed`` or ``multiconfig``)."""
    from factorized_tpu_torch.parallel import multiconfig, multiseed

    loops, real = [], multiseed.LaneLoop

    class Loop(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loops.append(self)

    multiseed.LaneLoop = multiconfig.LaneLoop = Loop
    try:
        yield loops
    finally:
        multiseed.LaneLoop = multiconfig.LaneLoop = real


def lane_counts():
    """Both modules' lane launches by kernel, summed."""
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    out = dict(cuda_mfn.LANE_LAUNCHES)
    for k, v in cuda_lstm.LANE_LAUNCHES.items():
        out[k] = out.get(k, 0) + v
    return out


def lane_path_times(loop, steps=3, replays=3):
    """A lane path's times from its ``LaneLoop`` (its epoch graph
    captured): device ms and kernel launches a step and the device's idle
    share (torch.profiler, the card's activity alone, over ``steps`` eager
    steps of every lane on the first batch), replayed epoch s (host clock,
    median of ``replays`` ``run(1)``s, the host read included), device ms
    of a replayed epoch and its idle share against the unprofiled epoch's
    wall."""
    from torch.profiler import ProfilerActivity, profile

    Xb, yb = loop.batches
    programs, params, opt = loop.programs, loop.params, loop.opt
    programs.step(params, opt, Xb[0], yb[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            programs.step(params, opt, Xb[0], yb[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if on_device(e)]
    step_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    replay_s = []
    for _ in range(replays):
        t0 = time.perf_counter()
        loop.run(1)
        replay_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        loop.run(1)
    replayed = [e for e in p.key_averages() if on_device(e)]
    if not replayed:
        raise AssertionError("torch.profiler saw no kernel of a replay")
    device_ms = sum(e.device_time_total for e in replayed) / 1e3
    epoch_s = float(np.median(replay_s))
    return {"lanes": opt.lanes, "batches": int(Xb.shape[0]),
            "batch": int(Xb.shape[2]),
            "device_ms_per_step": step_ms,
            "launches_per_step": sum(e.count for e in kernels) / steps,
            "eager_step_device_idle_share": 1.0 - step_ms * steps / wall_ms,
            "replayed_epoch_s": epoch_s, "replayed_epoch_s_all": replay_s,
            "device_ms_per_replayed_epoch": device_ms,
            "replayed_device_idle_share": 1.0 - device_ms / (epoch_s * 1e3),
            "capture_ms": loop.epoch.capture_ms,
            "graph_pool_bytes": loop.epoch.pool_bytes}


def lane_epoch_launches(loop, kernels, label, epoch=1):
    """Each kernel's launches in the loop's replayed epoch ``epoch``: one
    a train step for all the lanes (the forward kernels once more for the
    evaluation); of a one-model ``ChunkedLoop``, one a step."""
    nb = int(loop.batches[0].shape[0])
    if loop.epoch.graph is None or len(loop.epoch_launches) <= epoch:
        raise AssertionError(f"{label}: epoch {epoch} was not a graph "
                             f"replay")
    seen = per_kernel(loop.epoch_launches[epoch])
    want = {k: nb + (k in ("mfm_encode_fwd", "decoder_lstm_fwd",
                           "multi_lstm_fwd")) for k in kernels}
    got = {k: seen[k] for k in kernels}
    if got != want:
        raise AssertionError(f"{label}: a replayed epoch launched {got}, "
                             f"not {want} ({nb} steps)")
    return got


def lane_command(command, argv, run_id, kernels, tmp, K):
    """``<command> --seeds K --mode best --epochs 2`` through the command
    line in this process, counted: every lane's train loss finite and
    falling, each of ``kernels`` launched once a step for all the lanes
    (``lane_epoch_launches``), the second epoch a replay, a final record
    with the seeds' metrics. Returns (its line, the loop, --out)."""
    import os

    runs = os.path.join(tmp, f"lanes_{command}_{run_id}_{K}")
    argv = [*argv, "--seeds", str(K), "--mode", "best", "--epochs",
            str(TRAIN_EPOCHS), "--seed", str(SEED), "--out", runs]
    printed = io.StringIO()
    with lane_loops() as loops, contextlib.redirect_stdout(printed):
        seconds, launches, _ = mosi_cli(argv, f"{command} {argv}", kernels,
                                        command=command)
    lane = lane_counts()  # counted() set them to 0 before the run
    path = os.path.join(runs, f"{run_id}.jsonl")
    records = epoch_records(path)
    losses = np.asarray([r["train_loss"] for r in records])
    valids = np.asarray([r["valid_loss"] for r in records])
    if (losses.shape != (TRAIN_EPOCHS, K) or not np.isfinite(losses).all()
            or not np.isfinite(valids).all()):
        raise AssertionError(f"{command} --seeds {K}: losses {losses}, "
                             f"valids {valids}")
    if not (losses[-1] < losses[0]).all():
        raise AssertionError(f"{command} --seeds {K}: a lane's train loss "
                             f"did not fall: {losses.tolist()}")
    with open(path) as f:
        final = [r for r in map(json.loads, f) if r["kind"] == "final"]
    if not final or len(final[-1]["per_seed"]) != K:
        raise AssertionError(f"{command} --seeds {K}: no final record with "
                             f"{K} seeds")
    loop, = loops
    epoch = lane_epoch_launches(loop, kernels, f"{command} --seeds {K}")
    return {"command": [command, *argv], "train_loss": losses.tolist(),
            "valid": valids.tolist(), "launches": launches,
            "lane_launches": lane, "replayed_epoch_launches": epoch,
            "best_seed": final[-1]["best_seed"],
            "per_seed": final[-1]["per_seed"], "run_s": seconds}, loop, runs


def lane_resume_check(tmp):
    """Step 20d: ``mosi --seeds 2 --mode best --epochs 2 --ckpt-every 1``,
    then ``--resume`` of its ``ckpt_auto_mosi_0`` for a third epoch: the
    snapshot's meta has the JAX package's fields, and the restored
    parameters, Adam state, best record and lrs equal the snapshot's bit
    for bit."""
    import os

    from factorized_tpu_torch.parallel import multiseed
    from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

    runs = os.path.join(tmp, "lanes_resume")
    common = ["--seeds", "2", "--mode", "best", "--seed", str(SEED)]
    with contextlib.redirect_stdout(io.StringIO()):
        mosi_cli([*common, "--epochs", "2", "--ckpt-every", "1", "--out",
                  runs], "mosi --seeds 2 --ckpt-every 1", LANE_PATHS["mfm"])
    ck = os.path.join(runs, "ckpt_auto_mosi_0")
    state, meta = restore_checkpoint(ck)
    fields = ("_ms_n_seeds", "_ms_best_valid", "_ms_lrs", "_ms_sched")
    if meta["step"] != 2 or any(f not in meta["config"] for f in fields):
        raise AssertionError(f"snapshot meta {meta}")
    seen = {}
    real = multiseed._multiseed_resume

    def spy(resume_from, loop, n_seeds, logger, *lanes):
        start = real(resume_from, loop, n_seeds, logger, *lanes)
        opt = loop.opt
        seen.update(
            start=start,
            params=same_bits(opt.flat, opt.flatten(state["params"]["live"])),
            best=same_bits(loop.best_flat,
                           opt.flatten(state["params"]["best"])),
            mu=same_bits(opt.mu, state["opt_state"]["state"]["mu"]),
            nu=same_bits(opt.nu, state["opt_state"]["state"]["nu"]),
            count=same_bits(opt.count, state["opt_state"]["state"]["count"]),
            lrs=same_bits(opt.lr, torch.tensor(meta["config"]["_ms_lrs"])),
            best_valid=same_bits(loop.best, torch.tensor(
                meta["config"]["_ms_best_valid"])))
        return start

    multiseed._multiseed_resume = spy
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mosi_cli([*common, "--epochs", "3", "--resume", ck, "--out",
                      os.path.join(tmp, "lanes_resumed")],
                     "mosi --seeds 2 --resume", LANE_PATHS["mfm"])
    finally:
        multiseed._multiseed_resume = real
    if not (seen.get("start") == 2 and all(
            v for k, v in seen.items() if k != "start")):
        raise AssertionError(f"resume: {seen}")
    return seen


def lanes_phase(cfg, dev, smi, tmp):
    """Step 20: lanes of seeds (``--seeds K``, ``parallel/multiseed.py``).
    (a) ``lane_kernel_phase`` at K = 8, with the library yardsticks lane
    by lane; (b) ``lane_grads_vs_cpu`` at
    K = 8; (c) ``mosi --type mfm --seeds 8``, ``mosi --type m_b --seeds
    4`` and ``mosi_acc --seeds 4``, ``--mode best --epochs 2``, through
    the command (``lane_command``); (d) ``lane_resume_check``; (e)
    ``check --dir`` on the ``mfm`` run's directory prints the best of its
    seeds; (f) ``mfm``'s lane path at K = 1, 2, 4 (built directly) and 8
    (the command's): device ms and launches a step, replayed epoch s and
    the idle share (``lane_scaling``); (g) ``lane_model_check`` of each
    ``LANE_MODELS`` model at K = 8 (``lane_models`` lines). Returns
    ({kernel: step 20a's numbers}, {path: launches}, {kernel: lane
    launches})."""
    import os

    from factorized_tpu_torch import cli
    from factorized_tpu_torch.data import mosi
    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.parallel import multiseed
    from factorized_tpu_torch.train import LaneAdam

    t0 = time.perf_counter()
    kernels = lane_kernel_phase(cfg, dev, smi, LANES, library=True)
    t1 = time.perf_counter()
    grads = lane_grads_vs_cpu(cfg, dev, LANES)
    log({"phase": "lane_grads", "nvidia_smi": smi, "lanes": LANES,
         "max_abs_err": grads["max_abs_err"],
         "seconds": time.perf_counter() - t1, "kernels_seconds": t1 - t0})
    runs, paths, lane_launches = {}, {}, {}
    for label, (command, argv, run_id, path, K) in {
            "mfm": ("mosi", ["--type", "mfm"], "mosi_0", "mfm", LANES),
            "m_b": ("mosi", ["--type", "m_b"], "mosi_0", "m_b", 4),
            "mosi_acc": ("mosi_acc", [], "mosi_acc_0", "mfm", 4)}.items():
        line, loop, out = lane_command(command, argv, run_id,
                                       LANE_PATHS[path], tmp, K)
        if label == "mfm":
            t1 = time.perf_counter()
            line["times"] = times = {K: lane_path_times(loop)}
            line["times_seconds"] = time.perf_counter() - t1
        log({"phase": "lanes", "nvidia_smi": smi, "path": label, **line})
        runs[label], paths[label] = out, line["launches"]
        for k, v in line["lane_launches"].items():
            lane_launches[k] = lane_launches.get(k, 0) + v
    t1 = time.perf_counter()
    resumed = lane_resume_check(tmp)
    log({"phase": "lanes_resume", "nvidia_smi": smi, **resumed,
         "seconds": time.perf_counter() - t1})
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["check", "--dir", runs["mfm"]])
    with open(os.path.join(runs["mfm"], "mosi_0.jsonl")) as f:
        final = [r for r in map(json.loads, f) if r["kind"] == "final"][-1]
    best_mae = min(m["mae"] for m in final["per_seed"])
    lines = printed.getvalue().splitlines()
    if f"mae: {best_mae}" not in lines:
        raise AssertionError(f"check --dir printed {lines}, not the seeds' "
                             f"best mae {best_mae}")
    log({"phase": "lanes_check", "nvidia_smi": smi, "printed": lines})
    # mfm's lane path at K = 1, 2 and 4, built directly
    data = mosi.get_data(cfg.seqlength)
    _, apply_fn = get_model("mfm")
    t1 = time.perf_counter()
    for K in (1, 2, 4):
        prep = multiseed.prepare_bucket_data(*data, cfg, seed=SEED,
                                             device=dev)
        params = multiseed.init_lanes("mfm", cfg, SEED, K, dev)
        opt = LaneAdam(params, 1e-3)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        programs = multiseed.LanePrograms(apply_fn, cfg, gen)
        loop = multiseed.LaneLoop(programs, params, opt, prep["Xb"],
                                  prep["yb"], prep["Xv"], prep["yv"],
                                  epochs=1)
        loop.run(1)
        loop.run(1)
        lane_epoch_launches(loop, LANE_PATHS["mfm"], f"mfm K = {K}")
        times[K] = lane_path_times(loop)
        del loop, opt, params, programs
    log({"phase": "lane_scaling", "nvidia_smi": smi, "path": "mfm",
         "by_lanes": {str(k): times[k] for k in sorted(times)},
         "seconds": time.perf_counter() - t1})
    for i, name in enumerate(LANE_MODELS):
        log({"phase": "lane_models", "nvidia_smi": smi,
             **lane_model_check(cfg, dev, name, LANES, SEED + 400 + 10 * i)})
    return kernels, paths, lane_launches


# step 21: lane counts past 8, one launch a call at each
LANES_PAST = (12, 16, 32)
# step 21a: a model of step 20g whose lanes reach both the encoder cells'
# and the decoders' chain backward, past 8 lanes
LANE_MODEL_PAST_8 = "kl_ef.1"
# step 21(b): the evolving search at the main path's width
EVOLVE_CONFIGS, EVOLVE_SEEDS, EVOLVE_RUNGS = 8, 2, 3


def scratch_lanes_check(cfg, dev, K):
    """Step 21a: the eval encode on the scratch plan (an MFN cell of 600
    units, whose per-row state passes a block: ``cuda_lstm.SCRATCH``) over
    K lanes, lane k a model of its own seed, against the lane plain
    version: every lane's blocks keep their state in slices of one
    scratch reservation, so a lane that overwrote another's state would
    show."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    wide = cfg.replace(h_dims=[600, 64, 48])
    t, n = wide.seqlength, N_TRAIN
    gen = torch.Generator(device=dev).manual_seed(SEED + 140)
    x = torch.randn((t, n, wide.d_total), generator=gen, device=dev)
    with torch.inference_mode():
        ops = [mfm.kernel_operands(mfm.MFM(wide, seed=SEED + 150 + k,
                                           device=dev).tree(), x, wide)[0]
               for k in range(K)]
        xp, w = lane_stack([o[0] for o in ops]), lane_stack([o[1]
                                                            for o in ops])
        z_tot, h_dims = ops[0][2], ops[0][3]
        cuda_mfn.SCRATCH_LAUNCHES.clear()
        got = cuda_mfn.mfm_encode_lanes(xp, w, z_tot, h_dims)
        plan = cuda_mfn.CLUSTERS["mfm_encode_fwd"]
        if cuda_lstm.SCRATCH not in plan:
            raise AssertionError(f"the {h_dims} encode took plan {plan}, "
                                 f"not the scratch plan")
        err = compare_all(f"lanes{K}.scratch.mfm_encode_fwd.eval", zip(
            ("h_last", "mem_last"), got,
            cuda_mfn.mfm_encode_lanes_plain(xp, w, z_tot)))
    return {"lanes": K, "h_dims": h_dims, "n": n, "plan": list(plan),
            "scratch_launches": dict(cuda_mfn.SCRATCH_LAUNCHES),
            "max_abs_err": err["max_abs_err"]}


@contextlib.contextmanager
def patched(*triples):
    """Sets each (object, attribute, value) for the block, then puts the
    old values back."""
    old = [(o, a, getattr(o, a)) for o, a, _ in triples]
    for o, a, v in triples:
        setattr(o, a, v)
    try:
        yield
    finally:
        for o, a, v in old:
            setattr(o, a, v)


def recycle_checks(loop, template, L, seed):
    """Step 21b on the search's captured loop, from one state copied back
    into its buffers before each run: lanes ``L`` recycled then one
    replayed epoch leaves every other lane's parameters bit for bit those
    of the same epoch with no recycle; a generator re-seeded between
    replays gives the next replay its draws (the same seed twice the same
    epoch, another seed another); a recycled lane's first step equals a
    fresh ``LaneAdam``'s first step on the same parameters and batch."""
    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.parallel import multiconfig as mc
    from factorized_tpu_torch.train import LaneAdam

    program, init = loop.programs, get_model(template.model_type)[0]
    host = mc._host_state(program.state())

    def start(recycle):
        program.load_state(host)
        if recycle:
            mc.recycle_lanes(program.state(), L, cfg=template, init=init,
                             lrs_new=[1e-3] * len(L), seed=seed)

    def replay(s, recycle):
        start(recycle)
        program.generator.manual_seed(s)
        loop.run(1)
        return loop.opt.flat.clone()

    keep = [k for k in range(loop.opt.lanes) if k not in L]
    a, b, c, d = (replay(seed, True), replay(seed, False),
                  replay(seed, False), replay(seed + 1, False))
    out = {"survivors_unperturbed": same_bits(a[keep], b[keep]),
           "reseeded_replay_repeats": same_bits(b, c),
           "another_seed_differs": not same_bits(b, d),
           "recycled_lanes_restarted": not same_bits(a[L], b[L])}
    start(True)
    opt = loop.opt
    fresh = LaneAdam(opt.tree_of(opt.flat), opt.lr.clone())
    Xb, yb = loop.batches
    for o in (opt, fresh):
        program.generator.manual_seed(seed)
        program.step(o.params, o, Xb[0], yb[0], hps=loop.hps)
    out["recycled_first_step_is_fresh"] = (
        same_bits(opt.flat[L], fresh.flat[L])
        and same_bits(opt.mu[L], fresh.mu[L])
        and same_bits(opt.nu[L], fresh.nu[L])
        and opt.count[L].tolist() == [1] * len(L))
    if not all(out.values()):
        raise AssertionError(f"recycle checks: {out}")
    return out


def evolve_search_check(cfg, dev, smi, data):
    """Step 21b: ``multiconfig.train_evolving_search`` at ``cfg``'s width,
    ``EVOLVE_CONFIGS`` configs x ``EVOLVE_SEEDS`` seeds = 16 lanes,
    ``EVOLVE_RUNGS`` rungs of 2 epochs, on the synthetic MOSI set: every
    lane's losses finite and the survivors' falling, the culls those the
    rung scores rank, each kernel launched once a train step for all the
    lanes in every replayed epoch, one LaneLoop
    and one graph capture for the whole search; the host ms of each rung
    boundary (rank, score the finished lanes, recycle), then
    ``recycle_checks``. Returns (its line, launches, lane launches)."""
    import random

    from factorized_tpu_torch import train
    from factorized_tpu_torch.parallel import multiconfig as mc
    from factorized_tpu_torch.utils.logging import RunLogger

    template = cfg.replace(num_epochs=TRAIN_EPOCHS)
    K = EVOLVE_CONFIGS * EVOLVE_SEEDS
    records, captures = [], []
    marks = {"calls": [], "score_ms": [], "recycle_ms": []}

    class Log(RunLogger):
        def record(self, kind, **fields):
            records.append(dict(kind=kind, **fields))

    def capture(self):
        captures.append(self)
        real["capture"](self)

    def bucket(*a, **kw):
        marks["calls"].append([time.perf_counter()])
        out = real["bucket"](*a, **kw)
        marks["calls"][-1].append(time.perf_counter())
        return out

    def timer(name, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            marks[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    real = {"capture": train.Graphed._capture,
            "bucket": mc.train_config_bucket,
            "score": mc.score_bucket_lanes, "recycle": mc.recycle_lanes}
    with lane_loops() as loops, patched(
            (train.Graphed, "_capture", capture),
            (mc, "train_config_bucket", bucket),
            (mc, "score_bucket_lanes", timer("score", "score_ms")),
            (mc, "recycle_lanes", timer("recycle", "recycle_ms"))):
        res, seconds, launches = counted(
            "evolve", LANE_PATHS["mfm"], lambda: mc.train_evolving_search(
                *data, template, "mosi", n_configs=EVOLVE_CONFIGS,
                rungs=EVOLVE_RUNGS, cull_frac=0.5,
                seeds_per_config=EVOLVE_SEEDS, rng=random.Random(SEED),
                seed=SEED, logger=Log(echo=False), device=dev))
    lane = lane_counts()
    epochs = EVOLVE_RUNGS * TRAIN_EPOCHS
    if len(loops) != 1 or len(captures) != 1:
        raise AssertionError(f"the search built {len(loops)} loops and "
                             f"captured {len(captures)} graphs, not 1 and 1")
    loop, = loops
    if len(loop.epoch_launches) != epochs:
        raise AssertionError(f"{len(loop.epoch_launches)} epochs ran")
    replayed = [lane_epoch_launches(loop, LANE_PATHS["mfm"],
                                    "evolve search", epoch=e)
                for e in range(1, epochs)]
    losses = np.asarray([r["train_loss"] for r in records
                         if r["kind"] == "epoch"])
    valids = np.asarray([r["valid_loss"] for r in records
                         if r["kind"] == "epoch"])
    if (losses.shape != (epochs, K) or not np.isfinite(losses).all()
            or not np.isfinite(valids).all()):
        raise AssertionError(f"evolve: losses {losses}")
    n_cull = int(0.5 * EVOLVE_CONFIGS)
    for r in res["rungs"][:-1]:
        want = sorted(int(c) for c in np.argsort(r["scores"])[-n_cull:])
        if sorted(r["culled"]) != want:
            raise AssertionError(f"rung {r['rung']} culled {r['culled']}, "
                                 f"its scores rank {want}")
    culled = {c for r in res["rungs"] for c in r["culled"]}
    survivors = [k for k in range(K) if k // EVOLVE_SEEDS not in culled]
    if not survivors or not (losses[-1, survivors]
                             < losses[0, survivors]).all():
        raise AssertionError(f"evolve: survivors {survivors} losses "
                             f"{losses[:, survivors].tolist()}")
    boundary_ms = [(marks["calls"][i + 1][0] - marks["calls"][i][1]) * 1e3
                   for i in range(len(marks["calls"]) - 1)]
    t1 = time.perf_counter()
    checks = recycle_checks(loop, template, [0, 1], SEED + 7)
    return {"lanes": K, "configs": EVOLVE_CONFIGS, "seeds": EVOLVE_SEEDS,
            "rungs": [{k: v for k, v in r.items() if k != "configs"}
                      for r in res["rungs"]],
            "explored_configs": res["explored_configs"],
            "best": {"rung": res["best"]["rung"],
                     "metrics": res["best"]["metrics"]},
            "survivors": survivors, "train_loss": losses.tolist(),
            "captures": len(captures), "capture_ms": loop.epoch.capture_ms,
            "graph_pool_bytes": loop.epoch.pool_bytes,
            "replayed_epoch_launches": replayed[0],
            "rung_boundary_host_ms": boundary_ms,
            "score_host_ms": marks["score_ms"],
            "recycle_host_ms": marks["recycle_ms"],
            "launches": launches, "run_s": seconds, **checks,
            "recycle_checks_s": time.perf_counter() - t1}, launches, lane


def run_records(path):
    """Every record of a run's JSONL log, its time stamp dropped."""
    with open(path) as f:
        return [{k: v for k, v in r.items() if k != "ts"}
                for r in map(json.loads, f)]


def search_command(command, argv, run_ids, kernels, runs, label):
    """``<command> <argv> --out runs`` through the command line in this
    process, counted (``mosi_cli``): every lane's losses finite in each of
    ``run_ids``' logs, a ``final`` record in each, every replayed epoch of
    every LaneLoop launching each of ``kernels`` as ``lane_epoch_launches``
    counts a step. Returns (its line, launches, lane launches, {run id:
    records})."""
    import os

    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    printed = io.StringIO()
    with lane_loops() as loops, contextlib.redirect_stdout(printed):
        seconds, launches, _ = mosi_cli([*argv, "--out", runs], label,
                                        kernels, command=command)
    lane = lane_counts()
    logs = {r: run_records(os.path.join(runs, f"{r}.jsonl"))
            for r in run_ids}
    for run_id, recs in logs.items():
        epochs = [r for r in recs if r["kind"] == "epoch"]
        if not epochs or not np.isfinite([[r["train_loss"], r["valid_loss"]]
                                          for r in epochs]).all():
            raise AssertionError(f"{label} {run_id}: losses {epochs}")
        if not any(r["kind"] == "final" for r in recs):
            raise AssertionError(f"{label} {run_id}: no final record")
    for loop in loops:
        for e in range(1, len(loop.epoch_launches)):
            lane_epoch_launches(loop, kernels, label, epoch=e)
    return ({"command": [command, *argv], "run_s": seconds,
             "launches": launches, "lane_launches": lane,
             "loops": [{"lanes": lp.opt.lanes,
                        "epochs": len(lp.epoch_launches),
                        "capture_ms": lp.epoch.capture_ms}
                       for lp in loops],
             "plans": {"cuda_mfn": dict(cuda_mfn.CLUSTERS),
                       "cuda_lstm": dict(cuda_lstm.CLUSTERS)},
             "printed": printed.getvalue().splitlines()[-2:]},
            launches, lane, logs)


def search_commands(smi, tmp):
    """Step 21c: ``mosi --mode search --evolve 2 --trials 4 --seeds 3
    --epochs 2 --ckpt-every 1`` (12 lanes), its shapes and plans; then
    ``--resume`` of its rung-boundary snapshot, whose records from the
    second rung on equal the uninterrupted run's bit for bit; ``mosi
    --mode search --bucket --trials 4 --seeds 2 --epochs 2``;
    ``multitrait --style pom --mode search --evolve 2 --trials 4 --epochs
    2`` (a vector head ranked by ``mae_mean``); ``mosi --type m_b --mode
    search --evolve 2 --trials 3 --seeds 4`` (``m_b``'s trio over 12
    lanes); ``check --dir`` over the evolve run printing its finished
    lanes' best MAE. Returns ({path: launches}, lane launches summed)."""
    import os

    from factorized_tpu_torch import cli

    common = ["--mode", "search", "--epochs", str(TRAIN_EPOCHS), "--seed",
              str(SEED)]
    evolve = [*common, "--evolve", "2", "--trials", "4", "--seeds", "3"]
    runs = os.path.join(tmp, "evolve")
    paths, lanes = {}, {}

    def add(label, line, launches, lane):
        paths[label] = launches
        for k, v in lane.items():
            lanes[k] = lanes.get(k, 0) + v
        log({"phase": "search_command", "nvidia_smi": smi, "path": label,
             **line})

    line, launches, lane, logs = search_command(
        "mosi", [*evolve, "--ckpt-every", "1"], ["mosi_evolve0"],
        LANE_PATHS["mfm"], runs, "mosi --evolve 2")
    recs = logs["mosi_evolve0"]
    meta = recs[0]
    if meta["kind"] != "search_meta" or [r["kind"] for r in recs].count(
            "final") != 2:
        raise AssertionError(f"evolve records {[r['kind'] for r in recs]}")
    line["template"] = {k: meta["template"][k] for k in (
        "h_dims", "memsize", "zy_size", "zl_size", "za_size", "zv_size",
        "fy_size", "fl_size", "fa_size", "fv_size", "att1_shape",
        "att2_shape", "gamma1_shape", "gamma2_shape", "batchsize")}
    add("evolve", line, launches, lane)
    # the records after the rung-boundary snapshot (the second rung on)
    first = [r["kind"] for r in recs].index("rung") + 1
    ck = os.path.join(runs, "ckpt_auto_mosi_evolve0")
    line, launches, lane, logs = search_command(
        "mosi", [*evolve, "--resume", ck], ["mosi_evolve0"],
        LANE_PATHS["mfm"], os.path.join(tmp, "evolve_resumed"),
        "mosi --evolve 2 --resume")
    resumed = [r for r in logs["mosi_evolve0"]
               if r["kind"] not in ("search_meta",)]
    if resumed != recs[first:] or not resumed:
        raise AssertionError("the resumed search's records differ from the "
                             "uninterrupted run's")
    line["records_equal"] = len(resumed)
    add("evolve_resume", line, launches, lane)
    line, launches, lane, logs = search_command(
        "mosi", [*common, "--bucket", "--trials", "4", "--seeds", "2"],
        [], LANE_PATHS["mfm"], os.path.join(tmp, "bucket"), "mosi --bucket")
    bucket_logs = sorted(p for p in os.listdir(os.path.join(tmp, "bucket"))
                         if p.startswith("mosi_r0b"))
    for name in bucket_logs:
        recs_b = run_records(os.path.join(tmp, "bucket", name))
        final = [r for r in recs_b if r["kind"] == "final"]
        n_cfg = sum(r["kind"] == "config" for r in recs_b)
        if len(final) != 1 or len(final[0]["per_lane"]) != 2 * n_cfg:
            raise AssertionError(f"bucket {name}: {final}")
    line["buckets"] = bucket_logs
    add("bucket", line, launches, lane)
    line, launches, lane, logs = search_command(
        "multitrait", ["--style", "pom", *common, "--evolve", "2",
                       "--trials", "4"], ["pom_evolve0"], LANE_PATHS["mfm"],
        os.path.join(tmp, "multitrait_evolve"), "multitrait --evolve 2")
    last = logs["pom_evolve0"][-1]
    if last["kind"] != "evolve_final" or not np.isfinite(
            last["best_metrics"]["mae_mean"]):
        raise AssertionError(f"multitrait evolve: {last}")
    line["best_mae_mean"] = last["best_metrics"]["mae_mean"]
    add("multitrait_evolve", line, launches, lane)
    # m_b's encoder trio (multi_lstm) over 12 lanes
    line, launches, lane, _ = search_command(
        "mosi", [*common, "--type", "m_b", "--evolve", "2", "--trials", "3",
                 "--seeds", "4"], ["mosi_evolve0"], LANE_PATHS["m_b"],
        os.path.join(tmp, "evolve_m_b"), "mosi --type m_b --evolve 2")
    add("evolve_m_b", line, launches, lane)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["check", "--dir", runs])
    best = min(m["mae"] for r in recs if r["kind"] == "final"
               for m in r["per_lane"])
    lines = printed.getvalue().splitlines()
    if f"mae: {best}" not in lines:
        raise AssertionError(f"check --dir printed {lines}, not the "
                             f"finished lanes' best mae {best}")
    log({"phase": "search_check", "nvidia_smi": smi, "printed": lines})
    return paths, lanes


def lane_loop_times(cfg, dev, data, K):
    """``mfm``'s lane path at K lanes built directly (step 20f's
    ``lane_scaling``): two epochs, the second a replay launching each
    kernel once a step, then ``lane_path_times``."""
    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.parallel import multiseed
    from factorized_tpu_torch.train import LaneAdam

    _, apply_fn = get_model("mfm")
    prep = multiseed.prepare_bucket_data(*data, cfg, seed=SEED, device=dev)
    params = multiseed.init_lanes("mfm", cfg, SEED, K, dev)
    opt = LaneAdam(params, 1e-3)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    programs = multiseed.LanePrograms(apply_fn, cfg, gen)
    loop = multiseed.LaneLoop(programs, params, opt, prep["Xb"], prep["yb"],
                              prep["Xv"], prep["yv"], epochs=1)
    loop.run(1)
    loop.run(1)
    lane_epoch_launches(loop, LANE_PATHS["mfm"], f"mfm K = {K}")
    return lane_path_times(loop)


def bucket_evolve_phase(cfg, dev, smi, tmp):
    """Step 21: the shape-bucketed and evolving searches
    (``parallel/multiconfig.py``) and the lane kernels past 8 lanes. (a)
    ``lane_kernel_phase`` at K = 12 (checked, launches counted), 16 and
    32 (also timed, with the library yardsticks), ``scratch_lanes_check``
    at 12, and ``lane_model_check`` of ``LANE_MODEL_PAST_8`` at 12; (b) ``evolve_search_check``; (c)
    ``search_commands``; (d) ``mfm``'s lane path at K = 16 and 32
    (``lane_loop_times``). Returns ({kernel: 21a's numbers at 16}, {path:
    launches}, {kernel: lane launches})."""
    from factorized_tpu_torch.data import mosi

    t0 = time.perf_counter()
    kernels = {}
    for K in LANES_PAST:
        kernels[K] = lane_kernel_phase(cfg, dev, smi, K, timing=K != 12,
                                       library=K in (16, 32))
    scratch = scratch_lanes_check(cfg, dev, LANES_PAST[0])
    model = lane_model_check(cfg, dev, LANE_MODEL_PAST_8, LANES_PAST[0],
                             SEED + 480)
    log({"phase": "lane_kernels_past_8", "nvidia_smi": smi,
         "scratch": scratch, "lane_model": model,
         "seconds": time.perf_counter() - t0})
    data = mosi.get_data(cfg.seqlength)
    t0 = time.perf_counter()
    line, launches, lane = evolve_search_check(cfg, dev, smi, data)
    log({"phase": "evolve_search", "nvidia_smi": smi, **line,
         "seconds": time.perf_counter() - t0})
    paths, lanes = {"evolve_search": launches}, dict(lane)
    t0 = time.perf_counter()
    command_paths, command_lanes = search_commands(smi, tmp)
    paths.update(command_paths)
    for k, v in command_lanes.items():
        lanes[k] = lanes.get(k, 0) + v
    log({"phase": "seconds", "step": "21c", "seconds":
         time.perf_counter() - t0})
    t0 = time.perf_counter()
    times = {str(K): lane_loop_times(cfg, dev, data, K) for K in (16, 32)}
    log({"phase": "lane_scaling_past_8", "nvidia_smi": smi, "path": "mfm",
         "by_lanes": times, "seconds": time.perf_counter() - t0})
    return kernels[16], paths, lanes


# ------------------------------------------- 23. the CMU-MultimodalSDK sets

# each set as step 23 fabricates it: its .csd file names (data/mmsdk.py),
# videos and segments (CMU-MOSEI's published 3,228 videos and about 23,500
# segments; CMU-MOSI's 93 and 2,199; the multi-trait sets at MOSI's), the
# published feature widths (GloVe 300, COVAREP 74, FACET 35 for FACET 4.2
# or 47 for MOSI's), the label columns and their range
SDK_SETS = {
    "mosei": dict(files="MOSEI_FILES", videos=3228, segments=23500,
                  dims=(300, 74, 35), labels=7, low=-3.0, high=3.0),
    "mosi": dict(files="DEFAULT_FILES", videos=93, segments=2199,
                 dims=(300, 74, 47), labels=1, low=-3.0, high=3.0),
    "mosei_traits": dict(files="MOSEI_FILES", videos=93, segments=2199,
                         dims=(300, 74, 35), labels=7, low=-3.0, high=3.0),
    "pom_traits": dict(files="POM_FILES", videos=93, segments=2199,
                       dims=(300, 74, 35), labels=17, low=1.0, high=7.0),
}
# the one cut: rows a word of the audio and visual sequences (the real
# files' 100 Hz COVAREP and 30 fps FACET give tens a word; the alignment
# that averages them is host work)
SDK_FRAMES = (3, 2)
SDK_WORDS = (8, 33)  # words a segment, uniform (the last 20 are kept)
# the main path's kernels and, by name, the device kernels of each in a
# trace (step 2's ptxas names)
TRACE_KERNELS = {"mfm_encode_fwd": ("cell_chains_fwd_kernel",
                                    "mem_chain_fwd_kernel"),
                 "mfm_encode_bwd": ("gates_kernel", "mem_chain_kernel",
                                    "lstm_chains_kernel"),
                 "mfm_encode_dw": ("mfm_encode_dw_kernel",),
                 "decoder_lstm_fwd": ("lstm_chain_fwd_kernel",),
                 "decoder_lstm_bwd": ("lstm_chain_bwd_kernel",)}
# the card's float32 peak outside the tensor cores (FLOP/s, PEAK_FLOPS's)
FP32_PEAK = 67e12


def sdk_segments(videos, segments, dims, labels, low, high, seed, **_):
    """A set's four sequences as ``mmsdk.read_csd`` returns them,
    {segment_id: (features float32, intervals float64)}, made in bulk from
    ``seed``: ``segments`` spread over ``videos`` (at least one each),
    ``SDK_WORDS`` words a segment of 0.3 s each, ``SDK_FRAMES`` audio and
    visual rows a word, a few audio values -inf or NaN, one label row a
    segment, uniform in [low, high)."""
    rng = np.random.default_rng(seed)
    per_video = 1 + rng.multinomial(segments - videos,
                                    np.full(videos, 1.0 / videos))
    words = rng.integers(*SDK_WORDS, size=segments)
    total = int(words.sum())
    fa, fv = SDK_FRAMES
    text = rng.standard_normal((total, dims[0]), dtype=np.float32)
    audio = rng.standard_normal((total * fa, dims[1]), dtype=np.float32)
    audio[rng.random(audio.shape) < 1e-4] = -np.inf
    audio[rng.random(audio.shape) < 1e-4] = np.nan
    visual = rng.standard_normal((total * fv, dims[2]), dtype=np.float32)
    label = rng.uniform(low, high, (segments, 1, labels))
    seqs = {"text": {}, "audio": {}, "visual": {}, "labels": {}}
    at, k = 0, 0
    for v, n_seg in enumerate(per_video):
        for s in range(n_seg):
            n = int(words[k])
            start = 0.3 * np.arange(n)
            seg_id = f"v{v:05d}[{s}]"
            seqs["text"][seg_id] = (text[at:at + n],
                                    np.stack([start, start + 0.3], 1))
            for key, rows, feats in (("audio", fa, audio),
                                     ("visual", fv, visual)):
                t0 = 0.3 / rows * np.arange(n * rows)
                seqs[key][seg_id] = (feats[at * rows:(at + n) * rows],
                                     np.stack([t0, t0 + 0.3 / rows], 1))
            seqs["labels"][seg_id] = (label[k], np.array([[0.0, 0.3 * n]]))
            at += n
            k += 1
    return seqs


@contextlib.contextmanager
def sdk_root(root, files, seqs, h5):
    """A directory of the set's .csd files: written by h5py where it
    imports (``h5``); else empty files of those names, and
    ``mmsdk.read_csd`` serving each one's sequence, so that everything
    below the read (alignment, split, cache, the command) runs as it is."""
    import os

    from factorized_tpu_torch.data import mmsdk

    os.makedirs(root, exist_ok=True)
    paths = {os.path.join(root, files[kind]): seq
             for kind, seq in seqs.items()}
    if h5:
        import h5py

        for path, seq in paths.items():
            with h5py.File(path, "w") as f:
                data = f.create_group("sequence").create_group("data")
                for seg_id, (feats, ivs) in seq.items():
                    g = data.create_group(seg_id)
                    g.create_dataset("features", data=feats)
                    g.create_dataset("intervals", data=ivs)
        yield root
        return
    for path in paths:
        open(path, "w").close()
    real = mmsdk.read_csd
    mmsdk.read_csd = paths.__getitem__
    try:
        yield root
    finally:
        mmsdk.read_csd = real


def eval_encode_check(loop, sets):
    """The eval encode of ``loop``'s trained parameters over each of
    ``sets`` ({name: (n, t, d) rows}) at once, against its plain version
    at step 3's tolerances; each call's device ms."""
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.ops import cuda_mfn

    out = {}
    cfg, params = loop.program.cfg, loop.params
    with torch.inference_mode():
        for name, X in sets.items():
            x = torch.from_numpy(X).to("cuda").transpose(0, 1).contiguous()
            (xp, weights, z_tot, h_dims), _ = mfm.kernel_operands(params, x,
                                                                  cfg)
            got = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
            want = cuda_mfn.mfm_encode_plain(xp, weights, z_tot)
            err = compare_all(f"sdk.eval_encode.{name}",
                              zip(("h_last", "mem_last"), got, want))
            out[name] = {"rows": int(X.shape[0]),
                         "max_abs_err": err["max_abs_err"],
                         "device_ms": queued_ms(lambda: cuda_mfn.mfm_encode(
                             xp, weights, z_tot, h_dims), reps=10)}
    return out


def trace_kernels(directory, nb):
    """The kernels a ``--profile`` trace names: device events by kernel
    of the path (``TRACE_KERNELS``); fails unless each appears, and unless
    the weight gradients' kernel appears once a step of both epochs (the
    eager one and the replay: a graph's replays show in the trace)."""
    import glob

    (path,) = glob.glob(f"{directory}/*.pt.trace.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    counts = {kernel: {n: sum(n in e.get("name", "") for e in events)
                       for n in names}
              for kernel, names in TRACE_KERNELS.items()}
    missing = [n for names in counts.values() for n, c in names.items()
               if not c]
    if missing:
        raise AssertionError(f"the trace names no {missing}")
    dw = counts["mfm_encode_dw"]["mfm_encode_dw_kernel"]
    if dw < 2 * nb:
        raise AssertionError(f"the trace shows {dw} weight-gradient "
                             f"kernels in 2 epochs of {nb} steps: the "
                             f"replay is not in it")
    import os

    return {"file_bytes": os.path.getsize(path),
            "kernel_events": len(events), "by_kernel": counts}


def sdk_flops(cfg, dev, mosei_cfg, mosei_step_ms):
    """The model FLOPs of a ``mfm`` train step (``utils/flops.py``) and the
    executed FLOPs of the plain path, at ``cfg`` (its step's device ms
    measured here, ``profile_steps``) and at the MOSEI run's config (its
    step's device ms given), each with its share of the card's float32
    peak over the step's device time."""
    from factorized_tpu_torch.models import get_model, mfm
    from factorized_tpu_torch.train import TrainProgram, make_optimizer
    from factorized_tpu_torch.utils.flops import model_train_flops_per_step

    _, apply_fn = get_model("mfm")
    tree = mfm.MFM(cfg, seed=SEED, device=dev).tree()
    opt = make_optimizer(tree, 1e-3)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((cfg.seqlength, cfg.batchsize, cfg.d_total),
                    generator=gen, device=dev)
    y = torch.randn((cfg.batchsize,), generator=gen, device=dev)
    step_ms = profile_steps(TrainProgram(apply_fn, cfg), tree, opt, x, y,
                            gen)["device_ms_per_step"]
    out = {}
    for label, c, ms in (("best_acc_mosi_config", cfg, step_ms),
                         ("mosei_sdk", mosei_cfg, mosei_step_ms)):
        model = model_train_flops_per_step(c)
        out[label] = {
            "input_dims": c.input_dims, "batch": c.batchsize,
            "model_flops": model,
            "executed_flops_plain": model_train_flops_per_step(c, fused=True),
            "step_device_ms": ms,
            "fp32_peak_share": model / (ms * 1e-3) / FP32_PEAK}
    return out


def sdk_phase(cfg, dev, smi, tmp):
    """Step 23: the CMU-MultimodalSDK sets (``data/mmsdk.py``, ``--split``,
    ``multitrait --style mosei_sdk|pom_sdk``, ``predictor --dataset
    *_sdk``) at their published sizes and widths, fabricated from ``SEED``
    (``sdk_segments``; the one cut ``SDK_FRAMES``), as .csd files where
    h5py imports, else through ``read_csd``'s stand-in (``sdk_root``).
    (a) MOSEI: the read and alignment, then a cache hit, host seconds;
    ``mosei_sdk --type mfm --mode best --epochs 2 --save-ckpt`` through
    the command: finite falling losses, every kernel of the path once a
    step of the replayed epoch, the path's device ms and launches a step,
    replayed epoch s, the capture's ms and pool bytes (``path_times``);
    the eval encode of the trained parameters at the validation and test
    row counts against its plain version; the checkpoint served on the
    test set against the CPU ``Predictor``. (b) At MOSI's size, 2 epochs
    each: ``mosi_sdk --seeds 4``, ``mosi_sdk --mode search --evolve 2
    --trials 4``, ``multitrait --style mosei_sdk`` and ``pom_sdk``,
    ``predictor --dataset mosi_sdk --kind mfn --mode best`` and ``--kind
    eflstm --split 40,10`` (its batches the split's), ``mosi_sdk --mode
    best --profile`` (the trace names the path's kernels, the replay's
    too). (c) ``warmup``, each leg's seconds. (d) The FLOPs of a ``mfm``
    step and their share of the float32 peak. Returns ({path: launches},
    {kernel: lane launches})."""
    import importlib.util
    import os

    from factorized_tpu_torch import cli
    from factorized_tpu_torch.data import mmsdk
    from factorized_tpu_torch.serve import Predictor

    h5 = importlib.util.find_spec("h5py") is not None
    # a directory of this step's own: the commands' run ids repeat earlier
    # steps' (predictor's mfn_0), and a run log is appended to
    tmp = os.path.join(tmp, "sdk")
    paths, lanes = {}, {}
    mfm_path = LANE_PATHS["mfm"]

    def make(name, seed):
        spec = SDK_SETS[name]
        t0 = time.perf_counter()
        seqs = sdk_segments(**spec, seed=seed)
        return spec, seqs, time.perf_counter() - t0

    # (a) MOSEI at its published size
    spec, seqs, made_s = make("mosei", SEED + 230)
    files = getattr(mmsdk, spec["files"])
    root = os.path.join(tmp, "mosei_sdk")
    t0 = time.perf_counter()
    with sdk_root(root, files, seqs, h5):
        written_s = time.perf_counter() - t0
        del seqs
        t0 = time.perf_counter()
        data = mmsdk.get_data(cfg.seqlength, data_root=root, files=files)
        read_align_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hit = mmsdk.get_data(cfg.seqlength, data_root=root, files=files)
        cache_hit_s = time.perf_counter() - t0
        for a, b in zip(data, hit):
            if not np.array_equal(a, b):
                raise AssertionError("the cache hit differs from the read")
        del hit
        line, launches, loop, runs = command_run(
            "mosei_sdk", ["--type", "mfm", "--mode", "best", "--data-root",
                          root, "--save-ckpt"], "mosei_sdk_0", mfm_path, tmp)
    paths["mosei_sdk"] = launches
    line["replayed_epoch_launches"] = lane_epoch_launches(
        loop, mfm_path, "mosei_sdk")
    t0 = time.perf_counter()
    line["times"] = path_times(loop, replays=2, profile_replay=False)
    line["times_seconds"] = time.perf_counter() - t0
    line["eval_encode"] = eval_encode_check(loop, {"valid": data[2],
                                                   "test": data[4]})
    mosei_cfg = loop.program.cfg
    line["valid_rows_at_once"] = int(loop.valid_set[0].shape[1])
    ckpt = os.path.join(runs, "ckpt_mosei_sdk_0")
    predictor = Predictor.from_checkpoint(ckpt)
    y, _, served = counted("serve mosei_sdk", ("mfm_encode_fwd",),
                           lambda: predictor.predict(data[4]))
    chunks = -(-data[4].shape[0] // predictor.batch_size)
    if served["mfm_encode_fwd"] != chunks or y.shape != data[5].shape:
        raise AssertionError(f"serving the mosei_sdk checkpoint: {y.shape}, "
                             f"launches {served}, {chunks} chunks")
    reference = Predictor.from_checkpoint(ckpt, device="cpu")
    line["served"] = {
        "input_dims": predictor.cfg.input_dims, "rows": int(y.shape[0]),
        "encode_launches": served["mfm_encode_fwd"],
        "max_abs_err_vs_cpu": compare(
            "serve.mosei_sdk", torch.from_numpy(y[:N_SERVE]),
            torch.from_numpy(reference.predict(data[4][:N_SERVE])))[
                "max_abs_err"]}
    log({"phase": "sdk", "set": "mosei", "nvidia_smi": smi, "h5py": h5,
         "videos": spec["videos"], "segments": spec["segments"],
         "rows": [int(data[i].shape[0]) for i in (0, 2, 4)],
         "input_dims": data.input_dims, "array_bytes": sum(
             a.nbytes for a in data),
         "cut": f"{SDK_FRAMES[0]} audio and {SDK_FRAMES[1]} visual rows a "
                f"word (the real files give tens)",
         "fabricate_s": made_s, "write_s": written_s,
         "read_align_s": read_align_s, "cache_hit_s": cache_hit_s, **line})
    del data, loop, predictor, reference

    # (b) at MOSI's size
    t0 = time.perf_counter()
    spec, seqs, _ = make("mosi", SEED + 231)
    root = os.path.join(tmp, "mosi_sdk")
    with sdk_root(root, mmsdk.DEFAULT_FILES, seqs, h5):
        runs = {}
        lane_line, _, _ = lane_command("mosi_sdk", ["--type", "mfm",
                                                    "--data-root", root],
                                       "mosi_sdk_0", mfm_path, tmp, 4)
        runs["seeds_4"] = (lane_line, lane_line["launches"],
                           lane_line["lane_launches"])
        evolve = search_command(
            "mosi_sdk", ["--mode", "search", "--evolve", "2", "--trials",
                         "4", "--epochs", str(TRAIN_EPOCHS), "--seed",
                         str(SEED), "--data-root", root],
            ["mosi_sdk_evolve0"], mfm_path,
            os.path.join(tmp, "sdk_evolve"), "mosi_sdk --evolve 2")
        runs["evolve"] = evolve[:3]
        for label, argv, run_id, kernels in (
                ("predictor_mfn", ["--dataset", "mosi_sdk", "--kind", "mfn",
                                   "--mode", "best"], "mfn_0",
                 mfm_path[:3]),
                ("predictor_eflstm_split", ["--dataset", "mosi_sdk", "--kind",
                                            "eflstm", "--split", "40,10"],
                 "eflstm_0", ("multi_lstm_fwd", "multi_lstm_bwd"))):
            got, launches, loop, _ = command_run(
                "predictor", [*argv, "--data-root", root], run_id, kernels,
                tmp)
            if label.endswith("split"):
                split = mmsdk.get_data(20, data_root=root, split=(40, 10))
                nb = split[0].shape[0] // loop.batches[0].shape[2]
                if loop.batches[0].shape[0] != nb:
                    raise AssertionError(f"--split 40,10 trained "
                                         f"{loop.batches[0].shape[0]} "
                                         f"batches, not {nb}")
                got["split_rows"] = [int(split[i].shape[0])
                                     for i in (0, 2, 4)]
            got["epoch_launches"] = lane_epoch_launches(loop, kernels,
                                                              label)
            runs[label] = (got, launches, {})
        prof = os.path.join(tmp, "sdk_profile")
        got, launches, loop, _ = command_run(
            "mosi_sdk", ["--type", "mfm", "--mode", "best", "--data-root",
                         root, "--profile", prof], "mosi_sdk_0", mfm_path,
            tmp)
        got["trace"] = trace_kernels(prof, int(loop.batches[0].shape[0]))
        runs["profile"] = (got, launches, {})
    del seqs
    for name, style, seed in (("mosei_traits", "mosei_sdk", SEED + 232),
                              ("pom_traits", "pom_sdk", SEED + 233)):
        spec, seqs, _ = make(name, seed)
        root = os.path.join(tmp, name)
        with sdk_root(root, getattr(mmsdk, spec["files"]), seqs, h5):
            got, launches, loop, _ = command_run(
                "multitrait", ["--style", style, "--mode", "best",
                               "--data-root", root], f"{style}_0", mfm_path,
                tmp, printed_key="mae: [")
        got["traits"] = spec["labels"]
        runs[f"multitrait_{style}"] = (got, launches, {})
    for label, (got, launches, lane) in runs.items():
        log({"phase": "sdk", "set": "mosi_size", "run": label,
             "nvidia_smi": smi, "h5py": h5, **got})
        paths[f"sdk_{label}"] = launches
        for k, v in lane.items():
            lanes[k] = lanes.get(k, 0) + v
    log({"phase": "seconds", "step": "23b",
         "seconds": time.perf_counter() - t0})

    # (c) warmup
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc, seconds, launches = counted("warmup", mfm_path,
                                        lambda: cli.main(["warmup"]))
    legs = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^warmup (\S+)\s+([0-9.]+)s\s+ok$", printed.getvalue(), re.M)}
    if rc != 0 or len(legs) != 8:
        raise AssertionError(f"warmup exited {rc}: {printed.getvalue()}")
    paths["warmup"] = launches
    log({"phase": "sdk_warmup", "nvidia_smi": smi, "legs_s": legs,
         "seconds": seconds})

    # (d) FLOPs
    log({"phase": "sdk_flops", "nvidia_smi": smi,
         "fp32_peak_flops": FP32_PEAK, **sdk_flops(
             cfg, dev, mosei_cfg, line["times"]["device_ms_per_step"])})
    return paths, lanes


# the chain kernels' launch counters a train step of mfm reads
CHAIN_KERNELS = ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
                 "decoder_lstm_fwd", "decoder_lstm_bwd")
# step 24(a): a config either side of the crossover
CROSSOVER_SIDES = ("A_b256_h256", "B_b512_h512")


def chain_counts(fn):
    """fn() with every launch count set to 0 just before and read just
    after: (fn's result, {chain kernel: launches})."""
    for module, attr in counters().values():
        setattr(module, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(m, a) for k, (m, a) in counters().items()
                 if k in CHAIN_KERNELS}


def modular_phase(dev, smi):
    """Step 24 (see the module's docstring)."""
    from factorized_tpu_torch import benchprog, warmup
    from factorized_tpu_torch.convert import from_state_dict, to_state_dict
    from factorized_tpu_torch.perf_probe import reported_plans
    from factorized_tpu_torch.models import mfm
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
    from factorized_tpu_torch.train import make_loss_fn
    from factorized_tpu_torch.utils.flops import model_train_flops_per_step

    # (a) each path's train step either side of the crossover
    candidates = benchprog.scale_candidates()
    saved = mfm.FUSED
    for name in CROSSOVER_SIDES:
        cfg = candidates[name]
        gen = torch.Generator(device=dev).manual_seed(SEED + 24)
        x = torch.randn((cfg.seqlength, cfg.batchsize, cfg.d_total),
                        generator=gen, device=dev)
        y = torch.randn((cfg.batchsize,), generator=gen, device=dev)
        params = mfm.MFM(cfg, seed=SEED, device=dev).tree()
        runs = {}
        try:
            for fused in (True, False):
                mfm.FUSED = fused
                paths = benchprog.active_paths(cfg)
                flat = {k: v.detach().clone().requires_grad_()
                        for k, v in to_state_dict(params).items()}

                def step():
                    loss, _ = make_loss_fn(mfm.mfm_apply, cfg)(
                        from_state_dict(flat), x, y,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 25))
                    loss.backward()
                    return loss.detach()

                cuda_mfn.CLUSTERS.clear()
                cuda_lstm.CLUSTERS.clear()
                loss, launches = chain_counts(step)
                reported = reported_plans(paths)
                if any((n > 0) != fused for n in launches.values()):
                    raise AssertionError(
                        f"{name}: FUSED = {fused} launched {launches}")
                if any(reported[k] != v for k, v in paths.items()
                       if k != "fused_blockdiag"):
                    raise AssertionError(f"{name}: plans {reported}, "
                                         f"active_paths {paths}")
                runs[fused] = (float(loss), {k: v.grad.clone() for k, v in
                                             flat.items()}, launches, paths)
        finally:
            mfm.FUSED = saved
        (loss_f, grads_f, launches_f, paths_f), (loss_m, grads_m,
                                                 launches_m, paths_m) = (
            runs[True], runs[False])
        loss_err = compare(f"modular.{name}.loss", torch.tensor(loss_m),
                           torch.tensor(loss_f), GRAD_RTOL, GRAD_ATOL)
        err = compare_all(f"modular.{name}.grads",
                          [(k, grads_m[k], grads_f[k]) for k in grads_f],
                          GRAD_RTOL, GRAD_ATOL)
        log({"phase": "modular", "config": name, "nvidia_smi": smi,
             "batch": cfg.batchsize,
             "step_flops_estimate": mfm._step_flops_estimate(cfg),
             "crossover": mfm._FUSED_FLOPS_CROSSOVER,
             "gate_fused": mfm.fused_active(cfg),
             "loss_fused": loss_f, "loss_modular": loss_m,
             "loss_abs_err": loss_err["max_abs_err"],
             "grads_max_abs_err": err["max_abs_err"],
             "grads_tol_ratio": err["tol_ratio"],
             "launches_fused": launches_f, "launches_modular": launches_m,
             "active_paths_fused": paths_f,
             "active_paths_modular": paths_m})
        del params, runs, grads_f, grads_m
        torch.cuda.empty_cache()

    # (b) the scale config on the gate's path, then the bench legs
    scfg = benchprog.scale_cfg()
    paths = benchprog.active_paths(scfg)
    torch.cuda.reset_peak_memory_stats()
    program, params, opt = benchprog.build_train_state(scfg, seed=SEED,
                                                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    t, B, d = scfg.seqlength, scfg.batchsize, scfg.d_total
    sX = torch.randn((benchprog.SCALE_NB, t, B, d), generator=gen,
                     device=dev)
    sy = torch.randn((benchprog.SCALE_NB, B), generator=gen, device=dev)
    chunk = benchprog.make_chunk(program, e=benchprog.SCALE_E)
    t0 = time.perf_counter()
    trs, launches = chain_counts(lambda: chunk(params, opt, sX, sy, gen,
                                               1e-3))
    first_s = time.perf_counter() - t0
    if any((n > 0) != paths["fused_blockdiag"] for n in launches.values()):
        raise AssertionError(f"scale_cfg: active_paths {paths}, launches "
                             f"{launches}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    trs_again = chunk(params, opt, sX, sy, gen)
    end.record()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    losses = torch.cat([trs, trs_again]).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"scale_cfg: losses {losses}")
    (graph, _), = chunk.graphs.values()
    step_ms = start.elapsed_time(end) / (benchprog.SCALE_E
                                         * benchprog.SCALE_NB)
    flops = model_train_flops_per_step(scfg)
    log({"phase": "scale_chunk", "nvidia_smi": smi, "batch": B,
         "epochs": 2 * benchprog.SCALE_E, "batches": benchprog.SCALE_NB,
         "gate_fused": mfm.fused_active(scfg), "active_paths": paths,
         "launches": launches, "losses": losses,
         "step_device_ms": step_ms, "model_flops": flops,
         "f32_peak_share": flops / (step_ms * 1e-3) / PEAK_F32_FLOPS,
         "first_chunk_s": first_s, "replay_chunk_s": replay_s,
         "replay_epoch_s": replay_s / benchprog.SCALE_E,
         "capture_s": graph.capture_ms / 1e3,
         "graph_pool_bytes": graph.pool_bytes,
         "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    del program, params, opt, chunk, graph, sX, sy
    torch.cuda.empty_cache()
    legs = {}
    for name, fn in warmup.bench_legs(dev):
        t0 = time.perf_counter()
        _, launches = chain_counts(fn)
        legs[name] = {"seconds": time.perf_counter() - t0,
                      "launches": launches}
    scale_fused = mfm.fused_active(scfg)
    for name, leg in legs.items():
        fused = scale_fused if name == "bench_scale_chunk" else True
        if any((n > 0) != fused for n in leg["launches"].values()):
            raise AssertionError(f"{name}: launches {leg['launches']}")
    log({"phase": "bench_legs", "nvidia_smi": smi, "legs": legs})


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


# ---- step 26: beyond one process (its ranks are subprocesses, so no
#      process group outlives the step)

DP_BATCHES = 19  # the batches of 32 in an epoch of synthetic MOSI


def rank_cli(device, argv, out, world=None):
    """A rank of step 26b: the command line ``argv`` (its JSONL under
    ``out``) with ``world`` (torchrun's variables) set first and the
    CUDA-graph captures counted. Returns the exit code, the captures, the
    launches and rank 0's epoch and final records."""
    import os

    from factorized_tpu_torch import cli, train
    from factorized_tpu_torch.ops import counts
    from factorized_tpu_torch.parallel.sharding import is_writer

    os.environ.update(world or {})
    captures = []
    capture = train.Graphed._capture

    def counting(self):
        captures.append(1)
        return capture(self)

    train.Graphed._capture = counting
    before = counts.snapshot()
    rc = cli.main(argv)
    records = None
    if is_writer():
        with open(os.path.join(out, "mosi_0.jsonl")) as f:
            records = [{k: v for k, v in r.items() if k != "ts"}
                       for r in map(json.loads, f)
                       if r["kind"] in ("epoch", "final")]
    return {"rc": rc, "captures": len(captures),
            "launches": counts.named(counts.since(before)),
            "records": records}


def tp_epoch(device, tp, batches):
    """One epoch of ``best_acc_mosi_config`` from seeded parameters on
    ``batches`` seeded batches of 32: in this process, or with ``tp`` the
    text decoder's weights cut over the ``model`` axis of a ``("data",
    "model")`` mesh of the world. Returns the whole parameters, the
    epoch's loss and the launches."""
    from factorized_tpu_torch.config import best_acc_mosi_config
    from factorized_tpu_torch.convert import to_state_dict
    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.ops import counts
    from factorized_tpu_torch.parallel import sharding
    from factorized_tpu_torch.train import FlatAdam, TrainProgram
    from torch.utils import _pytree

    cfg = best_acc_mosi_config()
    dev = torch.device(device)
    init, apply_fn = get_model("mfm")
    tree = init(torch.Generator().manual_seed(SEED + 7), cfg)
    params = _pytree.tree_map(lambda a: a.to(dev), tree)
    rng = np.random.default_rng(SEED + 7)
    Xb = torch.from_numpy(rng.normal(size=(
        batches, cfg.seqlength, N_TRAIN, cfg.d_total)).astype(np.float32))
    yb = torch.from_numpy(rng.normal(size=(batches, N_TRAIN)).astype(
        np.float32))
    tpar = None
    if tp:
        mesh = sharding.make_mesh(axes=("data", "model"), device=dev)
        dp = sharding.DataParallel(mesh)
        Xb, yb = dp.epoch_batches(Xb, yb)
        tpar = sharding.tp_param_shardings(mesh, dp.params(params))
        params = tpar.params
        program = dp.program(tpar.apply(apply_fn), cfg)
    else:
        program = TrainProgram(apply_fn, cfg)
    opt = FlatAdam(params, 1e-3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    before = counts.snapshot()
    acc = float(program.epoch(params, opt, Xb.to(dev), yb.to(dev), gen))
    out = opt.tree_of(opt.flat)
    if tpar is not None:
        out = tpar.full(out)
    return {"params": {k: v.detach().cpu()
                       for k, v in to_state_dict(out).items()},
            "acc": acc, "launches": counts.named(counts.since(before)),
            "sharded": sorted(tpar.sharded) if tpar else []}


def tp_rank(device, batches):
    """A rank of step 26c (``tp_epoch`` with ``tp``)."""
    return tp_epoch(device, True, batches)


def by_kernel(launches):
    """A rank's launches (``counts.named``) by kernel name: (plain counts, lane
    counts)."""
    plain = {name: launches[f"{m.__name__.rsplit('.', 1)[-1]}.{a}"]
             for name, (m, a) in counters().items()}
    lanes = {}
    for key in ("cuda_mfn.LANE_LAUNCHES", "cuda_lstm.LANE_LAUNCHES"):
        for k, v in launches.get(key, {}).items():
            lanes[k] = lanes.get(k, 0) + v
    return plain, lanes


TRAIN_KERNELS = ("mfm_encode_fwd", "mfm_encode_bwd", "mfm_encode_dw",
                 "decoder_lstm_fwd", "decoder_lstm_bwd")


def records_close(got, want, label, exact=False):
    """Two runs' epoch and final records: equal, or within C's bounds
    (losses 1e-5 relative, metrics 1e-5 relative + 1e-6)."""
    if exact:
        if got != want:
            raise AssertionError(f"{label}: the records differ: {got} "
                                 f"against {want}")
        return 0.0
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if g["kind"] != w["kind"]:
            raise AssertionError(f"{label}: {g['kind']} against {w['kind']}")
        pairs = ([(g[k], w[k], 0.0) for k in ("train_loss", "valid_loss")]
                 if g["kind"] == "epoch" else
                 [(gm[k], wm[k], 1e-6) for gm, wm in zip(
                     g["per_seed"], w["per_seed"], strict=True)
                  for k in wm if isinstance(wm[k], float)])
        for a, b, atol in pairs:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            err = np.abs(a - b)
            worst = max(worst, float(err.max()))
            if not (err <= 1e-5 * np.abs(b) + atol).all():
                raise AssertionError(f"{label}: {a} against {b}")
    return worst


def distributed_phase(cfg, smi, tmp):
    """Step 26; returns the launches of its runs by kernel name (plain,
    lanes)."""
    import importlib.util
    import os

    from factorized_tpu_torch.parallel import multiprocess
    from factorized_tpu_torch.parallel.sharding import free_port

    here = os.path.abspath(__file__)
    # the ranks of 26b and 26c: tests/torch_ranks.py, each a process
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(os.path.dirname(here), "tests",
                                    "torch_ranks.py"))
    torch_ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_ranks)
    run_ranks = torch_ranks.run_ranks
    plain, lanes = {}, {}

    def add(launches):
        p, ln = by_kernel(launches)
        for k, v in p.items():
            plain[k] = plain.get(k, 0) + v
        for k, v in ln.items():
            lanes[k] = lanes.get(k, 0) + v
        return p, ln

    # ---- 26a. two gloo ranks on the card, batch 16 each, against one
    #      process at batch 32: best_acc_mosi_config, 2 epochs of 19
    t0 = time.perf_counter()
    rep = multiprocess.verify_multiprocess(
        2, 1, epochs=2, timeout=600, atol=GRAD_ATOL, rtol=GRAD_RTOL,
        device="cuda:0", backend="gloo", config="best")
    ranks = [add(r)[0] for r in rep["launches"]]
    single = add(rep["single_launches"])[0]
    for who, counted_ in [*enumerate(ranks), ("single", single)]:
        for name in TRAIN_KERNELS:
            if counted_[name] < 1:
                raise AssertionError(f"26a: {name} not launched by {who}")
    log({"phase": "distributed_dp", "nvidia_smi": smi,
         "config": "best_acc_mosi_config", "ranks": 2, "backend": "gloo",
         "rows_a_rank": cfg.batchsize // 2, "epochs": 2,
         "batches": multiprocess.payload("best")[1],
         "max_abs_diff_vs_single_process":
             rep["max_abs_diff_vs_single_process"],
         "rtol": GRAD_RTOL, "atol": GRAD_ATOL,
         "tol_ratio": rep["tol_ratio"],
         "ranks_bitwise_equal": rep["ranks_bitwise_equal"],
         "accs": rep["accs"],
         "launches_by_rank": [{k: c[k] for k in TRAIN_KERNELS}
                              for c in ranks],
         "launches_single": {k: single[k] for k in TRAIN_KERNELS},
         "seconds": time.perf_counter() - t0})

    # ---- 26b. --seed-parallel --seeds 8 --multihost, WORLD_SIZE=1 under
    #      NCCL, against --seeds 8 (both at once, each its own process);
    #      then two gloo ranks of 4 lanes on the card
    t0 = time.perf_counter()
    argv = ["mosi", "--mode", "best", "--seeds", "8", "--epochs",
            str(TRAIN_EPOCHS), "--seed", str(SEED)]
    outs = [os.path.join(tmp, f"sp{i}") for i in range(3)]
    world = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    sp_argv = [*argv, "--seed-parallel", "--multihost"]
    with ThreadPoolExecutor(2) as ex:
        one = ex.submit(run_ranks, f"{here}:rank_cli", 1,
                        {"argv": [*sp_argv, "--out", outs[0]],
                         "out": outs[0], "world": world},
                        device="cuda", timeout=600)
        ref = ex.submit(run_ranks, f"{here}:rank_cli", 1,
                        {"argv": [*argv, "--out", outs[1]], "out": outs[1]},
                        device="cuda", timeout=600)
        (one,), (ref,) = one.result(), ref.result()
    two = run_ranks(
        f"{here}:rank_cli", 2, {"argv": [*sp_argv, "--out", outs[2]],
                                "out": outs[2]},
        device="cuda:0", backend="gloo", timeout=600)
    for run in (one, ref, *two):
        if run["rc"] != 0 or run["captures"] != 1:
            raise AssertionError(f"26b: rc {run['rc']}, {run['captures']} "
                                 "captures (one wanted)")
        add(run["launches"])
    records_close(one["records"], ref["records"], "26b world of one",
                  exact=True)
    worst = records_close(two[0]["records"], ref["records"],
                          "26b two gloo ranks")
    epochs = [r for r in ref["records"] if r["kind"] == "epoch"]
    if not np.isfinite([r["train_loss"] for r in epochs]).all():
        raise AssertionError(f"26b: losses {epochs}")
    log({"phase": "distributed_lanes", "nvidia_smi": smi, "seeds": 8,
         # a world of one issues no collective: NCCL joined, not used
         "world_of_one": {"backend": "nccl", "collectives": 0,
                          "bitwise_seeds_8": True},
         "captures": [one["captures"], ref["captures"],
                      *[r["captures"] for r in two]],
         "two_gloo_ranks_max_abs_diff": worst,
         "lane_launches": {"world_of_one": by_kernel(
             one["launches"])[1], "one_process": by_kernel(
             ref["launches"])[1], "by_rank": [by_kernel(r["launches"])[1]
                                              for r in two]},
         "train_loss": [r["train_loss"] for r in epochs],
         "seconds": time.perf_counter() - t0})

    # ---- 26c. tensor parallelism over two gloo ranks on the card: one
    #      epoch against the replicated one in this process
    t0 = time.perf_counter()
    tps = run_ranks(f"{here}:tp_rank", 2,
                                 {"batches": DP_BATCHES}, device="cuda:0",
                                 backend="gloo", timeout=600)
    want = tp_epoch("cuda", False, DP_BATCHES)
    add(want["launches"])
    worst = 0.0
    keys = sorted(want["params"])
    for r in tps:
        add(r["launches"])
        flat = [torch.cat([p[k].flatten() for k in keys])
                for p in (r["params"], want["params"])]
        worst = max(worst, compare("26c parameters", *flat, GRAD_RTOL,
                                   GRAD_ATOL)["max_abs_err"])
        if not np.isclose(r["acc"], want["acc"], rtol=1e-5, atol=0.0):
            raise AssertionError(f"26c: loss {r['acc']} against "
                                 f"{want['acc']}")
    if not all(torch.equal(tps[0]["params"][k], tps[1]["params"][k])
               for k in want["params"]):
        raise AssertionError("26c: the ranks' parameters differ")
    log({"phase": "distributed_tp", "nvidia_smi": smi, "mesh": [1, 2],
         "sharded": tps[0]["sharded"], "max_abs_err": worst,
         "rtol": GRAD_RTOL, "atol": GRAD_ATOL,
         "acc": [r["acc"] for r in tps], "acc_replicated": want["acc"],
         "launches_by_rank": [{k: by_kernel(r["launches"])[0][k]
                               for k in TRAIN_KERNELS} for r in tps],
         "seconds": time.perf_counter() - t0})
    return plain, lanes


if __name__ == "__main__":
    sys.exit(main())
