"""``python -m factorized_tpu_torch warmup``: the port's cold start (port
of ``factorized_tpu/warmup.py``).

On the card one thing outlives a process: the kernels' library, built by
``nvcc`` at first use into
``build/factorized_tpu_torch/libftt_kernels_<hash>.so`` and reused by
every later process whose sources and flags hash the same
(``ops/_build.py``; the port's persistent cache, in place of the JAX
package's compile cache). A CUDA graph lives only as long as its
process. The command builds the library (or finds it) and runs the main
programs once, each leg timed:

1. ``library``: ``_build.load_library`` (on the card only);
2. the bench legs (``bench_legs``), the JAX command's first three, each
   program built by ``benchprog.py``:
   ``bench_epoch_dispatched``, one epoch of ``NB`` batches at
   ``build_cfg`` through ``TrainProgram.epoch``; ``bench_chunk_e20``, a
   chunk of ``E`` epochs from a fresh state (``make_chunk``: on the card
   one epoch's graph captured and replayed); ``bench_scale_chunk``,
   ``scale_cfg`` (on the path the gate picks) for a chunk of ``SCALE_E``
   epochs of ``SCALE_NB`` batches drawn on the device;
3. ``trainer_chunked_loop_mosi``: ``trainers.train_mfm`` at
   ``best_acc_mosi_config`` on the synthetic MOSI set, 2 epochs of the
   chunked loop: the eager epoch, then the capture and its replay;
4. ``multiseed_k8``: ``train_mfm_multiseed`` over 8 lanes, 2 epochs;
5. ``serve_mfn_mae``, ``serve_mfn_acc``: a ``Predictor`` on each released
   checkpoint (``factorized_tpu_torch/released/``) and one padded batch.

A failed leg is printed and the others still run; the command then exits
1.
"""

from __future__ import annotations

import os
import time

import torch

EPOCHS = 2
LANES = 8


def _leg(name, fn, results):
    t0 = time.perf_counter()
    err = ""
    try:
        fn()
    except Exception as e:  # warm the rest; report at the end
        err = f"{type(e).__name__}: {e}"
    dt = time.perf_counter() - t0
    results.append((name, dt, err))
    status = "FAILED " + err if err else "ok"
    print(f"warmup {name:<28s} {dt:8.2f}s  {status}", flush=True)


def bench_legs(device):
    """The bench legs as ``[(name, fn)]``, in the JAX command's order; each
    fn builds its program and state afresh and waits for its last loss."""
    from factorized_tpu_torch import benchprog

    def inputs():
        cfg = benchprog.build_cfg()
        return cfg, benchprog.epoch_inputs(cfg, nb=benchprog.NB,
                                           device=device)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def bench_epoch():
        cfg, (Xb, yb) = inputs()
        program, params, opt = benchprog.build_train_state(cfg,
                                                           device=device)
        float(program.epoch(params, opt, Xb, yb, generator(2), 1e-3))

    def bench_chunk():
        cfg, (Xb, yb) = inputs()
        program, params, opt = benchprog.build_train_state(cfg,
                                                           device=device)
        chunk = benchprog.make_chunk(program, e=benchprog.E)
        float(chunk(params, opt, Xb, yb, generator(5), 1e-3)[-1])

    def bench_scale():
        scfg = benchprog.scale_cfg()
        program, params, opt = benchprog.build_train_state(scfg,
                                                           device=device)
        gen = generator(7)
        t, B, d = scfg.seqlength, scfg.batchsize, scfg.d_total
        sX = torch.randn((benchprog.SCALE_NB, t, B, d), generator=gen,
                         device=device)
        sy = torch.randn((benchprog.SCALE_NB, B), generator=gen,
                         device=device)
        chunk = benchprog.make_chunk(program, e=benchprog.SCALE_E)
        float(chunk(params, opt, sX, sy, generator(5), 1e-3)[-1])

    return [("bench_epoch_dispatched", bench_epoch),
            ("bench_chunk_e20", bench_chunk),
            ("bench_scale_chunk", bench_scale)]


def run_warmup(args):
    import numpy as np

    from factorized_tpu_torch import resolve_device
    from factorized_tpu_torch.config import best_acc_mosi_config
    from factorized_tpu_torch.ops import _build

    device = resolve_device(getattr(args, "device", None))
    results = []
    if device.type == "cuda":
        _leg("library", _build.load_library, results)
    for name, fn in bench_legs(device):
        _leg(name, fn, results)
    cfg = best_acc_mosi_config().replace(num_epochs=EPOCHS)

    def mosi():
        from factorized_tpu_torch.data import mosi as reader

        return reader.get_data(cfg.seqlength)

    def trainer_loop():
        from factorized_tpu_torch import trainers
        from factorized_tpu_torch.utils.logging import RunLogger

        trainers.train_mfm(*mosi(), cfg, logger=RunLogger(echo=False),
                           lr=1e-3, device=device)

    _leg("trainer_chunked_loop_mosi", trainer_loop, results)

    def multiseed():
        from factorized_tpu_torch.parallel.multiseed import (
            train_mfm_multiseed)
        from factorized_tpu_torch.utils.logging import RunLogger

        train_mfm_multiseed(*mosi(), cfg, n_seeds=LANES,
                            logger=RunLogger(echo=False), lr=1e-3,
                            device=device)

    _leg(f"multiseed_k{LANES}", multiseed, results)

    released = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "released")
    for name in ("mfn_mae", "mfn_acc"):
        def serve(ckpt=os.path.join(released, name)):
            from factorized_tpu_torch.serve import Predictor

            p = Predictor.from_checkpoint(ckpt, device=device)
            X = np.zeros((p.batch_size, p.cfg.seqlength,
                          sum(p.cfg.input_dims)), np.float32)
            p.predict(X)

        _leg(f"serve_{name}", serve, results)

    total = sum(dt for _, dt, _ in results)
    failed = [n for n, _, e in results if e]
    where = (f"kernels' library at {_build.library_path()}"
             if device.type == "cuda" else "no kernels on the CPU")
    print(f"warmup total {total:.1f}s — {where}"
          + (f"; FAILED: {failed}" if failed else ""), flush=True)
    return 1 if failed else 0
