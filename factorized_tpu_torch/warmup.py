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
2. ``trainer_chunked_loop_mosi``: ``trainers.train_mfm`` at
   ``best_acc_mosi_config`` on the synthetic MOSI set, 2 epochs of the
   chunked loop: the eager epoch, then the capture and its replay;
3. ``multiseed_k8``: ``train_mfm_multiseed`` over 8 lanes, 2 epochs;
4. ``serve_mfn_mae``, ``serve_mfn_acc``: a ``Predictor`` on each released
   checkpoint (``factorized_tpu_torch/released/``) and one padded batch.

A failed leg is printed and the others still run; the command then exits
1. The JAX command's legs that build ``bench.py``'s programs have no
counterpart yet: the port has no benchmark.
"""

from __future__ import annotations

import os
import time

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


def run_warmup(args):
    import numpy as np

    from factorized_tpu_torch import resolve_device
    from factorized_tpu_torch.config import best_acc_mosi_config
    from factorized_tpu_torch.ops import _build

    device = resolve_device(getattr(args, "device", None))
    results = []
    if device.type == "cuda":
        _leg("library", _build.load_library, results)
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
