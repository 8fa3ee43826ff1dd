"""Data-parallel training across processes, run for real (port of
``factorized_tpu/parallel/multiprocess.py``).

One process a device: ``launch(n_processes, local_devices)`` starts
``n_processes * local_devices`` ranks, ``local_devices`` a host, which
join one world through ``sharding.init_distributed``. A rank runs on the
card ``cuda:(process id modulo local devices)`` under NCCL unless the
caller asks for another device (``cpu``: gloo ranks on the host, as the
tests run them) or backend (``gloo``: ranks that share one card). Each
trains the data-parallel payload (``run_payload``) on its rows of the
global batch; ``verify_multiprocess`` holds every rank's trained
parameters and per-epoch losses against one process trained on the
whole batch, and the ranks against each other.

Worker entry (what ``launch`` spawns)::

    python -m factorized_tpu_torch.parallel.multiprocess \\
        --process-id 0 --num-processes 2 --local-devices 1 \\
        --coordinator 127.0.0.1:PORT --out /tmp/w0.npz [--epochs 2] \\
        [--device cpu|cuda:0] [--backend gloo|nccl] [--config demo|best]

``--num-processes 1`` skips ``torch.distributed`` and is the
single-process reference. Every spawned process has a deadline and is
killed when it passes, its output in the error.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def demo_config():
    """The JAX package's tiny MFM config of the payload: the check is of
    placement, collectives and program identity, not of capacity."""
    from factorized_tpu_torch.config import MFMConfig

    return MFMConfig(
        input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
        zy_size=5, zl_size=6, za_size=4, zv_size=5,
        fy_size=4, fl_size=5, fa_size=4, fv_size=3,
        att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
        seqlength=5, batchsize=16,
    )


def payload(config: str = "demo"):
    """The payload's config and its batches an epoch: ``demo``, the JAX
    package's (``demo_config``, 3 batches of 16); ``best``,
    ``best_acc_mosi_config`` at full width over an epoch of synthetic
    MOSI's training split (19 batches of 32)."""
    from factorized_tpu_torch.config import best_acc_mosi_config

    if config == "demo":
        return demo_config(), 3
    if config == "best":
        return best_acc_mosi_config(), 19
    raise ValueError(f"unknown payload config {config!r} (demo or best)")


def run_payload(epochs: int = 2, seed: int = 0, device=None,
                config: str = "demo"):
    """The data-parallel payload over the whole world (a mesh over every
    rank) on ``device`` (None: the rank's card): the ``payload(config)``
    batches from a numpy seed, the global batch cut over the ranks, the
    MFM's joint loss with its dropout and MMD, Adam at lr 1e-3, one
    generator seeded ``seed + 1`` for every epoch's draws. Returns
    ``(flat, accs, launches)``: the trained parameters flat, the
    per-epoch mean tracked losses and the kernel launches of the epochs
    (``ops.counts.named``)."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.ops import counts
    from factorized_tpu_torch.parallel.sharding import (DataParallel,
                                                        make_mesh,
                                                        rank_device)
    from factorized_tpu_torch.train import FlatAdam

    cfg, batches = payload(config)
    dev = rank_device(device)
    mesh = make_mesh(device=dev)
    dp = DataParallel(mesh)
    init, apply_fn = get_model("mfm")
    tree = init(torch.Generator().manual_seed(seed), cfg)
    params = dp.params(pytree.tree_map(lambda a: a.to(dev), tree))
    opt = FlatAdam(params, 1e-3)
    program = dp.program(apply_fn, cfg, "joint")

    rng = np.random.default_rng(seed)
    Xb = rng.normal(size=(batches, cfg.seqlength, cfg.batchsize,
                          cfg.d_total)).astype(np.float32)
    yb = rng.normal(size=(batches, cfg.batchsize)).astype(np.float32)
    Xs, ys = (torch.from_numpy(a).to(dev)
              for a in dp.epoch_batches(Xb, yb))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    before = counts.snapshot()
    accs = [float(program.epoch(params, opt, Xs, ys, gen))
            for _ in range(epochs)]
    return (opt.flat.detach().cpu().numpy(), accs,
            counts.named(counts.since(before)))


def worker_main(argv=None) -> None:
    """Subprocess entry: join the world (unless ``--num-processes 1``),
    run the payload, write the result."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="factorized_tpu_torch.parallel.multiprocess")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True,
                    help="ranks in the world, one process a device")
    ap.add_argument("--local-devices", type=int, required=True,
                    help="ranks a host: this rank's card is cuda:"
                         "(process id modulo this)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port (required when --num-processes > 1)")
    ap.add_argument("--out", required=True, help="npz result path")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: its card, cuda:"
                         "(process id modulo --local-devices)); cpu for "
                         "gloo ranks on the host")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="default: nccl on a card, gloo on the CPU; gloo "
                         "for ranks that share a card")
    ap.add_argument("--config", default="demo", choices=["demo", "best"],
                    help="the payload (see payload())")
    args = ap.parse_args(argv)
    if args.num_processes > 1 and not args.coordinator:
        ap.error("--coordinator is required for --num-processes > 1")

    import numpy as np
    import torch
    import torch.distributed as dist

    from factorized_tpu_torch.parallel import sharding

    device = args.device
    if device in (None, "cuda"):
        device = f"cuda:{args.process_id % args.local_devices}"
    if device == "cpu" and args.num_processes > 1:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.num_processes))
    if args.num_processes > 1:
        sharding.init_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device=device,
                                  backend=args.backend)
        assert sharding.world_size() == args.num_processes
        assert sharding.world_rank() == args.process_id
    try:
        flat, accs, launches = run_payload(args.epochs, 0, device,
                                           args.config)
        np.savez(args.out, flat=flat, accs=np.asarray(accs, np.float64),
                 process_id=args.process_id,
                 num_processes=args.num_processes,
                 local_devices=args.local_devices,
                 launches=json.dumps(launches))
        print(f"[mp worker {args.process_id}/{args.num_processes}] OK "
              f"accs={[round(a, 6) for a in accs]}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(commands, timeout: float, out_dir: str, env=None):
    """One process a command (an argv list), all started together from
    the repository root, with torchrun's variables taken out of the
    environment (``env``: set after); each is killed when ``timeout``
    seconds have passed. Returns [(rc, output)], rc None for a killed
    process."""
    base = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        base.pop(k, None)
    base.update(env or {})
    procs, logs = [], []
    for i, cmd in enumerate(commands):
        log = open(os.path.join(out_dir, f"spawn{i}_{time.time_ns()}.log"),
                   "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            list(map(str, cmd)), cwd=_REPO_ROOT, env=base, stdout=log,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
                rc = p.returncode
            except subprocess.TimeoutExpired:
                rc = None
            outs.append(rc)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    result = []
    for rc, log in zip(outs, logs):
        log.seek(0)
        result.append((rc, log.read()))
        log.close()
    return result


def check(outs, what: str, timeout: float):
    """Raises for the first of ``spawn``'s processes that failed or was
    killed, with its output."""
    for i, (rc, out) in enumerate(outs):
        if rc != 0:
            state = (f"killed after {timeout:.0f} s" if rc is None
                     else f"rc={rc}")
            raise RuntimeError(f"{what} {i}/{len(outs)} failed ({state}):"
                               f"\n{out[-6000:]}")


def worker_command(*args):
    """The command that runs ``worker_main`` with ``args``."""
    return [sys.executable, "-m", "factorized_tpu_torch.parallel."
            "multiprocess", *args]


def _load(path):
    import numpy as np

    r = dict(np.load(path))
    r["launches"] = json.loads(str(r["launches"]))
    return r


def launch(n_processes: int = 2, local_devices: int = 1, epochs: int = 2,
           out_dir: Optional[str] = None, timeout: float = 300.0, *,
           device: Optional[str] = None, backend: Optional[str] = None,
           config: str = "demo", reference: bool = False):
    """Start ``n_processes * local_devices`` ranks of one world (one
    process a device; ``device`` None or ``cuda``: each on its card)
    training the payload; return their results (with ``reference``, then
    the single process's on the whole batch, run at the same time, on
    ``cuda:0`` unless ``device`` names another). Raises on any worker's
    failure, with its output, and before starting any when ``device``
    asks for a card and there is none."""
    from factorized_tpu_torch import resolve_device
    from factorized_tpu_torch.parallel.sharding import free_port

    resolve_device(device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="ftt_mp_")
    n = n_processes * local_devices
    paths = [os.path.join(out_dir, f"worker{i}.npz") for i in range(n)]
    extra = ["--epochs", epochs, "--config", config,
             *(["--device", device] if device else [])]
    port = free_port()
    commands = [worker_command(
        "--process-id", i, "--num-processes", n, "--local-devices",
        local_devices, "--coordinator", f"127.0.0.1:{port}", "--out",
        paths[i], *(["--backend", backend] if backend else []), *extra)
        for i in range(n)]
    ref_path = os.path.join(out_dir, "single.npz")
    if reference:
        commands.append(worker_command(
            "--process-id", 0, "--num-processes", 1, "--local-devices", 1,
            "--out", ref_path, *extra))
    outs = spawn(commands, timeout, out_dir)
    check(outs[:n], "multiprocess worker", timeout)
    check(outs[n:], "single-process reference run", timeout)
    results = [_load(p) for p in paths]
    return (results, _load(ref_path)) if reference else results


def verify_multiprocess(n_processes: int = 2, local_devices: int = 1,
                        epochs: int = 2, timeout: float = 300.0,
                        atol: float = 1e-5, rtol: float = 0.0, *,
                        device: Optional[str] = None,
                        backend: Optional[str] = None,
                        config: str = "demo") -> dict:
    """The multi-process gate: ``n_processes * local_devices`` ranks train
    the payload data-parallel and one process trains it on the whole
    batch, at once (on the cards unless ``device`` says otherwise); every
    rank's parameters and per-epoch losses must equal the single
    process's within ``atol + rtol * |single|``, and the ranks each
    other's bit for bit. Returns a report."""
    import numpy as np

    results, ref = launch(n_processes, local_devices, epochs, None, timeout,
                          device=device, backend=backend, config=config,
                          reference=True)
    max_diff, worst = 0.0, 0.0
    for r in results:
        for key in ("flat", "accs"):
            d = np.abs(r[key] - ref[key])
            max_diff = max(max_diff, float(d.max()))
            worst = max(worst, float((d / (atol + rtol * np.abs(ref[key])))
                                     .max()))
    bitwise = all(np.array_equal(r["flat"], results[0]["flat"])
                  and np.array_equal(r["accs"], results[0]["accs"])
                  for r in results)
    if not worst <= 1.0:
        raise AssertionError(
            f"multi-process params/losses diverged from single-process: "
            f"max abs diff {max_diff:.3e} past atol {atol:.1e} + rtol "
            f"{rtol:.1e} x |single|")
    if not bitwise:
        raise AssertionError("the ranks' parameters differ from each other")
    return {
        "n_processes": n_processes,
        "local_devices": local_devices,
        "global_devices": n_processes * local_devices,
        "epochs": epochs,
        "max_abs_diff_vs_single_process": max_diff,
        "tol_ratio": worst,
        "ranks_bitwise_equal": bitwise,
        "accs": [round(float(a), 6) for a in ref["accs"]],
        "launches": [r["launches"] for r in results],
        "single_launches": ref["launches"],
        "ok": True,
    }


if __name__ == "__main__":
    worker_main()
