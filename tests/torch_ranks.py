"""Run a function of a test module (or of ``chip_smoke.py``) in ``n``
ranks of one world, each a process.

``run_ranks("path/file.py:function", n, kwargs)`` starts ``n`` copies of
this file, which join one world on 127.0.0.1 through
``sharding.init_distributed`` (gloo on the CPU by default; ``n`` = 1
joins none), call ``function(device=..., **kwargs)`` and save what it
returns with ``torch.save``; it returns those results in rank order.
Every rank is killed at one deadline, its output in the error
(``multiprocess.spawn``). Not a test file: pytest collects nothing here.

    python tests/torch_ranks.py FILE.py:FUNCTION --rank R --world N \\
        --port P --out OUT [--device cpu] [--backend gloo] [--kwargs JSON]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(call: str, n: int, kwargs=None, *, device: str = "cpu",
              backend=None, timeout: float = 240.0):
    """``call`` run by ``n`` ranks of one world on ``device``; what each
    returned, in rank order."""
    import torch

    from factorized_tpu_torch.parallel import multiprocess
    from factorized_tpu_torch.parallel.sharding import free_port

    out_dir = tempfile.mkdtemp(prefix="ftt_ranks_")
    paths = [os.path.join(out_dir, f"rank{i}.pt") for i in range(n)]
    port = free_port()
    commands = [[sys.executable, os.path.abspath(__file__), call,
                 "--rank", i, "--world", n, "--port", port, "--out",
                 paths[i], "--device", device,
                 *(["--backend", backend] if backend else []),
                 "--kwargs", json.dumps(kwargs or {})] for i in range(n)]
    multiprocess.check(multiprocess.spawn(commands, timeout, out_dir),
                       "rank", timeout)
    return [torch.load(p, weights_only=False) for p in paths]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("call", help="path/file.py:function")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--kwargs", default="{}")
    args = ap.parse_args(argv)
    sys.path.insert(0, _REPO)

    import torch
    import torch.distributed as dist

    from factorized_tpu_torch.parallel import sharding

    if args.device == "cpu" and args.world > 1:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    if args.world > 1:
        sharding.init_distributed(f"127.0.0.1:{args.port}", args.world,
                                  args.rank, device=args.device,
                                  backend=args.backend)
    where, name = args.call.rsplit(":", 1)
    spec = importlib.util.spec_from_file_location(
        "_rank_" + os.path.basename(where)[:-3], where)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    try:
        out = getattr(module, name)(device=args.device,
                                    **json.loads(args.kwargs))
        torch.save(out, args.out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
