"""Command line of the port: ``python -m factorized_tpu_torch serve``.

Only the ``serve`` subcommand is ported (``factorized_tpu/cli.py``'s
``run_serve``, from a checkpoint of this package).
"""

from __future__ import annotations

import argparse


def run_serve(args):
    from factorized_tpu_torch.serve import Predictor, serve_http

    predictor = Predictor.from_checkpoint(args.checkpoint, device=args.device)
    serve_http(predictor, args.host, args.port,
               micro_batch=not args.no_microbatch,
               max_wait_ms=args.max_wait_ms)
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="factorized_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("serve", help="JSON-over-HTTP inference endpoint")
    sp.add_argument("--checkpoint", required=True,
                    help="directory written by utils.checkpoint."
                         "save_checkpoint")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8787)
    sp.add_argument("--no-microbatch", action="store_true",
                    help="disable dynamic request coalescing (serialize "
                         "requests behind a device lock instead)")
    sp.add_argument("--max-wait-ms", type=float, default=3.0,
                    help="micro-batch window after the first queued "
                         "request")
    sp.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given "
                         "(e.g. --device cpu)")
    sp.set_defaults(func=run_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
