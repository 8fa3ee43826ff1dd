"""Which residual layout and which reverse kernel the encode's training
pass should use: the port of ``scripts/bwd_residual_probe.py``, on the
port's kernels.

Variants, each the same function (the stored residuals are the values a
recompute would give):

- ``plain``: the plain PyTorch forward under autograd, the counterpart of
  the JAX probe's ``scan_encode``;
- B (``B_store_noatt``): the ten residuals as separate tensors, att
  recomputed on the backward's chain from r1
  (``cuda_mfn.make_variant(False)``);
- C (``C_store_att``): the ten residuals as separate tensors, att loaded
  (``cuda_mfn.make_variant(True)``);
- D (``D_streamed``): one residual buffer and the training path's
  backward (``cuda_mfn.make_variant_d()``).

For each, the gradient of ``sum(h**2) + sum(mem**2)`` with respect to xp
and the 15 weights, its largest abs difference from the plain variant's,
and its ms per evaluation; then the forward alone, plain and kernel. Times
are the best of ``--groups`` groups of ``--iters`` chained evaluations
(each one's input nudged by the last one's gradient, as in the JAX probe),
by CUDA events on the card and by the host clock on the CPU. The JAX
probe took a slope between two chain lengths to cancel a TPU's
per-program dispatch cost; CUDA events need no such trick.

Run from the repository root: ``python -m
factorized_tpu_torch.probes.bwd_residual_probe`` on the card,
``--device cpu`` on the CPU. Float32, TF32 off. It ends with one JSON
line: the JAX probe's keys in ms per evaluation (``scan`` renamed
``plain`` and ``pallas_fwd_only`` renamed ``kernel_fwd_only``),
``max_grad_diff`` per variant, and the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.config import best_acc_mosi_config
from factorized_tpu_torch.ops import cuda_mfn
from factorized_tpu_torch.ops.fused import gate_major_blockdiag

DROP = 0.3
VARIANTS = {"B_store_noatt": lambda: cuda_mfn.make_variant(False),
            "C_store_att": lambda: cuda_mfn.make_variant(True),
            "D_streamed": cuda_mfn.make_variant_d}


def build_inputs(cfg=None, *, device="cpu", masks=None, mask_seed=0):
    """``(xp, masks, weights, z_tot, h_dims)`` at ``cfg`` (default
    ``best_acc_mosi_config``; t = seqlength, n = batchsize) on ``device``.

    Weights and xp are drawn from ``np.random.default_rng(0)`` in the
    order and scale (normal * 0.1) of the JAX probe's ``build_inputs``.
    ``wh`` is then cut to the gate-major block diagonal of the six fused
    cells (the three encoders, then the MFN's): that is the only
    recurrent weight the model packs and the kernels read, where the JAX
    probe's dense ``wh`` couples the cells. ``masks`` are handed in, or
    drawn at rate 0.3 on every site by ``cuda_mfn.make_dropout_masks``
    from a ``torch.Generator`` on ``device`` seeded ``mask_seed``."""
    cfg = cfg or best_acc_mosi_config()
    t, n = cfg.seqlength, cfg.batchsize
    h_dims = [cfg.zl_size, cfg.za_size, cfg.zv_size, *cfg.h_dims]
    z_tot = sum(h_dims[:3])
    H = sum(h_dims)
    m2 = 2 * sum(cfg.h_dims)
    rng = np.random.default_rng(0)

    def rnd(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    s12 = cfg.gamma1_shape + cfg.gamma2_shape
    weights = {
        "wh": rnd(H, 4 * H),
        "a1w1": rnd(m2, cfg.att1_shape), "a1b1": rnd(1, cfg.att1_shape),
        "a1w2": rnd(cfg.att1_shape, m2), "a1b2": rnd(1, m2),
        "a2w1": rnd(m2, cfg.att2_shape), "a2b1": rnd(1, cfg.att2_shape),
        "a2w2": rnd(cfg.att2_shape, cfg.memsize),
        "a2b2": rnd(1, cfg.memsize),
        "gw1": rnd(m2 + cfg.memsize, s12), "gb1": rnd(1, s12),
        "g1w2": rnd(cfg.gamma1_shape, cfg.memsize),
        "g1b2": rnd(1, cfg.memsize),
        "g2w2": rnd(cfg.gamma2_shape, cfg.memsize),
        "g2b2": rnd(1, cfg.memsize),
    }
    xp = rnd(t, n, 4 * H)
    blocks = gate_major_blockdiag(
        [torch.ones(h, 4 * h) for h in h_dims], h_dims).numpy()
    weights["wh"] = np.where(blocks > 0, weights["wh"], np.float32(0.0))
    dev = torch.device(device)
    weights = {k: torch.from_numpy(v).to(dev) for k, v in weights.items()}
    if masks is None:
        sizes = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
                 cfg.gamma2_shape)
        masks = cuda_mfn.make_dropout_masks(
            torch.Generator(device=dev).manual_seed(mask_seed), t, n, sizes,
            (DROP,) * 4)
    return torch.from_numpy(xp).to(dev), masks.to(dev), weights, z_tot, h_dims


def plain_encode(xp, masks, weights, z_tot, h_dims):
    """The plain forward, differentiated by autograd (the JAX probe's
    ``scan_encode``)."""
    del h_dims
    return cuda_mfn.mfm_encode_plain(xp, weights, z_tot, masks)


def kernel_encode(xp, masks, weights, z_tot, h_dims):
    """The forward kernel alone, no residuals written."""
    return cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims, masks)


def loss_grads(encode, xp, masks, weights, z_tot, h_dims):
    """``(dxp, {name: dw})`` of ``sum(h**2) + sum(mem**2)``."""
    xp = xp.detach().requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in weights.items()}
    h, mem = encode(xp, masks, w, z_tot, h_dims)
    grads = torch.autograd.grad((h * h).sum() + (mem * mem).sum(),
                                [xp, *w.values()])
    return grads[0], dict(zip(w, grads[1:]))


def max_diff(a, b):
    """Largest abs difference between two ``(dxp, {name: dw})``."""
    return max([float((a[0] - b[0]).abs().max())]
               + [float((a[1][k] - b[1][k]).abs().max()) for k in a[1]])


def chain_ms(step, xp, weights, iters, groups):
    """Best over ``groups`` of the mean ms of ``iters`` chained calls of
    ``step(xp, weights) -> (xp, weights)``, after one warm-up chain."""

    def run():
        x, w = xp, weights
        for _ in range(iters):
            x, w = step(x, w)
        return x

    run()
    best = float("inf")
    for _ in range(groups):
        if xp.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            run()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


def grad_step(encode, masks, z_tot, h_dims):
    def step(xp, weights):
        dxp, dw = loss_grads(encode, xp, masks, weights, z_tot, h_dims)
        return xp + 1e-12 * dxp, {k: v + 1e-12 * dw[k]
                                  for k, v in weights.items()}
    return step


def fwd_step(encode, masks, z_tot, h_dims):
    def step(xp, weights):
        with torch.no_grad():
            h, mem = encode(xp, masks, weights, z_tot, h_dims)
            return xp + 1e-12 * ((h * h).sum() + (mem * mem).sum()), weights
    return step


def main(argv=None, cfg=None):
    """Runs the probe at ``cfg`` (default ``best_acc_mosi_config``),
    prints its JSON line and returns the results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--iters", type=int, default=10,
                    help="chained evaluations per timed group")
    ap.add_argument("--groups", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    xp, masks, weights, z_tot, h_dims = build_inputs(cfg, device=dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {kind}", file=sys.stderr)

    results = {"device": kind, "t": xp.shape[0], "n": xp.shape[1],
               "unit": "ms per evaluation", "max_grad_diff": {}}
    ref = loss_grads(plain_encode, xp, masks, weights, z_tot, h_dims)
    results["plain_fwd_bwd"] = chain_ms(
        grad_step(plain_encode, masks, z_tot, h_dims), xp, weights,
        args.iters, args.groups)
    for name, make in VARIANTS.items():
        encode = make()
        diff = max_diff(loss_grads(encode, xp, masks, weights, z_tot,
                                   h_dims), ref)
        results["max_grad_diff"][name] = diff
        results[name] = chain_ms(grad_step(encode, masks, z_tot, h_dims),
                                 xp, weights, args.iters, args.groups)
        print(f"{name}: {results[name]:.4f} ms/eval, max |grad diff| vs "
              f"plain {diff:.3e}", file=sys.stderr)
    for name, encode in (("plain_fwd_only", plain_encode),
                         ("kernel_fwd_only", kernel_encode)):
        results[name] = chain_ms(fwd_step(encode, masks, z_tot, h_dims),
                                 xp, weights, args.iters, args.groups)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
