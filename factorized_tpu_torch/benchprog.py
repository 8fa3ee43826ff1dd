"""The bench programs, built as the JAX package builds them (port of
``factorized_tpu/benchprog.py``).

``warmup``'s bench legs and ``perf_probe.py scale`` build their programs
here, at the JAX package's pinned shapes:

- the MOSI workload: ``best_acc_mosi_config``, batch ``BATCH`` = 32,
  t = ``T`` = 20, ``NB`` = 39 full batches an epoch (1,248 shuffled train
  segments), chunks of ``E`` = 20 epochs;
- the compute-bound ``scale_cfg``: MOSEI-like input dims (300 / 74 / 35),
  batch 2,048, cells of 512 / 256 / 256, MLP sites 1,024 wide, every
  dropout 0; ``SCALE_NB`` = 4 batches an epoch, ``SCALE_E`` = 3 epochs a
  chunk. ``scale_candidates`` are the scale probe's configs A to E
  (``scripts/scale_mfu_probe.py``), of which D is ``scale_cfg``.

``epoch_inputs`` draws the same numbers as the JAX package's (one
``np.random.default_rng(seed)``), so ``Xb`` and ``yb`` equal its bit for
bit. ``active_paths`` attests, from ``cfg`` alone and before any launch,
which path a train step takes (``models/mfm.py::fused_active``) and, on
the fused path, the plan of each chain kernel (a thread-block cluster, 0
for the weights read from L2, or ``cuda_lstm.SCRATCH``).
"""

from __future__ import annotations

import numpy as np
import torch

BATCH = 32
T = 20
NB = 39  # MOSI: 1248 shuffled train samples / batch 32
E = 20
SCALE_NB = 4  # batches an epoch of the scale chunk
SCALE_E = 3   # epochs a scale chunk


def build_cfg():
    from factorized_tpu_torch.config import best_acc_mosi_config

    return best_acc_mosi_config()


_NO_DROP = dict(zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0,
                za_to_fa_dropout=0.0, zv_to_fv_dropout=0.0,
                fy_to_y_dropout=0.0, att1_drop=0.0, att2_drop=0.0,
                gamma1_drop=0.0, gamma2_drop=0.0, out_drop=0.0)


def _widths(batch, cells, mlp):
    """A candidate's widths: batch, the MFN cells (the z and f sizes
    follow them), memory, and the four MLP sites."""
    h_l, h_a, h_v = cells
    return dict(input_dims=[300, 74, 35], batchsize=batch, h_dims=list(cells),
                zy_size=h_l, zl_size=h_l, za_size=h_a, zv_size=h_v,
                fy_size=h_l, fl_size=h_l, fa_size=h_a, fv_size=h_v,
                memsize=h_l, att1_shape=mlp, att2_shape=mlp,
                gamma1_shape=mlp, gamma2_shape=mlp)


def scale_candidates():
    """The scale probe's configs A to E by name; value fields (dropouts,
    loss weights) stay at ``best_acc_mosi_config``'s, but D's and E's
    dropouts are 0."""
    from factorized_tpu_torch.config import best_acc_mosi_config

    cands = {
        "A_b256_h256": _widths(256, (128, 64, 64), 256),
        "B_b512_h512": _widths(512, (256, 128, 128), 512),
        "C_b1024_h1024": _widths(1024, (512, 256, 256), 1024),
        "D_b2048_h1024_nodrop": dict(_widths(2048, (512, 256, 256), 1024),
                                     **_NO_DROP),
        "E_b4096_h1024_nodrop": dict(_widths(4096, (512, 256, 256), 1024),
                                     **_NO_DROP),
    }
    return {k: best_acc_mosi_config(**v) for k, v in cands.items()}


def scale_cfg():
    """The compute-bound config (the JAX package's ``scale_cfg``)."""
    from factorized_tpu_torch.config import best_acc_mosi_config

    return best_acc_mosi_config(**_widths(2048, (512, 256, 256), 1024),
                                **_NO_DROP)


def build_train_state(cfg, seed: int = 123, device=None):
    """(program, params, optimizer): the ``mfm`` train program under the
    joint loss, parameters initialised from ``torch.Generator`` seed
    ``seed`` on ``device`` (default the card), and ``FlatAdam`` at
    1e-3."""
    from factorized_tpu_torch.models.mfm import MFM, mfm_apply
    from factorized_tpu_torch.train import TrainProgram, make_optimizer

    params = MFM(cfg, seed=seed, device=device).tree()
    return (TrainProgram(mfm_apply, cfg, "joint"), params,
            make_optimizer(params, 1e-3))


def epoch_inputs(cfg, nb: int = NB, batch: int = BATCH, t: int = T,
                 seed: int = 0, device=None):
    """(Xb (nb, t, batch, d_total), yb (nb, batch)) float32 on ``device``
    (default the card), the JAX package's draws."""
    from factorized_tpu_torch import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Xb = rng.normal(size=(nb, t, batch, cfg.d_total)).astype(np.float32)
    yb = rng.normal(size=(nb, batch)).astype(np.float32)
    return torch.from_numpy(Xb).to(dev), torch.from_numpy(yb).to(dev)


def active_paths(cfg, train: bool = True):
    """Which path a step of ``mfm`` at ``cfg`` takes, from ``cfg`` alone:
    ``fused_blockdiag`` (``fused_active``) and, on the fused path, each
    kernel's chain plans as its wrapper records them in ``CLUSTERS``
    (``mfm_encode_fwd``: LSTM chains, memory chain; ``mfm_encode_bwd``:
    memory chain, LSTM chains; the decoder recurrence's), from the
    launchers' arithmetic (``cuda_mfn.encode_plans``,
    ``cuda_lstm.decoder_plans``); None for each on the modular path, which
    launches none of them. ``train=False``: the eval forward's."""
    from factorized_tpu_torch.models.mfm import fused_active
    from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

    names = ["mfm_encode_fwd", "decoder_lstm_fwd"]
    if train:
        names += ["mfm_encode_bwd", "decoder_lstm_bwd"]
    if not fused_active(cfg):
        return {"fused_blockdiag": False, **dict.fromkeys(names)}
    h_dims = [cfg.zl_size, cfg.za_size, cfg.zv_size, *cfg.h_dims]
    dec = [cfg.fy_size + f for f in (cfg.fl_size, cfg.fa_size, cfg.fv_size)]
    plans = {**cuda_mfn.encode_plans(h_dims, cfg.gamma1_shape,
                                     cfg.gamma2_shape, cfg.memsize, train),
             **cuda_lstm.decoder_plans(dec)}
    return {"fused_blockdiag": True, **{k: plans[k] for k in names}}


class Chunk:
    """``make_chunk``'s closure: ``chunk(params, optimizer, Xb, yb,
    generator, lr=None)`` trains e epochs over one ``(Xb, yb)`` in place,
    each epoch's draws fresh from ``generator``, and returns the e epochs'
    mean tracked losses, an (e,) tensor. On the card one epoch is one CUDA
    graph (``train.Graphed``, one per set of arguments): the first epoch
    of a set runs eagerly, the second captures the graph and replays it,
    every later epoch is a replay. ``graphs`` holds them (``capture_ms``,
    ``pool_bytes``)."""

    def __init__(self, program, e: int):
        self.program = program
        self.e = e
        self.graphs = {}

    def __call__(self, params, optimizer, Xb, yb, generator, lr=None):
        if lr is not None:
            optimizer.set_lr(lr)
        if Xb.device.type != "cuda":
            return torch.stack([
                self.program.epoch(params, optimizer, Xb, yb, generator)
                for _ in range(self.e)])
        from factorized_tpu_torch.train import Graphed

        key = (id(params), id(optimizer), Xb.data_ptr(), yb.data_ptr(),
               id(generator))
        if key not in self.graphs:
            out = torch.zeros((), dtype=torch.float32, device=Xb.device)

            def epoch():
                out.copy_(self.program.epoch(params, optimizer, Xb, yb,
                                             generator))

            self.graphs[key] = (Graphed(epoch, (generator,)), out)
        graph, out = self.graphs[key]
        trs = []
        for _ in range(self.e):
            graph()
            trs.append(out.clone())
        return torch.stack(trs)


def make_chunk(program, e: int = E) -> Chunk:
    """The bench's e-epoch chunk over ``program`` (a ``TrainProgram``):
    the pure-train analogue of the chunked loop's program, as the JAX
    package's ``make_chunk``; see ``Chunk``."""
    return Chunk(program, e)
