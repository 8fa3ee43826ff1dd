"""Matrix-product FLOPs of a train step (port of
``factorized_tpu/utils/flops.py``): the numerator of the step's share of
the card's peak.

Two counts, ``model_train_flops_per_step(cfg, model, composition,
fused)``:

- ``fused=False``, the model FLOPs: the products the reference's own
  per-modality layers do (``mfm_model.py:469-555`` and siblings), forward,
  backward and update, with no block-diagonal padding. The JAX package
  counts them by tracing its modular path; ``model_products`` lists them
  in closed form from ``cfg``, layer by layer, as that path computes
  them: each encoder LSTM's hoisted input product and t recurrent ones
  (the first on the zero state too), the MFN's per-step cells and four
  two-layer MLPs, the decoders' first step and t - 1 steps on ``W_x +
  W_h``, the hoisted output products, the MMD kernels (the batched
  ``_mmd4`` of four latents padded to the widest, or one ``loss_mmd`` a
  latent) and the z->f MLPs (one block-diagonal pair of products where
  the JAX model fuses them, ``_zf_all``). A forward product of ``m x k``
  by ``k x n`` costs ``2 m k n``, and its backward one more such product
  for each operand that needs a gradient (the data and the MMD's Gaussian
  sample do not; a decoder whose reconstruction no loss reads gets
  none). The same number as the JAX package's, to the FLOP; the port's
  own modular path (``models/mfm.py::FUSED`` = False) runs the same
  products, and counted by ``count_gemm_flops`` they equal these but for
  the gradient of each encoder LSTM's zero state at step 0, which
  autograd does not take (``tests/test_torch_flops.py``).
- ``fused=True``, the executed FLOPs of the port's own plain path (the
  fused or the modular one, as the gate picks at ``cfg``): one
  train step (``train.TrainProgram.step``) on the CPU, counted by
  ``count_gemm_flops``. It includes the block-diagonal zeros of the fused
  operands (``ops/fused.py``), the hoisted input projections as the
  port packs them and the backward of its ``autograd.Function``s as their
  plain versions compute it. It is not the JAX package's ``fused=True``
  count: the JAX fused path and the port pack their products differently,
  and the Pallas kernels' backward differs from the plain versions'. On
  the card the hand-written kernels do less than either (each chain
  multiplies only its cell's diagonal block).
"""

from __future__ import annotations

from typing import NamedTuple


class Product(NamedTuple):
    """One forward matrix product of the model: ``batch`` products of
    ``(m, k) x (k, n)``, and whether each operand needs a gradient."""

    layer: str
    batch: int
    m: int
    k: int
    n: int
    lhs_grad: bool
    rhs_grad: bool

    def train_flops(self) -> int:
        return (2 * self.batch * self.m * self.k * self.n
                * (1 + self.lhs_grad + self.rhs_grad))


def _p(layer, m, k, n, lhs=True, rhs=True, batch=1):
    return [Product(layer, batch, m, k, n, lhs, rhs)]


def _encoder(layer, d, h, t, n):
    """``encoder_apply``: the hoisted input product over the data, t
    recurrent products, ``fc1`` of the last state."""
    return (_p(f"{layer}.wx", t * n, d, 4 * h, lhs=False)
            + _p(f"{layer}.wh", n, h, 4 * h) * t + _p(f"{layer}.fc1", n, h, h))


def _mlp2(layer, n, a, b, c, grad=True):
    return (_p(f"{layer}.fc1", n, a, b, grad, grad)
            + _p(f"{layer}.fc2", n, b, c, grad, grad))


def _decoder(layer, hd, d, t, n, grad=True):
    """``decoder_apply``: step 0 on its input, t - 1 steps on ``W_x +
    W_h``, the hoisted output product."""
    return (_p(f"{layer}.wx", n, hd, 4 * hd, grad, grad)
            + _p(f"{layer}.wsum", n, hd, 4 * hd, grad, grad) * (t - 1)
            + _p(f"{layer}.fc1", t * n, hd, d, grad, grad))


def _mfn(cfg, t, n):
    """``mfn_apply``: three hoisted input products, then each step the
    three cells and the attention and gate MLPs."""
    att = 2 * sum(cfg.h_dims)
    gam = att + cfg.memsize
    out = [q for m, d, h in zip("lav", cfg.input_dims, cfg.h_dims)
           for q in _p(f"mfn.lstm_{m}.wx", t * n, d, 4 * h, lhs=False)]
    step = [q for m, h in zip("lav", cfg.h_dims)
            for q in _p(f"mfn.lstm_{m}.wh", n, h, 4 * h)]
    step += (_mlp2("mfn.att1", n, att, cfg.att1_shape, att)
             + _mlp2("mfn.att2", n, att, cfg.att2_shape, cfg.memsize)
             + _mlp2("mfn.gamma1", n, gam, cfg.gamma1_shape, cfg.memsize)
             + _mlp2("mfn.gamma2", n, gam, cfg.gamma2_shape, cfg.memsize))
    return out + step * t


def _mmd(layer, n, d):
    """``loss_mmd``: the kernels of (sample, sample), (z, z), (sample, z)."""
    return (_p(f"{layer}.rr", n, d, n, False, False)
            + _p(f"{layer}.zz", n, d, n) + _p(f"{layer}.rz", n, d, n, False))


def _mmd4(cfg, n):
    """``_mmd4``: the four latents padded to the widest, batched."""
    d = max(cfg.zl_size, cfg.za_size, cfg.zv_size, cfg.zy_size)
    return (_p("mmd4.rr", n, d, n, False, False, batch=4)
            + _p("mmd4.zz", n, d, n, batch=4)
            + _p("mmd4.rz", n, d, n, False, batch=4))


def _zs(cfg):
    return (cfg.zl_size, cfg.za_size, cfg.zv_size)


def _fs(cfg):
    return (cfg.fl_size, cfg.fa_size, cfg.fv_size)


def _trio(cfg, t, n):
    return [q for m, d, z in zip("lav", cfg.input_dims, _zs(cfg))
            for q in _encoder(f"enc.encoder_{m}", d, z, t, n)]


def _decode(cfg, t, n, grads=(True, True, True), tag=""):
    """``_zf_all`` (two block-diagonal products), the decoder trio on
    [fy, f_m] (``grads``: which reconstructions a loss reads) and the
    label head."""
    z_tot = sum(_zs(cfg)) + cfg.zy_size
    f_tot = cfg.fy_size + sum(_fs(cfg))
    out = (_p(f"zf{tag}.fc1", n, z_tot, f_tot)
           + _p(f"zf{tag}.fc2", n, f_tot, f_tot))
    for m, d, f, g in zip("lav", cfg.input_dims, _fs(cfg), grads):
        out += _decoder(f"dec{tag}.decoder_{m}", cfg.fy_size + f, d, t, n, g)
    return out + _mlp2(f"fy_to_y{tag}", n, cfg.fy_size, cfg.fy_size,
                       cfg.output_dim)


def _varhead(cfg, n):
    return [q for m, z in zip("lav", _zs(cfg))
            for name in (f"last_to_z{m}", f"last_to_logvarz{m}")
            for q in _p(f"varhead.{name}", n, z, z)]


def _mfm(cfg, t, n, decoders):
    return (_trio(cfg, t, n) + _mfn(cfg, t, n)
            + _p("mfn_enc.last_to_zy", n, cfg.last_mfn_size, cfg.zy_size)
            + _mmd4(cfg, n) + _decode(cfg, t, n, (decoders,) * 3))


def _kl(cfg, t, n, decoders):
    return (_trio(cfg, t, n) + _mfn(cfg, t, n) + _varhead(cfg, n)
            + _p("mfn_enc.last_to_zy", n, cfg.last_mfn_size, cfg.zy_size)
            + _p("last_to_logvarzy", n, cfg.last_mfn_size, cfg.zy_size)
            + _decode(cfg, t, n, (decoders,) * 3))


def _kl_ef(cfg, t, n, decoders):
    ef = sum(_zs(cfg))
    return (_trio(cfg, t, n)
            + _encoder("ef_encoder", sum(cfg.input_dims), ef, t, n)
            + _varhead(cfg, n) + _p("last_to_zy", n, ef, cfg.zy_size)
            + _p("last_to_logvarzy", n, ef, cfg.zy_size)
            + _decode(cfg, t, n, (decoders,) * 3))


def _pairs(cfg):
    d_l, d_a, d_v = cfg.input_dims
    return {"la": d_l + d_a, "lv": d_l + d_v, "av": d_a + d_v}


def _missing(cfg, t, n, decoders):
    zl, za, zv = _zs(cfg)
    pairs = _pairs(cfg)
    out = (_trio(cfg, t, n) + _mfn(cfg, t, n)
           + _p("mfn_enc.last_to_zy", n, cfg.last_mfn_size, cfg.zy_size))
    for name, pair, z in (("la_to_v", "la", zv), ("lv_to_a", "lv", za),
                          ("av_to_l", "av", zl), ("la_to_y", "la", cfg.zy_size),
                          ("lv_to_y", "lv", cfg.zy_size),
                          ("av_to_y", "av", cfg.zy_size)):
        out += _encoder(f"encoder_{name}", pairs[pair], z, t, n)
    out += _mmd4(cfg, n)
    # the reconstructions the composite loss reads (train.py:129-137):
    # all three of the full decode, x_l of "nol", x_a and x_v of "noa"
    # (the reference's x_v_hat_NOA), none of "nov"
    for tag, grads in (("", (True,) * 3), ("_nol", (True, False, False)),
                       ("_noa", (False, True, True)), ("_nov", (False,) * 3)):
        out += _decode(cfg, t, n, grads, tag)
    return out


def _m_a(cfg, t, n, decoders):
    drive = cfg.fy_size + cfg.fl_size
    out = (_encoder("encoder_l", sum(cfg.input_dims), cfg.zl_size, t, n)
           + _mfn(cfg, t, n)
           + _p("mfn_enc.last_to_zy", n, cfg.last_mfn_size, cfg.zy_size)
           + _mmd("mmd_l", n, cfg.zl_size) + _mmd("mmd_y", n, cfg.zy_size)
           + _mlp2("zy_to_fy", n, cfg.zy_size, cfg.fy_size, cfg.fy_size)
           + _mlp2("zl_to_fl", n, cfg.zl_size, cfg.fl_size, cfg.fl_size))
    for m, d in zip("lav", cfg.input_dims):
        out += _decoder(f"decoder_{m}", drive, d, t, n, decoders)
    return out + _mlp2("fy_to_y", n, cfg.fy_size, cfg.fy_size, cfg.output_dim)


def _m_b(cfg, t, n, decoders):
    out = _trio(cfg, t, n)
    for m, d, z, f in zip("lav", cfg.input_dims, _zs(cfg), _fs(cfg)):
        out += (_mmd(f"mmd_{m}", n, z) + _mlp2(f"z{m}_to_f{m}", n, z, f, f)
                + _decoder(f"decoder_{m}", f, d, t, n, decoders))
    return out + _mlp2("fy_to_y", n, sum(_fs(cfg)), cfg.fy_size,
                       cfg.output_dim)


def _m_c(cfg, t, n, decoders):
    out = (_mfn(cfg, t, n)
           + _p("mfn_enc.last_to_zy", n, cfg.last_mfn_size, cfg.zy_size)
           + _mmd("mmd_y", n, cfg.zy_size)
           + _mlp2("zy_to_fy", n, cfg.zy_size, cfg.fy_size, cfg.fy_size))
    for m, d in zip("lav", cfg.input_dims):
        out += _decoder(f"decoder_{m}", cfg.fy_size, d, t, n, decoders)
    return out + _mlp2("fy_to_y", n, cfg.fy_size, cfg.fy_size, cfg.output_dim)


def _m_d(cfg, t, n, decoders):
    out = _trio(cfg, t, n)
    for m, z, f in zip("lav", _zs(cfg), _fs(cfg)):
        out += _mlp2(f"z{m}_to_f{m}", n, z, f, f)
    return out + _p("fs_to_y", n, sum(_fs(cfg)), cfg.output_dim)


def _s2s(cfg, t, n, decoders):
    zl, za, zv = _zs(cfg)
    pairs = _pairs(cfg)
    out = []
    for name, pair, z in (("la_to_v", "la", zv), ("lv_to_a", "lv", za),
                          ("av_to_l", "av", zl)):
        out += (_encoder(f"encoder_{name}", pairs[pair], z, t, n)
                + _mmd(f"mmd_{name}", n, z))
    for m, d, z, f in zip("lav", cfg.input_dims, _zs(cfg), _fs(cfg)):
        out += (_mlp2(f"z{m}_to_f{m}", n, z, f, f)
                + _decoder(f"decoder_{m}", f, d, t, n))
    return out


def _bm(cfg, t, n, decoders):
    out = []
    for pair, miss in (("la", "v"), ("lv", "a"), ("av", "l")):
        out += (_encoder(f"encoder_{pair}_to_y", _pairs(cfg)[pair],
                         cfg.zy_size, t, n)
                + _mmd(f"mmd_no{miss}", n, cfg.zy_size)
                + _mlp2(f"zy_no{miss}_to_y", n, cfg.zy_size, cfg.fy_size,
                        cfg.output_dim))
    return out


# model type -> (its products, the compositions its step may take)
_MODELS = {"mfm": (_mfm, ("joint", "beta_vae")),
           "kl": (_kl, ("joint", "beta_vae")),
           "kl_ef": (_kl_ef, ("joint", "beta_vae")),
           "missing": (_missing, ("missing",)),
           "m_a": (_m_a, ("joint", "beta_vae")),
           "m_b": (_m_b, ("joint", "beta_vae")),
           "m_c": (_m_c, ("joint", "beta_vae")),
           "m_d": (_m_d, ("joint", "beta_vae")),
           "s2s": (_s2s, ("s2s",)),
           "bm": (_bm, ("bm",))}


def model_products(cfg, model: str = "mfm", composition: str = "joint"):
    """The forward matrix products of one train step of ``model`` at
    ``cfg`` (batch ``cfg.batchsize``, t ``cfg.seqlength``) as the
    reference's per-modality layers compute them, each a ``Product``.
    ``composition`` is the step's loss (``train.make_loss_fn``); under
    ``beta_vae`` (stage 0 as the JAX package's counter traces it: the
    label and regularisation terms) no loss reads the reconstructions."""
    if model not in _MODELS:
        raise ValueError(f"no model FLOPs for model type {model!r}; known: "
                         f"{sorted(_MODELS)}")
    products, compositions = _MODELS[model]
    if composition not in compositions:
        raise ValueError(f"model type {model!r} trains under "
                         f"{'/'.join(compositions)}, not {composition!r}")
    return products(cfg, cfg.seqlength, cfg.batchsize,
                    composition != "beta_vae")


def count_gemm_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of the matrix products ``fn(*args, **kwargs)`` runs,
    forward and any backward it calls (``torch.utils.flop_counter.
    FlopCounterMode``: ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    convolutions and attention, 2 m k n a product). Only what runs
    counts: a branch not taken counts nothing, a loop its iterations."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _executed_step_flops(cfg, model, composition) -> float:
    import torch

    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.train import TrainProgram, make_optimizer

    init, apply_fn = get_model(model)
    params = init(torch.Generator().manual_seed(0), cfg)
    opt = make_optimizer(params, 1e-3)
    program = TrainProgram(apply_fn, cfg, composition)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((cfg.seqlength, cfg.batchsize, cfg.d_total),
                    generator=gen)
    y = (torch.zeros(cfg.batchsize, dtype=torch.int64)
         if cfg.task == "classification" else torch.zeros(cfg.batchsize))
    return count_gemm_flops(program.step, params, opt, x, y, gen)


def model_train_flops_per_step(cfg, model: str = "mfm",
                               composition: str = "joint",
                               fused: bool = False) -> float:
    """Matrix-product FLOPs of one train step (forward, backward, update)
    of ``model`` at ``cfg``: with ``fused=False`` the model FLOPs
    (``model_products``, the JAX package's number), with ``fused=True``
    the port's plain path as it executes them (one step on the CPU)."""
    if fused:
        return _executed_step_flops(cfg, model, composition)
    return float(sum(p.train_flops()
                     for p in model_products(cfg, model, composition)))
