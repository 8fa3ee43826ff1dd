"""The ablation models M_A..M_D (port of
``factorized_tpu/models/ablations.py``), eval and train forward.

- ``m_a``: one joint encoder over the concatenated modalities gives zl,
  the MFN gives zy; all three decoders are driven by [fy, fl]; MMD on zl
  and zy.
- ``m_b``: per-modality encoders and decoders only, no MFN; the label
  head reads [fl, fa, fv]; MMD on zl, za and zv.
- ``m_c``: the MFN gives zy alone; the decoders are all driven by fy;
  MMD on zy.
- ``m_d``: discriminative only: per-modality encoders, the f's, a linear
  label head; the "reconstructions" are the inputs and the regulariser
  is 0.0.

Each returns ``(decoded, reg, 0.0)`` with ``decoded = [x_l_hat, x_a_hat,
x_v_hat, y_hat]``, as the JAX package's. The recurrences run through
the fused kernels (their plain versions on the CPU): ``m_a``'s joint
encoder and the MFN as one encode (``fused_mfm_encode`` with one encoder
cell over the whole input), ``m_c``'s MFN as the encode with no encoder
cell (``run_mfn``), the encoder trios of ``m_b`` and ``m_d`` as one
``multi_lstm`` (``fused_lstm_scan``) and each decoder trio as one
``decoder_lstm`` (``fused_decoder_scan``).

Every random draw of a train forward has an injection point, in the
order of the JAX package's ``subkeys``: ``encode_masks`` (the MFN's
dropout masks, see ``cuda_mfn.make_dropout_masks``), ``mmd_noise`` (one
Gaussian sample per latent, each shaped like it), ``zf_masks`` (one
scaled keep-mask or None per z->f site, in the order the apply reads
them) and ``y_mask`` (the label head's); what is not handed in is drawn
from the ``torch.Generator``. In eval mode only the MMD samples are
drawn.
"""

from __future__ import annotations

import torch

from factorized_tpu_torch.models.common import (encoder_latents, injected,
                                                mfn_drops, mfn_encoder_init,
                                                mmd_sum, run_mfn,
                                                split_modalities,
                                                trio_decoders,
                                                trio_encoder_init, yhead_apply,
                                                yhead_init, zf_apply,
                                                zf_init)
from factorized_tpu_torch.ops.core import (linear_apply, linear_init,
                                           mlp2_init)
from factorized_tpu_torch.ops.fused import (decoder_operands,
                                            encode_operands,
                                            fused_mfm_encode, lstm_operands)
from factorized_tpu_torch.ops.lstm import decoder_init, encoder_init

_ENCODERS = ("encoder_l", "encoder_a", "encoder_v")
_DECODERS = ("decoder_l", "decoder_a", "decoder_v")


def _trio_latents(params, x, cfg):
    """zl, za, zv of the three unimodal encoders, one fused recurrence."""
    return encoder_latents(params["enc"], _ENCODERS,
                           split_modalities(x, cfg.input_dims))


def _trio_fs(params, zs, cfg, train, generator, masks):
    """fl, fa, fv of the three z->f maps."""
    names = ("zl_to_fl", "za_to_fa", "zv_to_fv")
    rates = (cfg.zl_to_fl_dropout, cfg.za_to_fa_dropout,
             cfg.zv_to_fv_dropout)
    return [zf_apply(params[k], z, r, train, generator, m)
            for k, z, r, m in zip(names, zs, rates, masks)]


# -------------------------------------------------------------------- M_A

def m_a_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``m_a_init``."""
    d_l, d_a, d_v = cfg.input_dims
    drive = cfg.fy_size + cfg.fl_size
    return {
        "encoder_l": encoder_init(generator, cfg.d_total, cfg.zl_size),
        "decoder_l": decoder_init(generator, drive, d_l),
        "decoder_a": decoder_init(generator, drive, d_a),
        "decoder_v": decoder_init(generator, drive, d_v),
        "mfn_enc": mfn_encoder_init(generator, cfg),
        "zy_to_fy": zf_init(generator, cfg.zy_size, cfg.fy_size),
        "zl_to_fl": zf_init(generator, cfg.zl_size, cfg.fl_size),
        "fy_to_y": yhead_init(generator, cfg.fy_size, cfg.output_dim),
    }


def m_a_apply(params, x, cfg, *, generator=None, train=False,
              encode_masks=None, mmd_noise=None, zf_masks=None, y_mask=None):
    """x (t, n, d_total) time-major -> (decoded, mmd, 0.0). The draws:
    ``encode_masks``, ``mmd_noise`` (zl's and zy's), ``zf_masks`` (fy's
    and fl's) and ``y_mask``. The joint encoder is the encode's one
    encoder cell, over the whole input."""
    t = x.shape[0]
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    (h_l,), mfn_last = fused_mfm_encode(
        [params["encoder_l"]["lstm"]], params["mfn_enc"]["mfn"], x_l, x_a,
        x_v, mem_dim=cfg.memsize, drops=mfn_drops(cfg), train=train,
        generator=generator, masks=encode_masks, enc_xs=(x,))
    zl = linear_apply(params["encoder_l"]["fc1"], h_l)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    mmd = mmd_sum((zl, zy), injected(mmd_noise, 2), generator)
    m_fy, m_fl = injected(zf_masks, 2)
    fy = zf_apply(params["zy_to_fy"], zy, cfg.zy_to_fy_dropout, train,
                  generator, m_fy)
    fl = zf_apply(params["zl_to_fl"], zl, cfg.zl_to_fl_dropout, train,
                  generator, m_fl)
    fyfl = torch.cat([fy, fl], dim=1)
    x_hats = trio_decoders(params, [fyfl] * 3, t)
    y_hat = yhead_apply(params["fy_to_y"], fy, cfg.fy_to_y_dropout, train,
                        generator, y_mask)
    return [*x_hats, y_hat], mmd, 0.0


# -------------------------------------------------------------------- M_B

def m_b_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``m_b_init``."""
    d_l, d_a, d_v = cfg.input_dims
    return {
        "enc": trio_encoder_init(generator, cfg),
        "decoder_l": decoder_init(generator, cfg.fl_size, d_l),
        "decoder_a": decoder_init(generator, cfg.fa_size, d_a),
        "decoder_v": decoder_init(generator, cfg.fv_size, d_v),
        "zl_to_fl": zf_init(generator, cfg.zl_size, cfg.fl_size),
        "za_to_fa": zf_init(generator, cfg.za_size, cfg.fa_size),
        "zv_to_fv": zf_init(generator, cfg.zv_size, cfg.fv_size),
        # the label head reads [fl, fa, fv]
        "fy_to_y": mlp2_init(generator,
                             cfg.fl_size + cfg.fa_size + cfg.fv_size,
                             cfg.fy_size, cfg.output_dim),
    }


def m_b_apply(params, x, cfg, *, generator=None, train=False,
              mmd_noise=None, zf_masks=None, y_mask=None):
    """x (t, n, d_total) time-major -> (decoded, mmd, 0.0). The draws:
    ``mmd_noise`` (zl's, za's and zv's), ``zf_masks`` (fl's, fa's and
    fv's) and ``y_mask``."""
    t = x.shape[0]
    zs = _trio_latents(params, x, cfg)
    mmd = mmd_sum(zs, injected(mmd_noise, 3), generator)
    fs = _trio_fs(params, zs, cfg, train, generator, injected(zf_masks, 3))
    x_hats = trio_decoders(params, fs, t)
    y_hat = yhead_apply(params["fy_to_y"], torch.cat(fs, dim=1),
                        cfg.fy_to_y_dropout, train, generator, y_mask)
    return [*x_hats, y_hat], mmd, 0.0


# -------------------------------------------------------------------- M_C

def m_c_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``m_c_init``."""
    d_l, d_a, d_v = cfg.input_dims
    return {
        "decoder_l": decoder_init(generator, cfg.fy_size, d_l),
        "decoder_a": decoder_init(generator, cfg.fy_size, d_a),
        "decoder_v": decoder_init(generator, cfg.fy_size, d_v),
        "mfn_enc": mfn_encoder_init(generator, cfg),
        "zy_to_fy": zf_init(generator, cfg.zy_size, cfg.fy_size),
        "fy_to_y": yhead_init(generator, cfg.fy_size, cfg.output_dim),
    }


def m_c_apply(params, x, cfg, *, generator=None, train=False,
              encode_masks=None, mmd_noise=None, zf_masks=None, y_mask=None):
    """x (t, n, d_total) time-major -> (decoded, mmd, 0.0). The draws:
    ``encode_masks``, ``mmd_noise`` (zy's), ``zf_masks`` (fy's) and
    ``y_mask``. The MFN is the encode with no encoder cell."""
    t = x.shape[0]
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    mfn_last = run_mfn(params["mfn_enc"], x_l, x_a, x_v, cfg, train,
                       generator, encode_masks)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    mmd = mmd_sum((zy,), injected(mmd_noise, 1), generator)
    (m_fy,) = injected(zf_masks, 1)
    fy = zf_apply(params["zy_to_fy"], zy, cfg.zy_to_fy_dropout, train,
                  generator, m_fy)
    x_hats = trio_decoders(params, [fy] * 3, t)
    y_hat = yhead_apply(params["fy_to_y"], fy, cfg.fy_to_y_dropout, train,
                        generator, y_mask)
    return [*x_hats, y_hat], mmd, 0.0


# -------------------------------------------------------------------- M_D

def m_d_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``m_d_init``."""
    return {
        "enc": trio_encoder_init(generator, cfg),
        "zl_to_fl": zf_init(generator, cfg.zl_size, cfg.fl_size),
        "za_to_fa": zf_init(generator, cfg.za_size, cfg.fa_size),
        "zv_to_fv": zf_init(generator, cfg.zv_size, cfg.fv_size),
        "fs_to_y": linear_init(generator,
                               cfg.fl_size + cfg.fa_size + cfg.fv_size,
                               cfg.output_dim),
    }


def m_d_apply(params, x, cfg, *, generator=None, train=False,
              zf_masks=None):
    """x (t, n, d_total) time-major -> ([x_l, x_a, x_v, y_hat], 0.0,
    0.0): the inputs stand as their reconstructions. The draws:
    ``zf_masks`` (fl's, fa's and fv's)."""
    zs = _trio_latents(params, x, cfg)
    fs = _trio_fs(params, zs, cfg, train, generator, injected(zf_masks, 3))
    y_hat = linear_apply(params["fs_to_y"], torch.cat(fs, dim=1))
    return [*split_modalities(x, cfg.input_dims), y_hat], 0.0, 0.0


# ------------------------------------------------- the kernels' operands

def kernel_operands(params, x, cfg, model_type: str):
    """What the eval forward of an ablation hands its kernels for ``x``:
    ``{"encode": (xp, weights, z_tot, h_dims)}`` (``m_a``, ``m_c``; as
    ``cuda_mfn.mfm_encode`` takes them) or ``{"multi_lstm": (xp, wh,
    h_dims)}`` (``m_b``, ``m_d``; as ``cuda_lstm.multi_lstm_fwd``), and
    but for ``m_d`` ``"decoder": (h0, c0, wsum, b, dec_dims)`` (as
    ``cuda_lstm.decoder_lstm_fwd``). For holding the kernels against their
    plain versions, and timing them, at the inputs the main path gives
    them."""
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    out = {}
    if model_type in ("m_a", "m_c"):
        joint = model_type == "m_a"
        out["encode"] = encode_operands(
            [params["encoder_l"]["lstm"]] if joint else [],
            params["mfn_enc"]["mfn"], x_l, x_a, x_v, (x,) if joint else ())
    else:
        enc = params["enc"]
        out["multi_lstm"] = lstm_operands([enc[k]["lstm"] for k in _ENCODERS],
                                          [x_l, x_a, x_v])
    if model_type != "m_d":
        drives = _drives(params, x, cfg, model_type)
        out["decoder"] = decoder_operands([params[k] for k in _DECODERS],
                                          drives)
    return out


def _drives(params, x, cfg, model_type):
    """The eval forward's latents that drive the three decoders."""
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    if model_type == "m_b":
        zs = _trio_latents(params, x, cfg)
        return _trio_fs(params, zs, cfg, False, None, [None] * 3)
    if model_type == "m_a":
        (h_l,), mfn_last = fused_mfm_encode(
            [params["encoder_l"]["lstm"]], params["mfn_enc"]["mfn"], x_l,
            x_a, x_v, mem_dim=cfg.memsize, drops=mfn_drops(cfg),
            enc_xs=(x,))
    else:
        mfn_last = run_mfn(params["mfn_enc"], x_l, x_a, x_v, cfg)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    fy = zf_apply(params["zy_to_fy"], zy, 0.0, False)
    if model_type == "m_c":
        return [fy] * 3
    zl = linear_apply(params["encoder_l"]["fc1"], h_l)
    fl = zf_apply(params["zl_to_fl"], zl, 0.0, False)
    return [torch.cat([fy, fl], dim=1)] * 3
