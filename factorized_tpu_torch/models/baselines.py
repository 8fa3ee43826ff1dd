"""The baselines (port of ``seq2seq_*``, ``basic_missing_*``,
``eflstm_*``, ``mfn_predictor_*`` and ``self_attention_*`` of
``factorized_tpu/models/baselines.py``), eval and train forward.

- ``s2s`` (reference ``mfm_model.py:887-958``): cross-modal translation
  only. Each modality's latent comes from an encoder over the other two
  (``encoder_la_to_v``, ``encoder_lv_to_a``, ``encoder_av_to_l``); MMD
  ties the three latents to a Gaussian; the z->f MLPs drive the three
  modality decoders. No label head. Returns ``([x_l_hat], [x_a_hat],
  [x_v_hat], mmd)``.
- ``bm`` (``mfm_model.py:960-1017``): the label predicted from each pair
  of modalities by its own ``zy``-wide encoder and two-layer head, MMD on
  the three latents. Returns ``(y_hat_nol, y_hat_noa, y_hat_nov, mmd)``.
- the ``predictor`` command's discriminative baselines, each returning
  its logits ``(n, output_dim)``: ``eflstm`` (``test_mosi.py:130-156``),
  one LSTM over the concatenated input, then ``fc2(drop(relu(fc1(h))))``;
  ``mfn_predictor`` (registered as ``"mfn"``, ``test_mosi.py:269-482``),
  the MFN (``ops/mfn.py::mfn_apply``, the encode with no encoder cell)
  and its two-layer ``out`` head; ``self_attention``
  (``test_attention.py:266-404``), the batch-major Gram matrix of the
  input, row-scaled by ``alpha (t, 1)``, re-weighting the sequence, then
  ``eflstm``'s LSTM head. ``eflstm`` and ``self_attention`` take ``d``,
  ``h`` and ``t`` rather than a config, so they stay out of the registry,
  as in the JAX package.

The JAX package runs these recurrences through ``lax.scan``; the port
runs the three encoders of either model as one ``multi_lstm``
(``fused_lstm_scan``, each cell's input product at its own width),
``s2s``'s three decoders as one ``decoder_lstm`` (``fused_decoder_scan``)
and the one LSTM of ``eflstm`` and ``self_attention`` as a
``multi_lstm`` of one cell, the same function through the hand-written
kernels (their plain versions on the CPU). ``self_attention``'s two Gram
products are plain ``torch.bmm``, as they are plain XLA in the JAX
package.

Every random draw of a train forward has an injection point, in the
order of the JAX package's ``subkeys``: ``mmd_noise`` (three Gaussian
samples, each shaped like its latent, in the order the apply reads the
latents) and ``zf_masks`` (``s2s``: fl's, fa's and fv's) or ``y_masks``
(``bm``: the nol, noa and nov heads', all at ``zy_to_fy_dropout``, as in
the reference); ``mask``, the one dropout mask after ``relu(fc1)`` of
``eflstm`` and ``self_attention``; ``encode_masks`` (the MFN's four
sites, ``cuda_mfn.make_dropout_masks``) then ``out_mask`` of
``mfn_predictor``. What is not handed in is drawn from the
``torch.Generator``. In eval mode only the MMD samples are drawn.
"""

from __future__ import annotations

import torch

from factorized_tpu_torch.models.common import (encoder_latents, injected,
                                                mfn_drops, mmd_sum, run_mfn,
                                                split_modalities,
                                                trio_decoders, zf_apply,
                                                zf_init)
from factorized_tpu_torch.ops import cuda_mfn
from factorized_tpu_torch.ops.core import (dropout, dropout_mask,
                                           linear_apply, linear_init,
                                           mlp2_apply, mlp2_init,
                                           uniform_fan_in)
from factorized_tpu_torch.ops.fused import fused_lstm_scan
from factorized_tpu_torch.ops.lstm import (decoder_init, encoder_init,
                                           lstm_cell_init)
from factorized_tpu_torch.ops.mfn import mfn_init
from factorized_tpu_torch.ops.rows import draw

_S2S_ENCODERS = ("encoder_la_to_v", "encoder_lv_to_a", "encoder_av_to_l")
_BM_ENCODERS = ("encoder_la_to_y", "encoder_lv_to_y", "encoder_av_to_y")


def _pairs(x, cfg):
    """The three two-modality inputs [l, a], [l, v] and [a, v]."""
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    return (torch.cat([x_l, x_a], dim=2), torch.cat([x_l, x_v], dim=2),
            torch.cat([x_a, x_v], dim=2))


# ------------------------------------------------------------- seq2seq

def seq2seq_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``seq2seq_init``."""
    d_l, d_a, d_v = cfg.input_dims
    return {
        "encoder_la_to_v": encoder_init(generator, d_l + d_a, cfg.zv_size),
        "encoder_lv_to_a": encoder_init(generator, d_l + d_v, cfg.za_size),
        "encoder_av_to_l": encoder_init(generator, d_a + d_v, cfg.zl_size),
        "decoder_l": decoder_init(generator, cfg.fl_size, d_l),
        "decoder_a": decoder_init(generator, cfg.fa_size, d_a),
        "decoder_v": decoder_init(generator, cfg.fv_size, d_v),
        "zl_to_fl": zf_init(generator, cfg.zl_size, cfg.fl_size),
        "za_to_fa": zf_init(generator, cfg.za_size, cfg.fa_size),
        "zv_to_fv": zf_init(generator, cfg.zv_size, cfg.fv_size),
    }


def seq2seq_apply(params, x, cfg, *, generator=None, train=False,
                  mmd_noise=None, zf_masks=None):
    """x (t, n, d_total) time-major -> ([x_l_hat], [x_a_hat], [x_v_hat],
    mmd). The draws: ``mmd_noise`` (zv_nov's, za_noa's and zl_nol's) and
    ``zf_masks`` (fl's, fa's and fv's)."""
    t = x.shape[0]
    zv_nov, za_noa, zl_nol = encoder_latents(params, _S2S_ENCODERS,
                                             _pairs(x, cfg))
    mmd = mmd_sum((zv_nov, za_noa, zl_nol), injected(mmd_noise, 3),
                  generator)
    m_l, m_a, m_v = injected(zf_masks, 3)
    fl = zf_apply(params["zl_to_fl"], zl_nol, cfg.zl_to_fl_dropout, train,
                  generator, m_l)
    fa = zf_apply(params["za_to_fa"], za_noa, cfg.za_to_fa_dropout, train,
                  generator, m_a)
    fv = zf_apply(params["zv_to_fv"], zv_nov, cfg.zv_to_fv_dropout, train,
                  generator, m_v)
    x_l_hat, x_a_hat, x_v_hat = trio_decoders(params, [fl, fa, fv], t)
    return [x_l_hat], [x_a_hat], [x_v_hat], mmd


# -------------------------------------------------------- basic_missing

def basic_missing_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's
    ``basic_missing_init``."""
    d_l, d_a, d_v = cfg.input_dims
    return {
        "encoder_la_to_y": encoder_init(generator, d_l + d_a, cfg.zy_size),
        "encoder_lv_to_y": encoder_init(generator, d_l + d_v, cfg.zy_size),
        "encoder_av_to_y": encoder_init(generator, d_a + d_v, cfg.zy_size),
        "zy_nol_to_y": mlp2_init(generator, cfg.zy_size, cfg.fy_size,
                                 cfg.output_dim),
        "zy_noa_to_y": mlp2_init(generator, cfg.zy_size, cfg.fy_size,
                                 cfg.output_dim),
        "zy_nov_to_y": mlp2_init(generator, cfg.zy_size, cfg.fy_size,
                                 cfg.output_dim),
    }


def basic_missing_apply(params, x, cfg, *, generator=None, train=False,
                        mmd_noise=None, y_masks=None):
    """x (t, n, d_total) time-major -> (y_hat_nol, y_hat_noa, y_hat_nov,
    mmd), each y_hat (n, output_dim). The draws: ``mmd_noise`` (zy_nov's,
    zy_noa's and zy_nol's) and ``y_masks`` (the nol, noa and nov
    heads')."""
    zy_nov, zy_noa, zy_nol = encoder_latents(params, _BM_ENCODERS,
                                             _pairs(x, cfg))
    mmd = mmd_sum((zy_nov, zy_noa, zy_nol), injected(mmd_noise, 3),
                  generator)
    drop = cfg.zy_to_fy_dropout  # the reference reuses this rate for all 3
    y_hats = [mlp2_apply(params[k], z, drop=drop, train=train,
                         generator=generator, mask=m)
              for k, z, m in zip(("zy_nol_to_y", "zy_noa_to_y",
                                  "zy_nov_to_y"), (zy_nol, zy_noa, zy_nov),
                                 injected(y_masks, 3))]
    return (*y_hats, mmd)


def train_draws(cfg, n, generator):
    """Draws to inject into one train forward of ``cfg.model_type``
    (``s2s`` or ``bm``) at batch n, made from ``generator`` on its device
    in the order the apply reads them: ``mmd_noise`` and ``zf_masks``
    (``s2s``) or ``y_masks`` (``bm``)."""
    def noise(z):
        return draw(torch.randn, generator, (n, z), whole=True)

    if cfg.model_type == "s2s":
        return {"mmd_noise": [noise(z) for z in (cfg.zv_size, cfg.za_size,
                                                 cfg.zl_size)],
                "zf_masks": [dropout_mask(generator, (n, f), rate)
                             for f, rate in (
                                 (cfg.fl_size, cfg.zl_to_fl_dropout),
                                 (cfg.fa_size, cfg.za_to_fa_dropout),
                                 (cfg.fv_size, cfg.zv_to_fv_dropout))]}
    return {"mmd_noise": [noise(cfg.zy_size) for _ in range(3)],
            "y_masks": [dropout_mask(generator, (n, cfg.fy_size),
                                     cfg.zy_to_fy_dropout)
                        for _ in range(3)]}


# ---------------------------------------------------------------- EFLSTM

def eflstm_init(generator, d, h, output_dim):
    """The parameter tree, keyed as the JAX package's ``eflstm_init``."""
    return {"lstm": lstm_cell_init(generator, d, h),
            "fc1": linear_init(generator, h, h),
            "fc2": linear_init(generator, h, output_dim)}


def _lstm_head(params, x, drop, train, generator, mask):
    """``fc2(drop(relu(fc1(h_last))))`` of the LSTM ``params["lstm"]``
    over time-major ``x``, its recurrence a ``multi_lstm`` of one cell."""
    (h_last,) = fused_lstm_scan([params["lstm"]], [x])
    out = torch.relu(linear_apply(params["fc1"], h_last))
    out = dropout(out, drop, train, generator, mask)
    return linear_apply(params["fc2"], out)


def eflstm_apply(params, x, drop, *, generator=None, train=False,
                 mask=None):
    """x (t, n, d) time-major -> logits (n, output_dim)."""
    return _lstm_head(params, x, drop, train, generator, mask)


# ------------------------------------------------------- MFN predictor

def mfn_predictor_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's
    ``mfn_predictor_init``."""
    return {"mfn": mfn_init(generator, cfg.input_dims, cfg.h_dims,
                            cfg.memsize, cfg.windowsize, cfg.att1_shape,
                            cfg.att2_shape, cfg.gamma1_shape,
                            cfg.gamma2_shape),
            "out": mlp2_init(generator, cfg.last_mfn_size, cfg.out_shape,
                             cfg.output_dim)}


def mfn_predictor_apply(params, x, cfg, *, generator=None, train=False,
                        encode_masks=None, out_mask=None):
    """x (t, n, d_total) time-major -> logits (n, output_dim): the MFN's
    last_hs through the ``out`` head at ``out_drop``."""
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    last = run_mfn(params, x_l, x_a, x_v, cfg, train, generator,
                   encode_masks)
    return mlp2_apply(params["out"], last, drop=cfg.out_drop, train=train,
                      generator=generator, mask=out_mask)


# -------------------------------------------------------- SelfAttention

def self_attention_init(generator, d, h, t, output_dim):
    """The parameter tree, keyed as the JAX package's
    ``self_attention_init``; ``alpha`` U(-1/sqrt(t), 1/sqrt(t)), as the
    JAX package draws the memory the reference leaves uninitialised."""
    return {"alpha": uniform_fan_in(generator, (t, 1), t),
            "lstm": lstm_cell_init(generator, d, h),
            "fc1": linear_init(generator, h, h),
            "fc2": linear_init(generator, h, output_dim)}


def self_attention_apply(params, x, drop, *, generator=None, train=False,
                         mask=None):
    """x BATCH-major (n, t, d), as the reference keeps this path
    (``test_attention.py:344``) -> logits (n, output_dim)."""
    gram = torch.bmm(x, x.transpose(1, 2))  # (n, t, t)
    attended = torch.bmm(params["alpha"] * gram, x)
    return _lstm_head(params, attended.transpose(0, 1), drop, train,
                      generator, mask)


def predictor_draws(kind, cfg, n, generator, h=None, drop=0.0):
    """Draws to inject into one train forward of the predictor ``kind`` at
    batch n, made from ``generator`` on its device in the order the apply
    reads them: ``encode_masks`` and ``out_mask`` (``mfn``), or ``mask``
    (``eflstm``, ``self_attention``: (n, h) at ``drop``)."""
    if kind == "mfn":
        return {"encode_masks": cuda_mfn.make_dropout_masks(
                    generator, cfg.seqlength, n,
                    (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
                     cfg.gamma2_shape), mfn_drops(cfg)),
                "out_mask": dropout_mask(generator, (n, cfg.out_shape),
                                         cfg.out_drop)}
    return {"mask": dropout_mask(generator, (n, h), drop)}
