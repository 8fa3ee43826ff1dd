"""The missing-modality baselines (port of ``seq2seq_*`` and
``basic_missing_*`` of ``factorized_tpu/models/baselines.py``), eval and
train forward.

- ``s2s`` (reference ``mfm_model.py:887-958``): cross-modal translation
  only. Each modality's latent comes from an encoder over the other two
  (``encoder_la_to_v``, ``encoder_lv_to_a``, ``encoder_av_to_l``); MMD
  ties the three latents to a Gaussian; the z->f MLPs drive the three
  modality decoders. No label head. Returns ``([x_l_hat], [x_a_hat],
  [x_v_hat], mmd)``.
- ``bm`` (``mfm_model.py:960-1017``): the label predicted from each pair
  of modalities by its own ``zy``-wide encoder and two-layer head, MMD on
  the three latents. Returns ``(y_hat_nol, y_hat_noa, y_hat_nov, mmd)``.

The JAX package runs these recurrences through ``lax.scan``; the port
runs the three encoders of either model as one ``multi_lstm``
(``fused_lstm_scan``, each cell's input product at its own width) and
``s2s``'s three decoders as one ``decoder_lstm`` (``fused_decoder_scan``),
the same function through the hand-written kernels (their plain versions
on the CPU).

Every random draw of a train forward has an injection point, in the
order of the JAX package's ``subkeys``: ``mmd_noise`` (three Gaussian
samples, each shaped like its latent, in the order the apply reads the
latents) and ``zf_masks`` (``s2s``: fl's, fa's and fv's) or ``y_masks``
(``bm``: the nol, noa and nov heads', all at ``zy_to_fy_dropout``, as in
the reference); what is not handed in is drawn from the
``torch.Generator``. In eval mode only the MMD samples are drawn.
"""

from __future__ import annotations

import torch

from factorized_tpu_torch.models.common import (encoder_latents, injected,
                                                mmd_sum, split_modalities,
                                                trio_decoders, zf_apply,
                                                zf_init)
from factorized_tpu_torch.ops.core import dropout_mask, mlp2_apply, mlp2_init
from factorized_tpu_torch.ops.lstm import decoder_init, encoder_init

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
        return torch.randn((n, z), generator=generator,
                           device=generator.device)

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
