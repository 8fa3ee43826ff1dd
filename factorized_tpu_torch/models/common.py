"""Shared model sub-structures (port of ``factorized_tpu/models/common.py``):
modality split, z->f feature MLPs, label head, the per-modality
encoder/decoder trios and the MFN encoder (``run_mfn``)."""

from __future__ import annotations

import torch

from factorized_tpu_torch.ops.core import linear_init, mlp2_apply, mlp2_init
from factorized_tpu_torch.ops.lstm import decoder_init, encoder_init
from factorized_tpu_torch.ops.mfn import mfn_apply, mfn_init


def split_modalities(x, input_dims):
    """x (..., d_total) -> (x_l, x_a, x_v) on the last axis."""
    d_l, d_a, _ = input_dims
    return x[..., :d_l], x[..., d_l:d_l + d_a], x[..., d_l + d_a:]


# ---- z -> f feature maps (relu(fc2(drop(relu(fc1(z)))))) ----------------

def zf_init(generator, z_size, f_size):
    return mlp2_init(generator, z_size, f_size, f_size)


def zf_apply(params, z, drop, train, generator=None, mask=None):
    return torch.relu(mlp2_apply(params, z, drop=drop, train=train,
                                 generator=generator, mask=mask))


# ---- label head (fc2(drop(relu(fc1(fy))))) ------------------------------

def yhead_init(generator, fy_size, output_dim):
    return mlp2_init(generator, fy_size, fy_size, output_dim)


def yhead_apply(params, fy, drop, train, generator=None, mask=None):
    return mlp2_apply(params, fy, drop=drop, train=train,
                      generator=generator, mask=mask)


# ---- trios --------------------------------------------------------------

def trio_encoder_init(generator, cfg):
    d_l, d_a, d_v = cfg.input_dims
    return {
        "encoder_l": encoder_init(generator, d_l, cfg.zl_size),
        "encoder_a": encoder_init(generator, d_a, cfg.za_size),
        "encoder_v": encoder_init(generator, d_v, cfg.zv_size),
    }


def trio_decoder_init(generator, cfg):
    """Decoders driven by the [fy, f_mod] concat."""
    d_l, d_a, d_v = cfg.input_dims
    return {
        "decoder_l": decoder_init(generator, cfg.fy_size + cfg.fl_size, d_l),
        "decoder_a": decoder_init(generator, cfg.fy_size + cfg.fa_size, d_a),
        "decoder_v": decoder_init(generator, cfg.fy_size + cfg.fv_size, d_v),
    }


def trio_zf_init(generator, cfg):
    return {
        "zy_to_fy": zf_init(generator, cfg.zy_size, cfg.fy_size),
        "zl_to_fl": zf_init(generator, cfg.zl_size, cfg.fl_size),
        "za_to_fa": zf_init(generator, cfg.za_size, cfg.fa_size),
        "zv_to_fv": zf_init(generator, cfg.zv_size, cfg.fv_size),
    }


def mfn_encoder_init(generator, cfg):
    """MFN trunk plus the last_hs -> zy projection."""
    return {
        "mfn": mfn_init(generator, cfg.input_dims, cfg.h_dims, cfg.memsize,
                        cfg.windowsize, cfg.att1_shape, cfg.att2_shape,
                        cfg.gamma1_shape, cfg.gamma2_shape),
        "last_to_zy": linear_init(generator, cfg.last_mfn_size, cfg.zy_size),
    }


def mfn_drops(cfg):
    return (cfg.att1_drop, cfg.att2_drop, cfg.gamma1_drop, cfg.gamma2_drop)


def zf_drops(cfg):
    """The z->f dropout rates in the order zy, zl, za, zv."""
    return (cfg.zy_to_fy_dropout, cfg.zl_to_fl_dropout,
            cfg.za_to_fa_dropout, cfg.zv_to_fv_dropout)


def run_mfn(params, x_l, x_a, x_v, cfg, train=False, generator=None,
            masks=None):
    """The MFN trunk of ``params`` (``mfn_encoder_init``'s tree) over the
    three modalities: last_hs (n, last_mfn_size); ``masks`` the injected
    dropout masks of ``mfn_apply``."""
    return mfn_apply(params["mfn"], x_l, x_a, x_v, mem_dim=cfg.memsize,
                     drops=mfn_drops(cfg), train=train, generator=generator,
                     masks=masks)
