"""The MFM family (port of ``factorized_tpu/models/mfm.py``): MFM, the
variational MFM_KL (``kl``), the early-fusion variational MFM_KL_EF
(``kl_ef``) and MFM_missing (``missing``), eval and train forward.

- ``mfm``: three unimodal encoders give zl/za/zv and the MFN gives zy,
  all in one fused encode; MMD ties the four latents to a Gaussian; the
  z->f MLPs feed the three decoders on [fy, f_m] and the label head
  fy -> y. Returns ``(decoded, mmd, 0.0)`` with ``decoded = [x_l_hat,
  x_a_hat, x_v_hat, y_hat]``.
- ``kl``: MFM's encode with mu/logvar heads per latent (zy and its
  logvar from the MFN's last state); the KLD is the regulariser, the
  decodes read the means. Returns ``(decoded, kld, 0.0)``.
- ``kl_ef``: mu/logvar heads per latent, zy from a joint early-fusion
  encoder; the four encoders run as one fused recurrence; the KLD is
  the regulariser; decodes from the mean, a quirk of the reference kept
  as it is. Returns ``(decoded, kld, 0.0)``.
- ``missing``: MFM plus six surrogate encoders (one fused recurrence)
  that infer a modality's latent, or zy, from the other two; decodes
  four ways. Returns ``(decoded, decoded_nol, decoded_noa, decoded_nov,
  mmd, missing_loss)``.

Each config takes one of two paths, picked from ``cfg`` alone before
any launch (``fused_active``, the JAX package's gate and switch
``FUSED``): below the FLOPs crossover the fused path (the encode kernel,
the decoder kernel and, for ``kl_ef`` and ``missing``, the fused
encoder-cell kernel, ``ops/fused.py``); at or above it the modular path
of the JAX package, one recurrence per module in plain PyTorch
(``ops/lstm.py``'s ``encoder_apply`` and ``decoder_apply``,
``ops/mfn.py::mfn_scan``), whose products are cuBLAS's. Both paths
compute the same function. Every random draw of a train forward has an
injection point, in the order of the JAX package's ``subkeys``, and the
same shape on both paths; what is not handed in is drawn from the
``torch.Generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.models.common import (
    mfn_drops,
    mfn_encoder_init,
    zf_drops,
    split_modalities,
    trio_decoder_init,
    trio_encoder_init,
    trio_zf_init,
    yhead_apply,
    yhead_init,
)
from factorized_tpu_torch.ops.core import (dropout, linear_apply, linear_init,
                                           rate_active)
from factorized_tpu_torch.ops.fused import (blockdiag, decoder_operands,
                                            encode_operands,
                                            fused_decoder_scan,
                                            fused_lstm_scan,
                                            fused_mfm_encode, lstm_operands,
                                            split_heads)
from factorized_tpu_torch.ops.losses import l2_loss, loss_kld
from factorized_tpu_torch.ops.lstm import (decoder_apply, encoder_apply,
                                           encoder_init)
from factorized_tpu_torch.ops.rows import draw, gather_rows
from factorized_tpu_torch.ops.mfn import mfn_scan

# The fused path against the modular one (the JAX package's switch):
# "auto" picks by the closed-form FLOPs of a train step
# (_step_flops_estimate) against _FUSED_FLOPS_CROSSOVER; True forces the
# fused path, False the modular one.
FUSED = "auto"

# The geometric midpoint, in _step_flops_estimate's FLOPs, between the
# largest config at which the fused path's train step took fewer device
# ms than the modular path's and the smallest at which it took more, on
# an H100 80GB HBM3 at 700.00 W (``perf_probe.py scale``, PERF.md section
# 6): A_b256_h256 (7.958e10: fused 15.72 ms, modular 23.06 ms) and
# B_b512_h512 (5.801e11: fused 166.20 ms, its chains' weights read from
# L2, modular 39.93 ms).
_FUSED_FLOPS_CROSSOVER = 2.1485901408992645e11


def _step_flops_estimate(cfg) -> float:
    """The closed-form estimate of one train step's model FLOPs that
    feeds the gate (the JAX package's, term for term: the trio and MFN
    LSTMs, the MFN's MLPs, the decoders and their output products, x3 for
    the backward); ``utils/flops.py`` counts them exactly."""
    t, n = cfg.seqlength, cfg.batchsize
    d_l, d_a, d_v = cfg.input_dims
    zs = (cfg.zl_size, cfg.za_size, cfg.zv_size)
    per_t = 0.0
    for d, z in zip((d_l, d_a, d_v), zs):
        per_t += 4 * z * (d + z)
    for d, h in zip((d_l, d_a, d_v), cfg.h_dims):
        per_t += 4 * h * (d + h)
    att_in = 2 * sum(cfg.h_dims)
    g_in = att_in + cfg.memsize
    per_t += att_in * cfg.att1_shape + cfg.att1_shape * att_in
    per_t += att_in * cfg.att2_shape + cfg.att2_shape * cfg.memsize
    per_t += g_in * cfg.gamma1_shape + cfg.gamma1_shape * cfg.memsize
    per_t += g_in * cfg.gamma2_shape + cfg.gamma2_shape * cfg.memsize
    for d, f in zip((d_l, d_a, d_v),
                    (cfg.fl_size, cfg.fa_size, cfg.fv_size)):
        hd = cfg.fy_size + f
        per_t += 4 * hd * 2 * hd + hd * d
    return 3.0 * 2.0 * n * t * per_t


def fused_active(cfg) -> bool:
    """Whether the fused path runs at this config (see ``FUSED``)."""
    if FUSED is True:
        return True
    if not FUSED:
        return False
    return _step_flops_estimate(cfg) < _FUSED_FLOPS_CROSSOVER


_ENCODERS = ("encoder_l", "encoder_a", "encoder_v")
_DECODERS = ("decoder_l", "decoder_a", "decoder_v")
# the surrogate encoders of ``missing``, in the JAX package's order
_SURROGATES = ("encoder_la_to_v", "encoder_lv_to_a", "encoder_av_to_l",
               "encoder_la_to_y", "encoder_lv_to_y", "encoder_av_to_y")


def _zf_all(params, zy, zl, za, zv, cfg=None, *, train=False,
            generator=None, masks=None):
    """The four z->f MLPs as two block-diagonal products; in train mode
    each site's dropout (``zf_drops``) acts on its slice of the hidden
    layer, with ``masks[i]`` the injected mask of site i (or None)."""
    zf = params["zf"]
    names = ("zy_to_fy", "zl_to_fl", "za_to_fa", "zv_to_fv")
    f_dims = [zf[n]["fc2"]["w"].shape[1] for n in names]
    w1 = blockdiag([zf[n]["fc1"]["w"] for n in names], f_dims)
    b1 = torch.cat([zf[n]["fc1"]["b"] for n in names])
    w2 = blockdiag([zf[n]["fc2"]["w"] for n in names], f_dims)
    b2 = torch.cat([zf[n]["fc2"]["b"] for n in names])

    h = torch.relu(torch.cat([zy, zl, za, zv], dim=1) @ w1 + b1)
    rates = zf_drops(cfg) if train else (0.0,) * 4
    if any(rate_active(r, train) for r in rates):
        masks = masks or (None,) * 4
        h = torch.cat([dropout(part, rate, True, generator, m)
                       for part, rate, m in zip(split_heads(h, f_dims),
                                                rates, masks)], dim=1)
    return tuple(split_heads(torch.relu(h @ w2 + b2), f_dims))


def _reconstruct(params, fy, fl, fa, fv, t, cfg):
    """The three modality decoders over t steps: [x_l_hat, x_a_hat,
    x_v_hat], each (t, n, d_i); one fused recurrence, or each decoder's
    own on the modular path."""
    dec = params["dec"]
    drives = [torch.cat([fy, f], dim=1) for f in (fl, fa, fv)]
    if not fused_active(cfg):
        return [decoder_apply(dec[k], drive, t)
                for k, drive in zip(_DECODERS, drives)]
    return fused_decoder_scan([dec[k] for k in _DECODERS], drives, t)


def _decode(params, fy, fl, fa, fv, t, cfg, *, train=False, generator=None,
            y_mask=None):
    x_l_hat, x_a_hat, x_v_hat = _reconstruct(params, fy, fl, fa, fv, t, cfg)
    y_hat = yhead_apply(params["fy_to_y"], fy, cfg.fy_to_y_dropout, train,
                        generator, y_mask)
    return [x_l_hat, x_a_hat, x_v_hat, y_hat]


def _encode_stage(params, x_l, x_a, x_v, cfg, *, train=False, generator=None,
                  masks=None, bwd_variant="stream"):
    """zl/za/zv latents and the MFN's last_hs: from the fused encode, or on
    the modular path from the three encoders and ``mfn_scan`` (the same
    ``masks``; ``bwd_variant`` is the fused encode's)."""
    enc = params["enc"]
    if not fused_active(cfg):
        zl, za, zv = [encoder_apply(enc[k], x)
                      for k, x in zip(_ENCODERS, (x_l, x_a, x_v))]
        mfn_last = mfn_scan(params["mfn_enc"]["mfn"], x_l, x_a, x_v,
                            mem_dim=cfg.memsize, drops=mfn_drops(cfg),
                            train=train, generator=generator, masks=masks)
        return zl, za, zv, mfn_last
    (hl, ha, hv), mfn_last = fused_mfm_encode(
        [enc[k]["lstm"] for k in _ENCODERS], params["mfn_enc"]["mfn"],
        x_l, x_a, x_v, mem_dim=cfg.memsize, drops=mfn_drops(cfg),
        train=train, generator=generator, masks=masks,
        bwd_variant=bwd_variant)
    zl = linear_apply(enc["encoder_l"]["fc1"], hl)
    za = linear_apply(enc["encoder_a"]["fc1"], ha)
    zv = linear_apply(enc["encoder_v"]["fc1"], hv)
    return zl, za, zv, mfn_last


def mmd_noise_shape(cfg, n: int):
    """Shape of the one padded Gaussian ``_mmd4`` draws: (4, n, dmax)."""
    return (4, n, max(cfg.zl_size, cfg.za_size, cfg.zv_size, cfg.zy_size))


def _mmd4(zl, za, zv, zy, noise):
    """Sum of the four MMD terms, batched: the latents padded to a common
    width and stacked; ``noise`` (4, n, dmax) is the Gaussian sample,
    zeroed here on each latent's padded dims. The kernel exponent divides
    by d**2, as the JAX package does. Under a data group the terms are the
    whole batch's (``ops.rows``: ``noise`` holds all the rows)."""
    zs = [gather_rows(z) for z in (zl, za, zv, zy)]
    dims = [z.shape[1] for z in zs]
    dmax = max(dims)
    Z = torch.stack([torch.nn.functional.pad(z, (0, dmax - d))
                     for z, d in zip(zs, dims)])
    mask = torch.stack([
        torch.cat([Z.new_ones(d), Z.new_zeros(dmax - d)]) for d in dims])
    R = noise * mask[:, None, :]
    # filled on the device, not copied from the host: a CUDA graph's
    # capture may not copy from pageable host memory
    inv_d2 = torch.stack([Z.new_full((), 1.0 / (d * d)) for d in dims])

    def kmean(A, B):
        a2 = torch.sum(A * A, dim=2)[:, :, None]
        b2 = torch.sum(B * B, dim=2)[:, None, :]
        sq = torch.clamp(a2 + b2 - 2.0 * torch.einsum("bnd,bmd->bnm", A, B),
                         min=0.0)
        return torch.mean(torch.exp(-sq * inv_d2[:, None, None]), dim=(1, 2))

    per_latent = kmean(R, R) + kmean(Z, Z) - 2.0 * kmean(R, Z)
    return torch.sum(per_latent)


def mfm_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``mfm_init``."""
    return {
        "enc": trio_encoder_init(generator, cfg),
        "dec": trio_decoder_init(generator, cfg),
        "mfn_enc": mfn_encoder_init(generator, cfg),
        "zf": trio_zf_init(generator, cfg),
        "fy_to_y": yhead_init(generator, cfg.fy_size, cfg.output_dim),
    }


def mfm_apply(params, x, cfg, *, generator=None, train=False,
              mmd_noise=None, encode_masks=None, zf_masks=None, y_mask=None,
              bwd_variant="stream"):
    """x (t, n, d_total) time-major -> (decoded, mmd, 0.0).

    The draws, each taken from ``generator`` (on x's device) unless
    handed in: ``encode_masks`` (t, n, att1 + att2 + gamma1 + gamma2
    widths, see ``cuda_mfn.make_dropout_masks``), ``mmd_noise`` (see
    ``mmd_noise_shape``), ``zf_masks`` (four scaled keep-masks (n, f_i)
    or None, order zy, zl, za, zv) and ``y_mask`` (n, fy). Only
    ``mmd_noise`` is drawn in eval mode. ``bwd_variant`` picks the
    encode's reverse kernel (``cuda_mfn.BWD_VARIANTS``; the probes try
    the others)."""
    t = x.shape[0]
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    zl, za, zv, mfn_last = _encode_stage(params, x_l, x_a, x_v, cfg,
                                         train=train, generator=generator,
                                         masks=encode_masks,
                                         bwd_variant=bwd_variant)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    mmd = _mmd4(zl, za, zv, zy, _mmd_noise(mmd_noise, generator, cfg, x))
    fy, fl, fa, fv = _zf_all(params, zy, zl, za, zv, cfg, train=train,
                             generator=generator, masks=zf_masks)
    decoded = _decode(params, fy, fl, fa, fv, t, cfg, train=train,
                      generator=generator, y_mask=y_mask)
    return decoded, mmd, 0.0


def _mmd_noise(noise, generator, cfg, x):
    """The MMD Gaussian: ``noise`` when handed in, else drawn."""
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("the MMD term needs a torch.Generator or mmd_noise")
    return draw(torch.randn, generator, mmd_noise_shape(cfg, x.shape[1]),
                rows=1, whole=True)


# ------------------------------------------------------- variational heads

def _varhead_init(generator, cfg):
    """Per-latent mu/logvar projections."""
    return {
        "last_to_zl": linear_init(generator, cfg.zl_size, cfg.zl_size),
        "last_to_za": linear_init(generator, cfg.za_size, cfg.za_size),
        "last_to_zv": linear_init(generator, cfg.zv_size, cfg.zv_size),
        "last_to_logvarzl": linear_init(generator, cfg.zl_size, cfg.zl_size),
        "last_to_logvarza": linear_init(generator, cfg.za_size, cfg.za_size),
        "last_to_logvarzv": linear_init(generator, cfg.zv_size, cfg.zv_size),
    }


def _var_latents(params, zl_last, za_last, zv_last):
    vh = params["varhead"]
    zl = linear_apply(vh["last_to_zl"], zl_last)
    za = linear_apply(vh["last_to_za"], za_last)
    zv = linear_apply(vh["last_to_zv"], zv_last)
    lv_l = linear_apply(vh["last_to_logvarzl"], zl_last)
    lv_a = linear_apply(vh["last_to_logvarza"], za_last)
    lv_v = linear_apply(vh["last_to_logvarzv"], zv_last)
    return zl, za, zv, lv_l, lv_a, lv_v


# --------------------------------------------------------------------- kl

def mfm_kl_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``mfm_kl_init``."""
    return {
        "enc": trio_encoder_init(generator, cfg),
        "dec": trio_decoder_init(generator, cfg),
        "varhead": _varhead_init(generator, cfg),
        "mfn_enc": mfn_encoder_init(generator, cfg),
        "last_to_logvarzy": linear_init(generator, cfg.last_mfn_size,
                                        cfg.zy_size),
        "zf": trio_zf_init(generator, cfg),
        "fy_to_y": yhead_init(generator, cfg.fy_size, cfg.output_dim),
    }


def mfm_kl_apply(params, x, cfg, *, generator=None, train=False,
                 encode_masks=None, zf_masks=None, y_mask=None,
                 bwd_variant="stream"):
    """x (t, n, d_total) time-major -> (decoded, kld, 0.0). The draws, in
    the order of the JAX package's ``subkeys(key, 3)``: ``encode_masks``,
    ``zf_masks`` and ``y_mask`` as in ``mfm_apply``; the eval forward
    draws nothing."""
    t = x.shape[0]
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    zl_last, za_last, zv_last, mfn_last = _encode_stage(
        params, x_l, x_a, x_v, cfg, train=train, generator=generator,
        masks=encode_masks, bwd_variant=bwd_variant)
    zl, za, zv, lv_l, lv_a, lv_v = _var_latents(params, zl_last, za_last,
                                                zv_last)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    lv_y = linear_apply(params["last_to_logvarzy"], mfn_last)
    kld = (loss_kld(zl, lv_l) + loss_kld(za, lv_a) + loss_kld(zv, lv_v)
           + loss_kld(zy, lv_y))
    fy, fl, fa, fv = _zf_all(params, zy, zl, za, zv, cfg, train=train,
                             generator=generator, masks=zf_masks)
    decoded = _decode(params, fy, fl, fa, fv, t, cfg, train=train,
                      generator=generator, y_mask=y_mask)
    return decoded, kld, 0.0


# ------------------------------------------------------------------ kl_ef

def mfm_kl_ef_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's ``mfm_kl_ef_init``."""
    last_ef = cfg.zl_size + cfg.za_size + cfg.zv_size
    return {
        "enc": trio_encoder_init(generator, cfg),
        "dec": trio_decoder_init(generator, cfg),
        "varhead": _varhead_init(generator, cfg),
        "ef_encoder": encoder_init(generator, cfg.d_total, last_ef),
        "last_to_zy": linear_init(generator, last_ef, cfg.zy_size),
        "last_to_logvarzy": linear_init(generator, last_ef, cfg.zy_size),
        "zf": trio_zf_init(generator, cfg),
        "fy_to_y": yhead_init(generator, cfg.fy_size, cfg.output_dim),
    }


def _kl_ef_cells(params, x, cfg):
    """The four fused encoder cells of ``kl_ef`` and their inputs."""
    enc = params["enc"]
    cells = ([enc[k]["lstm"] for k in _ENCODERS]
             + [params["ef_encoder"]["lstm"]])
    return cells, [*split_modalities(x, cfg.input_dims), x]


def mfm_kl_ef_apply(params, x, cfg, *, generator=None, train=False,
                    zf_masks=None, y_mask=None):
    """x (t, n, d_total) time-major -> (decoded, kld, 0.0). The draws, in
    the order of the JAX package's ``subkeys(key, 2)``: ``zf_masks`` and
    ``y_mask`` as in ``mfm_apply``; the eval forward draws nothing."""
    t = x.shape[0]
    encoders = [params["enc"][k] for k in _ENCODERS] + [params["ef_encoder"]]
    cells, xs = _kl_ef_cells(params, x, cfg)
    if fused_active(cfg):
        lasts = [linear_apply(p["fc1"], h)
                 for p, h in zip(encoders, fused_lstm_scan(cells, xs))]
    else:
        lasts = [encoder_apply(p, xi) for p, xi in zip(encoders, xs)]
    zl, za, zv, lv_l, lv_a, lv_v = _var_latents(params, *lasts[:3])
    ef_last = lasts[3]
    zy = linear_apply(params["last_to_zy"], ef_last)
    lv_y = linear_apply(params["last_to_logvarzy"], ef_last)
    kld = (loss_kld(zl, lv_l) + loss_kld(za, lv_a) + loss_kld(zv, lv_v)
           + loss_kld(zy, lv_y))
    # decodes from the MEAN latents, as the reference does
    fy, fl, fa, fv = _zf_all(params, zy, zl, za, zv, cfg, train=train,
                             generator=generator, masks=zf_masks)
    decoded = _decode(params, fy, fl, fa, fv, t, cfg, train=train,
                      generator=generator, y_mask=y_mask)
    return decoded, kld, 0.0


# ---------------------------------------------------------------- missing

def mfm_missing_init(generator, cfg):
    """The parameter tree, keyed as the JAX package's
    ``mfm_missing_init``."""
    d_l, d_a, d_v = cfg.input_dims
    tree = mfm_init(generator, cfg)
    widths = ((d_l + d_a, cfg.zv_size), (d_l + d_v, cfg.za_size),
              (d_a + d_v, cfg.zl_size), (d_l + d_a, cfg.zy_size),
              (d_l + d_v, cfg.zy_size), (d_a + d_v, cfg.zy_size))
    for name, (d, h) in zip(_SURROGATES, widths):
        tree[name] = encoder_init(generator, d, h)
    return tree


def _missing_cells(params, x, cfg):
    """The six fused surrogate encoder cells of ``missing`` and their
    inputs."""
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    x_la = torch.cat([x_l, x_a], dim=2)
    x_lv = torch.cat([x_l, x_v], dim=2)
    x_av = torch.cat([x_a, x_v], dim=2)
    return ([params[k]["lstm"] for k in _SURROGATES],
            [x_la, x_lv, x_av, x_la, x_lv, x_av])


def mfm_missing_apply(params, x, cfg, *, generator=None, train=False,
                      encode_masks=None, mmd_noise=None, zf_masks=None,
                      y_masks=None):
    """x (t, n, d_total) time-major -> (decoded, decoded_nol, decoded_noa,
    decoded_nov, mmd, missing_loss). The draws, in the order of the JAX
    package's ``subkeys(key, 6)``: ``encode_masks`` and ``mmd_noise`` as
    in ``mfm_apply``, then the four decodes (all present, l missing, a
    missing, v missing), each with its z->f masks (``zf_masks[k]``, four
    masks or None as in ``mfm_apply``) and its y-head mask
    (``y_masks[k]``)."""
    t = x.shape[0]
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    zl, za, zv, mfn_last = _encode_stage(params, x_l, x_a, x_v, cfg,
                                         train=train, generator=generator,
                                         masks=encode_masks)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    cells, xs = _missing_cells(params, x, cfg)
    if fused_active(cfg):
        surrogates = [linear_apply(params[k]["fc1"], h) for k, h in zip(
            _SURROGATES, fused_lstm_scan(cells, xs))]
    else:
        surrogates = [encoder_apply(params[k], xi)
                      for k, xi in zip(_SURROGATES, xs)]
    zv_nov, za_noa, zl_nol, zy_nov, zy_noa, zy_nol = surrogates

    mmd = _mmd4(zl, za, zv, zy, _mmd_noise(mmd_noise, generator, cfg, x))
    missing_loss = (l2_loss(zv_nov, zv) + l2_loss(za_noa, za)
                    + l2_loss(zl_nol, zl) + l2_loss(zy_nov, zy)
                    + l2_loss(zy_noa, zy) + l2_loss(zy_nol, zy))
    zf_masks = zf_masks or (None,) * 4
    y_masks = y_masks or (None,) * 4
    decoded = _decode_stacked(
        params, [(zl, za, zv, zy), (zl_nol, za, zv, zy_nol),
                 (zl, za_noa, zv, zy_noa), (zl, za, zv_nov, zy_nov)],
        t, cfg, train=train, generator=generator, zf_masks=zf_masks,
        y_masks=y_masks)
    return (*decoded, mmd, missing_loss)


def _decode_stacked(params, latents, t, cfg, *, train=False, generator=None,
                    zf_masks, y_masks):
    """The decodes of the latent sets ``latents`` [(zl, za, zv, zy)], all
    over the same decoder parameters: each set's z->f MLPs and y head run
    per set, in order (the JAX package's order of draws), and the decoder
    recurrence runs once over the sets stacked along the rows (on the
    modular path, once per set, as the JAX package's). Returns a decode
    ``[x_l_hat, x_a_hat, x_v_hat, y_hat]`` per set."""
    fs, y_hats = [], []
    for k, (zl, za, zv, zy) in enumerate(latents):
        fy, fl, fa, fv = _zf_all(params, zy, zl, za, zv, cfg, train=train,
                                 generator=generator, masks=zf_masks[k])
        fs.append((fy, fl, fa, fv))
        y_hats.append(yhead_apply(params["fy_to_y"], fy, cfg.fy_to_y_dropout,
                                  train, generator, y_masks[k]))
    if not fused_active(cfg):
        return [[*_reconstruct(params, *f, t, cfg), y]
                for f, y in zip(fs, y_hats)]
    recon = _reconstruct(params, *(torch.cat(f) for f in zip(*fs)), t, cfg)
    n = latents[0][0].shape[0]
    return [[x[:, k * n:(k + 1) * n] for x in recon] + [y_hats[k]]
            for k in range(len(latents))]


def fused_cells(params, x, cfg, model_type: str):
    """The fused encoder cells of ``kl_ef`` or ``missing`` and their
    (t, n, d_i) inputs for ``x``."""
    cells = {"kl_ef": _kl_ef_cells, "missing": _missing_cells}[model_type]
    return cells(params, x, cfg)


def multi_lstm_operands(params, x, cfg, model_type: str):
    """What ``cuda_lstm.multi_lstm_fwd`` takes for ``x`` in the forward of
    ``kl_ef`` or ``missing``: (xp, wh, h_dims). For holding the kernels
    against their plain versions, and timing them, at the inputs the main
    path gives them."""
    return lstm_operands(*fused_cells(params, x, cfg, model_type))


def kernel_operands(params, x, cfg):
    """What the eval forward hands the two kernels for ``x``:
    ``((xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims))`` as
    taken by ``cuda_mfn.mfm_encode`` and ``cuda_lstm.decoder_lstm_fwd``.
    For holding the kernels against their plain versions, and timing
    them, at the inputs the main path gives them."""
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    encode = encode_operands(
        [params["enc"][k]["lstm"] for k in _ENCODERS],
        params["mfn_enc"]["mfn"], x_l, x_a, x_v)
    zl, za, zv, mfn_last = _encode_stage(params, x_l, x_a, x_v, cfg)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    fy, fl, fa, fv = _zf_all(params, zy, zl, za, zv)
    decode = decoder_operands(
        [params["dec"][k] for k in _DECODERS],
        [torch.cat([fy, f], dim=1) for f in (fl, fa, fv)])
    return encode, decode


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters, so that
    ``state_dict()`` keys are the tree's paths joined by '.'."""

    def __init__(self, tree):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self):
        """The nested dict of this module's parameters (no copies)."""
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            out[k] = v.tree() if isinstance(v, ParamTree) else v
        return out


class MFM(ParamTree):
    """A model of the MFM family as an ``nn.Module`` over the JAX-shaped
    tree, e.g. ``state_dict()['enc.encoder_l.lstm.wx']``; its init and
    apply come from the registry by ``model_type`` (default
    ``cfg.model_type``). ``params`` (a tree of tensors) or a ``seed`` for
    a fresh init; ``device`` defaults to the CUDA card. It starts in eval
    mode (serving); ``train()`` turns on dropout, and the forward then
    needs a ``generator`` or the injected draws of the apply function."""

    def __init__(self, cfg, params=None, *, seed: int = 0, device=None,
                 model_type=None):
        from factorized_tpu_torch.models.registry import get_model

        dev = resolve_device(device)
        name = model_type or cfg.model_type
        init, apply_fn = get_model(name)
        if params is None:
            params = init(torch.Generator().manual_seed(seed), cfg)
        super().__init__(params)
        self.cfg = cfg
        self.model_type = name
        self._apply_fn = apply_fn
        self.to(dev)
        self.eval()

    def forward(self, x, *, generator=None, **draws):
        return self._apply_fn(self.tree(), x, self.cfg, generator=generator,
                              train=self.training, **draws)
