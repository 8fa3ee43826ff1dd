"""The MFM model (port of ``factorized_tpu/models/mfm.py``, the ``mfm``
family member, eval and train forward).

Three unimodal encoders give zl/za/zv and the MFN gives zy, all in one
fused encode; MMD ties the four latents to a Gaussian; the z->f MLPs
feed the three decoders on [fy, f_m] and the label head fy -> y. The
port always takes the fused path. ``mfm_apply`` returns
``(decoded, mmd, 0.0)`` with ``decoded = [x_l_hat, x_a_hat, x_v_hat,
y_hat]``.

Every random draw of a train forward has an injection point, in the
order of the JAX package's ``subkeys(key, 4)``: the encode's dropout
masks, the MMD Gaussian, the z->f dropout masks and the y-head's. What
is not handed in is drawn from the ``torch.Generator``.
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
from factorized_tpu_torch.ops.core import dropout, linear_apply
from factorized_tpu_torch.ops.fused import (blockdiag, decoder_operands,
                                            encode_operands,
                                            fused_decoder_scan,
                                            fused_mfm_encode, split_heads)

_ENCODERS = ("encoder_l", "encoder_a", "encoder_v")
_DECODERS = ("decoder_l", "decoder_a", "decoder_v")


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
    if any(r > 0.0 for r in rates):
        masks = masks or (None,) * 4
        h = torch.cat([dropout(part, rate, True, generator, m)
                       for part, rate, m in zip(split_heads(h, f_dims),
                                                rates, masks)], dim=1)
    return tuple(split_heads(torch.relu(h @ w2 + b2), f_dims))


def _decode(params, fy, fl, fa, fv, t, cfg, *, train=False, generator=None,
            y_mask=None):
    dec = params["dec"]
    drives = [torch.cat([fy, f], dim=1) for f in (fl, fa, fv)]
    x_l_hat, x_a_hat, x_v_hat = fused_decoder_scan(
        [dec[k] for k in _DECODERS], drives, t)
    y_hat = yhead_apply(params["fy_to_y"], fy, cfg.fy_to_y_dropout, train,
                        generator, y_mask)
    return [x_l_hat, x_a_hat, x_v_hat, y_hat]


def _encode_stage(params, x_l, x_a, x_v, cfg, *, train=False, generator=None,
                  masks=None):
    """zl/za/zv latents and the MFN's last_hs, from the fused encode."""
    enc = params["enc"]
    (hl, ha, hv), mfn_last = fused_mfm_encode(
        [enc[k]["lstm"] for k in _ENCODERS], params["mfn_enc"]["mfn"],
        x_l, x_a, x_v, mem_dim=cfg.memsize, drops=mfn_drops(cfg),
        train=train, generator=generator, masks=masks)
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
    by d**2, as the JAX package does."""
    zs = (zl, za, zv, zy)
    dims = [z.shape[1] for z in zs]
    dmax = max(dims)
    Z = torch.stack([torch.nn.functional.pad(z, (0, dmax - d))
                     for z, d in zip(zs, dims)])
    mask = torch.stack([
        torch.cat([Z.new_ones(d), Z.new_zeros(dmax - d)]) for d in dims])
    R = noise * mask[:, None, :]
    inv_d2 = Z.new_tensor([1.0 / (d * d) for d in dims])

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
              mmd_noise=None, encode_masks=None, zf_masks=None, y_mask=None):
    """x (t, n, d_total) time-major -> (decoded, mmd, 0.0).

    The draws, each taken from ``generator`` (on x's device) unless
    handed in: ``encode_masks`` (t, n, att1 + att2 + gamma1 + gamma2
    widths, see ``cuda_mfn.make_dropout_masks``), ``mmd_noise`` (see
    ``mmd_noise_shape``), ``zf_masks`` (four scaled keep-masks (n, f_i)
    or None, order zy, zl, za, zv) and ``y_mask`` (n, fy). Only
    ``mmd_noise`` is drawn in eval mode."""
    t = x.shape[0]
    x_l, x_a, x_v = split_modalities(x, cfg.input_dims)
    zl, za, zv, mfn_last = _encode_stage(params, x_l, x_a, x_v, cfg,
                                         train=train, generator=generator,
                                         masks=encode_masks)
    zy = linear_apply(params["mfn_enc"]["last_to_zy"], mfn_last)
    if mmd_noise is None:
        if generator is None:
            raise ValueError("mfm_apply needs a torch.Generator or mmd_noise")
        mmd_noise = torch.randn(mmd_noise_shape(cfg, x.shape[1]),
                                generator=generator, device=x.device)
    mmd = _mmd4(zl, za, zv, zy, mmd_noise)
    fy, fl, fa, fv = _zf_all(params, zy, zl, za, zv, cfg, train=train,
                             generator=generator, masks=zf_masks)
    decoded = _decode(params, fy, fl, fa, fv, t, cfg, train=train,
                      generator=generator, y_mask=y_mask)
    return decoded, mmd, 0.0


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
    """The MFM model as an ``nn.Module`` over the JAX-shaped tree, e.g.
    ``state_dict()['enc.encoder_l.lstm.wx']``. ``params`` (a tree of
    tensors) or a ``seed`` for a fresh init; ``device`` defaults to the
    CUDA card. It starts in eval mode (serving); ``train()`` turns on
    dropout, and the forward then needs a ``generator`` or the
    injected draws of ``mfm_apply``."""

    def __init__(self, cfg, params=None, *, seed: int = 0, device=None):
        dev = resolve_device(device)
        if params is None:
            params = mfm_init(torch.Generator().manual_seed(seed), cfg)
        super().__init__(params)
        self.cfg = cfg
        self.to(dev)
        self.eval()

    def forward(self, x, *, generator=None, **draws):
        return mfm_apply(self.tree(), x, self.cfg, generator=generator,
                         train=self.training, **draws)
