"""Plain float32 MFM (``mfm``) and its ablation B (``m_b``): init, train
and eval forward, the joint loss.

Written from the MFM paper's model (arXiv:1806.06176, ``mfm_model.py``
of pliang279/factorized: MFM at lines 469-555, M_B at 271-343) as the
port states it, one plain PyTorch operation at a time: each LSTM a loop
over the steps, the Memory Fusion Network's attention and gates at each
step, every product a 2-D ``mm``. Nothing of the program is imported.

What the program derives from the seed the reference works out again:
the initial weights (the port's init order and bounds: U(-1/sqrt(fan
in), +1/sqrt(fan in)) from a CPU ``torch.Generator``, an LSTM's bias the
sum of two draws) and the random draws of each train step (the dropout
keep-masks and the MMD's Gaussian samples, in the order the port draws
them from one ``torch.Generator`` on the device; over K lanes each draw
is one ``(K, ...)`` draw of which lane k takes the k-th).

``Numerics`` says how products are computed: float32 (the reference), or
with both operands rounded to TF32's 10-bit mantissa, forward and
backward (the control).
"""

from __future__ import annotations

import math

import torch

MODELS = ("mfm", "m_b")
_MODS = ("l", "a", "v")


class Numerics:
    """Products in float32 (``tf32=False``) or with TF32's inputs."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a, b):
        if not self.tf32:
            return a @ b
        return _TF32MM.apply(a, b)


def round_tf32(x):
    """x rounded to the nearest float with a 10-bit mantissa (TF32)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


# ----------------------------------------------------------------- init

def _uniform(gen, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def _linear(gen, d_in, d_out):
    return {"w": _uniform(gen, (d_in, d_out), d_in),
            "b": _uniform(gen, (d_out,), d_in)}


def _lstm(gen, d, h):
    wx = _uniform(gen, (d, 4 * h), h)
    wh = _uniform(gen, (h, 4 * h), h)
    b = _uniform(gen, (4 * h,), h)
    return {"wx": wx, "wh": wh, "b": b + _uniform(gen, (4 * h,), h)}


def _mlp2(gen, a, b, c):
    return {"fc1": _linear(gen, a, b), "fc2": _linear(gen, b, c)}


def _coder(gen, d, h, d_out):
    """An encoder (LSTM d -> h, fc1 h -> h) or a decoder (LSTM h -> h,
    fc1 h -> d_out): the same two parts."""
    return {"lstm": _lstm(gen, d, h), "fc1": _linear(gen, h, d_out)}


def _enc_trio(gen, cfg):
    zs = (cfg["zl_size"], cfg["za_size"], cfg["zv_size"])
    return {f"encoder_{m}": _coder(gen, d, z, z)
            for m, d, z in zip(_MODS, cfg["input_dims"], zs)}


def init_params(cfg, model: str, seed: int):
    """The initial parameters of ``model`` from ``seed``, on the CPU, as
    the port draws them (its key order is its draw order)."""
    gen = torch.Generator().manual_seed(int(seed))
    fs = (cfg["fl_size"], cfg["fa_size"], cfg["fv_size"])
    zs = (cfg["zl_size"], cfg["za_size"], cfg["zv_size"])
    fy = cfg["fy_size"]
    if model == "mfm":
        p = {"enc": _enc_trio(gen, cfg)}
        p["dec"] = {f"decoder_{m}": _coder(gen, fy + f, fy + f, d)
                    for m, d, f in zip(_MODS, cfg["input_dims"], fs)}
        att = sum(cfg["h_dims"]) * cfg["windowsize"]
        gam = att + cfg["memsize"]
        mfn = {f"lstm_{m}": _lstm(gen, d, h)
               for m, d, h in zip(_MODS, cfg["input_dims"], cfg["h_dims"])}
        mfn["att1"] = _mlp2(gen, att, cfg["att1_shape"], att)
        mfn["att2"] = _mlp2(gen, att, cfg["att2_shape"], cfg["memsize"])
        mfn["gamma1"] = _mlp2(gen, gam, cfg["gamma1_shape"], cfg["memsize"])
        mfn["gamma2"] = _mlp2(gen, gam, cfg["gamma2_shape"], cfg["memsize"])
        last = sum(cfg["h_dims"]) + cfg["memsize"]
        p["mfn_enc"] = {"mfn": mfn,
                        "last_to_zy": _linear(gen, last, cfg["zy_size"])}
        p["zf"] = {f"z{m}_to_f{m}": _mlp2(gen, z, f, f)
                   for m, z, f in zip(("y", *_MODS),
                                      (cfg["zy_size"], *zs), (fy, *fs))}
        p["fy_to_y"] = _mlp2(gen, fy, fy, cfg["output_dim"])
        return p
    if model == "m_b":
        p = {"enc": _enc_trio(gen, cfg)}
        for m, d, f in zip(_MODS, cfg["input_dims"], fs):
            p[f"decoder_{m}"] = _coder(gen, f, f, d)
        for m, z, f in zip(_MODS, zs, fs):
            p[f"z{m}_to_f{m}"] = _mlp2(gen, z, f, f)
        p["fy_to_y"] = _mlp2(gen, sum(fs), fy, cfg["output_dim"])
        return p
    raise ValueError(f"the reference has no model {model!r}")


# ---------------------------------------------------------------- draws

class Draws:
    """The draws of train steps, in the port's order, from a generator
    seeded ``seed`` on ``device``; with ``lanes`` K each draw is one
    ``(K, ...)`` draw and lane ``lane`` takes its own."""

    def __init__(self, seed: int, device, lanes: int = 1, lane: int = 0,
                 batched: bool = False):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = device
        self.lanes, self.lane, self.batched = lanes, lane, batched

    def _draw(self, op, shape):
        if not self.batched:
            return op(tuple(shape), generator=self.gen, device=self.device)
        out = op((self.lanes, *shape), generator=self.gen,
                 device=self.device)
        return out[self.lane]

    def randn(self, shape):
        return self._draw(torch.randn, shape)

    def keep_mask(self, shape, rate):
        """Inverted dropout's scaled keep-mask; None where nothing
        drops (no draw)."""
        if rate <= 0.0:
            return None
        keep = 1.0 - rate
        kept = self._draw(torch.rand, shape) < keep
        return kept.to(torch.float32) * (1.0 / keep)


# -------------------------------------------------------------- forward

def _cell(c, gates):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lin(num, p, x):
    return num.mm(x, p["w"]) + p["b"]


def _mlp(num, p, x, mask=None):
    h = torch.relu(_lin(num, p["fc1"], x))
    if mask is not None:
        h = h * mask
    return _lin(num, p["fc2"], h)


def _xproj(num, cell, x):
    t, n, d = x.shape
    return (num.mm(x.reshape(t * n, d), cell["wx"]).reshape(t, n, -1)
            + cell["b"])


def _encoder(num, p, x):
    """fc1 of the last hidden state of an LSTM over x (t, n, d)."""
    xp = _xproj(num, p["lstm"], x)
    n = x.shape[1]
    H = p["lstm"]["wh"].shape[0]
    h = x.new_zeros((n, H))
    c = x.new_zeros((n, H))
    for s in range(x.shape[0]):
        h, c = _cell(c, xp[s] + num.mm(h, p["lstm"]["wh"]))
    return _lin(num, p["fc1"], h)


def _decoder(num, p, hT, t):
    """Step 0 on the latent from a zero state, then t - 1 steps on the
    previous hidden state; fc1 over every step: (t, n, d)."""
    cell = p["lstm"]
    h, c = _cell(hT.new_zeros(hT.shape), num.mm(hT, cell["wx"]) + cell["b"])
    w_sum = cell["wx"] + cell["wh"]
    all_h = [h]
    for _ in range(t - 1):
        h, c = _cell(c, num.mm(h, w_sum) + cell["b"])
        all_h.append(h)
    all_h = torch.stack(all_h)
    n, H = hT.shape
    return _lin(num, p["fc1"], all_h.reshape(t * n, H)).reshape(t, n, -1)


def _mfn(num, p, xs, mem_dim, masks):
    """The Memory Fusion Network over (x_l, x_a, x_v): [h_l, h_a, h_v,
    mem] after the last step; ``masks`` the four MLPs' (t, n, width)
    keep-masks or Nones."""
    cells = [p[f"lstm_{m}"] for m in _MODS]
    xps = [_xproj(num, c, x) for c, x in zip(cells, xs)]
    n = xs[0].shape[1]
    hs = [xs[0].new_zeros((n, c["wh"].shape[0])) for c in cells]
    cs = [h.clone() for h in hs]
    mem = xs[0].new_zeros((n, mem_dim))

    def site(i, name, x, s):
        return _mlp(num, p[name], x,
                    None if masks[i] is None else masks[i][s])

    for s in range(xs[0].shape[0]):
        new = [_cell(c, xp[s] + num.mm(h, cell["wh"]))
               for cell, xp, h, c in zip(cells, xps, hs, cs)]
        c_star = torch.cat([*cs, *(c for _, c in new)], dim=1)
        hs = [h for h, _ in new]
        cs = [c for _, c in new]
        attended = torch.softmax(site(0, "att1", c_star, s), dim=1) * c_star
        c_hat = torch.tanh(site(1, "att2", attended, s))
        both = torch.cat([attended, mem], dim=1)
        g1 = torch.sigmoid(site(2, "gamma1", both, s))
        g2 = torch.sigmoid(site(3, "gamma2", both, s))
        mem = g1 * mem + g2 * c_hat
    return torch.cat([*hs, mem], dim=1)


def _mmd(num, z, noise):
    """MMD(z, N(0, I)) against ``noise``, the kernel's exponent divided by
    the width squared."""
    d = z.shape[1]

    def k(a, b):
        a2 = torch.sum(a * a, dim=1, keepdim=True)
        b2 = torch.sum(b * b, dim=1, keepdim=True)
        sq = torch.clamp(a2 + b2.T - 2.0 * num.mm(a, b.T), min=0.0)
        return torch.exp(-sq / float(d * d))

    return (torch.mean(k(noise, noise)) + torch.mean(k(z, z))
            - 2.0 * torch.mean(k(noise, z)))


def _split(x, cfg):
    d_l, d_a, _ = cfg["input_dims"]
    return x[..., :d_l], x[..., d_l:d_l + d_a], x[..., d_l + d_a:]


def forward(params, x, cfg, model, num, draws=None):
    """x (t, n, d_total) -> ([x_l_hat, x_a_hat, x_v_hat, y_hat], mmd);
    with ``draws`` (a ``Draws``) the train forward with dropout, else the
    eval forward (the MMD then against a zero sample: eval reads y_hat
    alone)."""
    t, n, _ = x.shape
    xs = _split(x, cfg)
    train = draws is not None
    fs_w = (cfg["fl_size"], cfg["fa_size"], cfg["fv_size"])
    rates = (cfg["zl_to_fl_dropout"], cfg["za_to_fa_dropout"],
             cfg["zv_to_fv_dropout"])

    def mask(shape, rate):
        return draws.keep_mask(shape, rate) if train else None

    if model == "mfm":
        sites = ("att1", "att2", "gamma1", "gamma2")
        drops = [cfg[f"{s}_drop"] for s in sites]
        enc_masks = [mask((t, n, cfg[f"{s}_shape"]), r)
                     for s, r in zip(sites, drops)]
        zs = [_encoder(num, params["enc"][f"encoder_{m}"], xm)
              for m, xm in zip(_MODS, xs)]
        last = _mfn(num, params["mfn_enc"]["mfn"], xs, cfg["memsize"],
                    enc_masks)
        zy = _lin(num, params["mfn_enc"]["last_to_zy"], last)
        latents = [*zs, zy]
        dmax = max(z.shape[1] for z in latents)
        noise = (draws.randn((4, n, dmax)) if train
                 else x.new_zeros((4, n, dmax)))
        mmd = sum(_mmd(num, z, noise[i, :, :z.shape[1]])
                  for i, z in enumerate(latents))
        zf_rates = (cfg["zy_to_fy_dropout"], *rates)
        fy, fl, fa, fv = [
            torch.relu(_mlp(num, params["zf"][f"z{m}_to_f{m}"], z,
                            mask((n, f), r)))
            for m, z, f, r in zip(("y", *_MODS), (zy, *zs),
                                  (cfg["fy_size"], *fs_w), zf_rates)]
        x_hats = [_decoder(num, params["dec"][f"decoder_{m}"],
                           torch.cat([fy, f], dim=1), t)
                  for m, f in zip(_MODS, (fl, fa, fv))]
        y_hat = _mlp(num, params["fy_to_y"], fy,
                     mask((n, cfg["fy_size"]), cfg["fy_to_y_dropout"]))
        return [*x_hats, y_hat], mmd
    if model == "m_b":
        zs = [_encoder(num, params["enc"][f"encoder_{m}"], xm)
              for m, xm in zip(_MODS, xs)]
        mmd = sum(_mmd(num, z, draws.randn(z.shape) if train
                       else torch.zeros_like(z)) for z in zs)
        fs = [torch.relu(_mlp(num, params[f"z{m}_to_f{m}"], z,
                              mask((n, f), r)))
              for m, z, f, r in zip(_MODS, zs, fs_w, rates)]
        x_hats = [_decoder(num, params[f"decoder_{m}"], f, t)
                  for m, f in zip(_MODS, fs)]
        y_hat = _mlp(num, params["fy_to_y"], torch.cat(fs, dim=1),
                     mask((n, cfg["fy_size"]), cfg["fy_to_y_dropout"]))
        return [*x_hats, y_hat], mmd
    raise ValueError(f"the reference has no model {model!r}")


def joint_loss(out, x, y, cfg):
    """(loss, label loss): the L1 label loss, the three weighted
    reconstruction MSEs and lda_mmd times the MMD."""
    (x_l_hat, x_a_hat, x_v_hat, y_hat), mmd = out
    x_l, x_a, x_v = _split(x, cfg)
    disc = torch.mean(torch.abs(y_hat[:, 0] - y))
    gen = (cfg["lda_xl"] * torch.mean((x_l_hat - x_l) ** 2)
           + cfg["lda_xa"] * torch.mean((x_a_hat - x_a) ** 2)
           + cfg["lda_xv"] * torch.mean((x_v_hat - x_v) ** 2))
    return disc + gen + cfg["lda_mmd"] * mmd, disc


def y_hat(params, x, cfg, model, num, rows: int = 1024):
    """The eval forward's y_hat (n,) over x (t, n, d) in blocks of
    ``rows``."""
    with torch.no_grad():
        return torch.cat([forward(params, x[:, i:i + rows], cfg, model,
                                  num)[0][3][:, 0]
                          for i in range(0, x.shape[1], rows)])
