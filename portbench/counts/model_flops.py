"""Model FLOPs of one train step, in closed form from a configuration.

A frozen copy of the port's ``utils/flops.py::model_products`` (the JAX
package's count, to the FLOP) for the models the benchmark runs, ``mfm``
and ``m_b`` under the joint loss: the products the reference's own
per-modality layers do, forward and backward. A forward product of
``m x k`` by ``k x n`` costs ``2 m k n``, and its backward one more such
product for each operand that needs a gradient. ``cfg`` is a
configuration file's dict.
"""

from __future__ import annotations


def _p(m, k, n, lhs=True, rhs=True, batch=1):
    return [2 * batch * m * k * n * (1 + lhs + rhs)]


def _encoder(d, h, t, n):
    return _p(t * n, d, 4 * h, lhs=False) + _p(n, h, 4 * h) * t + _p(n, h, h)


def _mlp2(n, a, b, c):
    return _p(n, a, b) + _p(n, b, c)


def _decoder(hd, d, t, n):
    return (_p(n, hd, 4 * hd) + _p(n, hd, 4 * hd) * (t - 1)
            + _p(t * n, hd, d))


def _mfn(cfg, t, n):
    att = 2 * sum(cfg["h_dims"])
    gam = att + cfg["memsize"]
    out = [q for d, h in zip(cfg["input_dims"], cfg["h_dims"])
           for q in _p(t * n, d, 4 * h, lhs=False)]
    step = [q for h in cfg["h_dims"] for q in _p(n, h, 4 * h)]
    step += (_mlp2(n, att, cfg["att1_shape"], att)
             + _mlp2(n, att, cfg["att2_shape"], cfg["memsize"])
             + _mlp2(n, gam, cfg["gamma1_shape"], cfg["memsize"])
             + _mlp2(n, gam, cfg["gamma2_shape"], cfg["memsize"]))
    return out + step * t


def _mmd(n, d):
    return _p(n, d, n, False, False) + _p(n, d, n) + _p(n, d, n, False)


def _zs(cfg):
    return (cfg["zl_size"], cfg["za_size"], cfg["zv_size"])


def _fs(cfg):
    return (cfg["fl_size"], cfg["fa_size"], cfg["fv_size"])


def _trio(cfg, t, n):
    return [q for d, z in zip(cfg["input_dims"], _zs(cfg))
            for q in _encoder(d, z, t, n)]


def _mfm(cfg, t, n):
    d = max(*_zs(cfg), cfg["zy_size"])
    z_tot = sum(_zs(cfg)) + cfg["zy_size"]
    f_tot = cfg["fy_size"] + sum(_fs(cfg))
    out = (_trio(cfg, t, n) + _mfn(cfg, t, n)
           + _p(n, sum(cfg["h_dims"]) + cfg["memsize"], cfg["zy_size"])
           + _p(n, d, n, False, False, batch=4) + _p(n, d, n, batch=4)
           + _p(n, d, n, False, batch=4)
           + _p(n, z_tot, f_tot) + _p(n, f_tot, f_tot))
    for d_m, f in zip(cfg["input_dims"], _fs(cfg)):
        out += _decoder(cfg["fy_size"] + f, d_m, t, n)
    return out + _mlp2(n, cfg["fy_size"], cfg["fy_size"], cfg["output_dim"])


def _m_b(cfg, t, n):
    out = _trio(cfg, t, n)
    for d, z, f in zip(cfg["input_dims"], _zs(cfg), _fs(cfg)):
        out += _mmd(n, z) + _mlp2(n, z, f, f) + _decoder(f, d, t, n)
    return out + _mlp2(n, sum(_fs(cfg)), cfg["fy_size"], cfg["output_dim"])


_MODELS = {"mfm": _mfm, "m_b": _m_b}


def train_step_flops(cfg) -> int:
    """Model FLOPs of one train step of one lane at ``cfg``'s batch."""
    return sum(_MODELS[cfg["model_type"]](cfg, cfg["seqlength"],
                                          cfg["batchsize"]))
