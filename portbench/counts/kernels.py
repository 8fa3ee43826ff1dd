"""The work each of the port's hand-written kernel families must do, from
a configuration's shapes alone, and the least time the card could take
for it.

Counted as the algorithm needs it, not as a kernel happens to do it: the
FLOPs of the matrix products the family computes (2 m k n each; the
gate and softmax arithmetic is left out, so the count is a floor), and
the bytes of its inputs read once and its outputs written once, in
float32 (saved activations that a design keeps for its backward are the
design's, not counted). A recurrence's first step is on a zero state, so
its product is not counted. Every count is for one lane at ``n`` rows;
K lanes do K times the work.

The families, by what the port launches:

- ``encode``: ``mfm_encode_fwd`` (the unimodal encoders' and the Memory
  Fusion Network's LSTM chains, the network's four two-layer MLPs each
  step, the memory update), ``mfm_encode_bwd`` (the same products'
  data gradients) and ``mfm_encode_dw`` (the MLPs' weight gradients
  over the t n rows);
- ``chains``: ``decoder_lstm`` forward and backward (the decoders' t - 1
  recurrent steps on W_x + W_h) and ``multi_lstm`` forward and backward
  (a trio of encoder LSTMs as one recurrence).
"""

from __future__ import annotations

F32 = 4


def _mlps(cfg):
    """The Memory Fusion Network's MLPs as (in, hidden, out)."""
    att = sum(cfg["h_dims"]) * cfg["windowsize"]
    gam = att + cfg["memsize"]
    mem = cfg["memsize"]
    return ((att, cfg["att1_shape"], att), (att, cfg["att2_shape"], mem),
            (gam, cfg["gamma1_shape"], mem), (gam, cfg["gamma2_shape"], mem))


def _encode_cells(cfg):
    return (cfg["zl_size"], cfg["za_size"], cfg["zv_size"], *cfg["h_dims"])


def _chain(hs, t, n):
    """FLOPs of recurrent products h @ W_h (h x 4h) over t - 1 steps."""
    return sum(2 * n * h * 4 * h for h in hs) * (t - 1)


def encode_fwd(cfg, n, train):
    t, cells, mlps = cfg["seqlength"], _encode_cells(cfg), _mlps(cfg)
    flops = (_chain(cells, t, n)
             + t * sum(2 * n * (a * b + b * c) for a, b, c in mlps))
    weights = (sum(h * 4 * h for h in cells)
               + sum(a * b + b + b * c + c for a, b, c in mlps))
    floats = (t * n * 4 * sum(cells) + weights
              + n * (sum(cells) + cfg["memsize"]))
    if train:
        floats += t * n * sum(b for _, b, _ in mlps)
    return flops, F32 * floats


def encode_bwd(cfg, n):
    t, cells, mlps = cfg["seqlength"], _encode_cells(cfg), _mlps(cfg)
    flops = (_chain(cells, t, n)
             + t * sum(2 * n * (a * b + b * c) for a, b, c in mlps))
    weights = (sum(h * 4 * h for h in cells)
               + sum(a * b + b * c for a, b, c in mlps))
    floats = (n * (sum(cells) + cfg["memsize"]) + weights
              + t * n * 4 * sum(cells))
    return flops, F32 * floats


def encode_dw(cfg, n):
    t, mlps = cfg["seqlength"], _mlps(cfg)
    flops = t * sum(2 * n * (a * b + b * c) for a, b, c in mlps)
    floats = sum(t * n * (a + 2 * b + c) + a * b + b + b * c + c
                 for a, b, c in mlps)
    return flops, F32 * floats


def _decoder_dims(cfg):
    fs = (cfg["fl_size"], cfg["fa_size"], cfg["fv_size"])
    if cfg["model_type"] == "mfm":
        return tuple(cfg["fy_size"] + f for f in fs)
    return fs


def decoder_fwd(cfg, n):
    t, hs = cfg["seqlength"], _decoder_dims(cfg)
    floats = 2 * n * sum(hs) + sum(h * 4 * h + 4 * h for h in hs)
    return _chain(hs, t, n), F32 * (floats + t * n * sum(hs))


def decoder_bwd(cfg, n):
    t, hs = cfg["seqlength"], _decoder_dims(cfg)
    floats = (t * n * sum(hs) + sum(h * 4 * h for h in hs)
              + t * n * 4 * sum(hs))
    return _chain(hs, t, n), F32 * floats


def multi_fwd(cfg, n):
    t = cfg["seqlength"]
    hs = (cfg["zl_size"], cfg["za_size"], cfg["zv_size"])
    floats = t * n * 4 * sum(hs) + sum(h * 4 * h for h in hs) + n * sum(hs)
    return _chain(hs, t, n), F32 * floats


def multi_bwd(cfg, n):
    t = cfg["seqlength"]
    hs = (cfg["zl_size"], cfg["za_size"], cfg["zv_size"])
    floats = n * sum(hs) + sum(h * 4 * h for h in hs) + t * n * 4 * sum(hs)
    return _chain(hs, t, n), F32 * floats


def least_seconds(flops, nbytes, peaks):
    """The larger of the FLOPs at the float32 peak and the bytes at the
    memory bandwidth."""
    return max(flops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes"])


def family_calls(cfg, family, *, steps, epochs, trials, lanes, batch,
                 n_valid, n_test):
    """[(flops, bytes)] of every call of ``family`` in ``trials`` trials of
    ``epochs`` epochs of ``steps`` train steps each, K = ``lanes``: each
    step's train calls, each epoch's eval over the validation set, each
    trial's test predict (the y_hat forward: no decoders)."""
    mfm = cfg["model_type"] == "mfm"
    calls = []
    if family == "encode" and mfm:
        calls += [(encode_fwd(cfg, batch, True), steps),
                  (encode_bwd(cfg, batch), steps),
                  (encode_dw(cfg, batch), steps),
                  (encode_fwd(cfg, n_valid, False), epochs),
                  (encode_fwd(cfg, n_test, False), trials)]
    if family == "chains":
        calls += [(decoder_fwd(cfg, batch), steps),
                  (decoder_bwd(cfg, batch), steps),
                  (decoder_fwd(cfg, n_valid), epochs)]
        if not mfm:
            calls += [(multi_fwd(cfg, batch), steps),
                      (multi_bwd(cfg, batch), steps),
                      (multi_fwd(cfg, n_valid), epochs),
                      (multi_fwd(cfg, n_test), trials)]
    return [((f * lanes, b * lanes), k) for (f, b), k in calls if k]


def roofline_share(ctx, family, names):
    """% of the least time of ``family``'s work in the traced trial over
    the device time of the kernels ``names``; None where the trace holds
    none of them or the card has no peaks."""
    if ctx.trace is None or not ctx.peaks:
        return None
    device_s = ctx.trace.kernel_seconds(names)
    if device_s <= 0:
        return None
    t = ctx.split
    calls = family_calls(ctx.config, family, lanes=ctx.lanes,
                         batch=ctx.batch, n_valid=t["n_valid"],
                         n_test=t["n_test"], **ctx.traced)
    least = sum(k * least_seconds(f, b, ctx.peaks) for (f, b), k in calls)
    return 100.0 * least / device_s
