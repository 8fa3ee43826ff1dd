"""The fused MFM encode, forward: the CUDA kernel's wrapper and its plain
PyTorch version (port of the eval forward of ``ops/pallas_mfn.py``).

``mfm_encode`` launches ``csrc/mfm_encode_fwd.cu`` for a CUDA tensor and
runs ``mfm_encode_plain`` for a CPU tensor; there is no other route.
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from factorized_tpu_torch.ops import _build

W_NAMES = ("wh", "a1w1", "a1b1", "a1w2", "a1b2", "a2w1", "a2b1",
           "a2w2", "a2b2", "gw1", "gb1", "g1w2", "g1b2", "g2w2", "g2b2")

LAUNCHES = 0
# batch rows per block and threads per block: the fastest pair measured
# at the serving shapes (perf_probe.py, PERF.md)
ROWS = 4
THREADS = 512


def _sizes(weights):
    """(s1, s2, s3, s4, mem): the four MLP widths and the memory width."""
    s3 = weights["g1w2"].shape[0]
    return (weights["a1w1"].shape[1], weights["a2w1"].shape[1], s3,
            weights["gw1"].shape[1] - s3, weights["a2w2"].shape[1])


def _check(xp, weights, z_tot, h_dims):
    if xp.dim() != 3 or xp.shape[2] % 4:
        raise ValueError(f"xp must be (t, n, 4H), got {tuple(xp.shape)}")
    t, n, H4 = xp.shape
    H = H4 // 4
    if sum(h_dims) != H:
        raise ValueError(f"h_dims {list(h_dims)} do not sum to H = {H}")
    prefix = [sum(h_dims[:k]) for k in range(1, len(h_dims))]
    if z_tot not in prefix:
        raise ValueError(f"z_tot {z_tot} is not a cell boundary of {h_dims}")
    s1, s2, s3, s4, mem = _sizes(weights)
    m2 = 2 * (H - z_tot)
    want = {
        "wh": (H, H4), "a1w1": (m2, s1), "a1b1": (s1,), "a1w2": (s1, m2),
        "a1b2": (m2,), "a2w1": (m2, s2), "a2b1": (s2,), "a2w2": (s2, mem),
        "a2b2": (mem,), "gw1": (m2 + mem, s3 + s4), "gb1": (s3 + s4,),
        "g1w2": (s3, mem), "g1b2": (mem,), "g2w2": (s4, mem), "g2b2": (mem,),
    }
    for name, tensor in [("xp", xp)] + [(k, weights[k]) for k in W_NAMES]:
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if tensor.device != xp.device:
            raise ValueError(f"{name} is on {tensor.device}, xp on "
                             f"{xp.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "xp":
            shape = tuple(tensor.shape)
            ok = want[name]
            if shape != ok and not (len(ok) == 1 and shape == (1,) + ok):
                raise ValueError(f"{name} must be {ok}, got {shape}")


def mfm_encode(xp, weights, z_tot: int, h_dims):
    """Fused encode over time, eval mode. ``xp (t, n, 4H)`` gate-major
    input projections of the fused cells (``h_dims``, encoders first, up
    to ``z_tot``); ``weights`` as in ``W_NAMES``, biases ``(1, d)``.
    Returns ``(h_last (n, H), mem_last (n, mem))``."""
    _check(xp, weights, z_tot, h_dims)
    if xp.device.type == "cpu":
        return mfm_encode_plain(xp, weights, z_tot)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    return _launch(xp, weights, z_tot, h_dims)


def _launch(xp, weights, z_tot, h_dims):
    global LAUNCHES
    t, n, H4 = xp.shape
    H = H4 // 4
    s1, s2, s3, s4, mem = _sizes(weights)
    fn = _build.kernel(
        "mfm_encode_fwd",
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 10
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    h_last = torch.empty((n, H), dtype=torch.float32, device=xp.device)
    mem_last = torch.empty((n, mem), dtype=torch.float32, device=xp.device)
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), *[weights[k].data_ptr() for k in W_NAMES],
                 h_last.data_ptr(), mem_last.data_ptr(),
                 t, n, H, z_tot, mem, s1, s2, s3, s4,
                 len(h_dims), dims, ROWS, THREADS, stream)
    _build.check(err, "mfm_encode_fwd")
    LAUNCHES += 1
    return h_last, mem_last


def mfm_encode_plain(xp, weights, z_tot: int):
    """The same function as the kernel in plain PyTorch: the scan branch
    of the JAX package's ``fused_mfm_encode`` as a Python loop."""
    w = weights
    t, n, H4 = xp.shape
    H = H4 // 4
    s1, s2, s3, s4, mem_dim = _sizes(w)
    h = xp.new_zeros((n, H))
    c = xp.new_zeros((n, H))
    mem = xp.new_zeros((n, mem_dim))
    for i in range(t):
        gates = xp[i] + h @ w["wh"]
        ig, fg, gg, og = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(fg) * c + torch.sigmoid(ig) * torch.tanh(gg)
        new_h = torch.sigmoid(og) * torch.tanh(new_c)
        cstar = torch.cat([c[:, z_tot:], new_c[:, z_tot:]], dim=1)
        r1 = torch.relu(cstar @ w["a1w1"] + w["a1b1"])
        att = torch.softmax(r1 @ w["a1w2"] + w["a1b2"], dim=1)
        attended = att * cstar
        r2 = torch.relu(attended @ w["a2w1"] + w["a2b1"])
        chat = torch.tanh(r2 @ w["a2w2"] + w["a2b2"])
        both = torch.cat([attended, mem], dim=1)
        r3 = torch.relu(both @ w["gw1"] + w["gb1"])
        g1 = torch.sigmoid(r3[:, :s3] @ w["g1w2"] + w["g1b2"])
        g2 = torch.sigmoid(r3[:, s3:] @ w["g2w2"] + w["g2b2"])
        mem = g1 * mem + g2 * chat
        h, c = new_h, new_c
    return h, mem
