"""The fused decoder recurrence, forward: the CUDA kernel's wrapper and
its plain PyTorch version (port of the decoder half of
``ops/pallas_lstm.py``).

``decoder_lstm_fwd`` launches ``csrc/decoder_lstm_fwd.cu`` for a CUDA
tensor and runs ``decoder_lstm_plain`` for a CPU tensor; there is no
other route. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from factorized_tpu_torch.ops import _build
from factorized_tpu_torch.ops.lstm import lstm_step

LAUNCHES = 0
ROWS = 4      # batch rows per block
THREADS = 160


def _check(h0, c0, wsum, b, t, h_dims):
    if h0.dim() != 2:
        raise ValueError(f"h0 must be (n, H), got {tuple(h0.shape)}")
    n, H = h0.shape
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    if sum(h_dims) != H:
        raise ValueError(f"h_dims {list(h_dims)} do not sum to H = {H}")
    want = {"h0": (n, H), "c0": (n, H), "wsum": (H, 4 * H), "b": (4 * H,)}
    for name, tensor in (("h0", h0), ("c0", c0), ("wsum", wsum), ("b", b)):
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if tensor.device != h0.device:
            raise ValueError(f"{name} is on {tensor.device}, h0 on "
                             f"{h0.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape, ok = tuple(tensor.shape), want[name]
        if shape != ok and not (name == "b" and shape == (1,) + ok):
            raise ValueError(f"{name} must be {ok}, got {shape}")


def decoder_lstm_fwd(h0, c0, wsum, b, t: int, h_dims):
    """From the state ``(h0, c0)`` after the latent-driven step 0, run
    t - 1 steps of ``gates = h @ wsum + b`` over the fused cells
    ``h_dims``. Returns ``(allh, allc, gates)``: (t, n, H), (t, n, H) and
    (t, n, 4H), slot 0 holding (h0, c0) and zero gates."""
    _check(h0, c0, wsum, b, t, h_dims)
    if h0.device.type == "cpu":
        return decoder_lstm_plain(h0, c0, wsum, b, t)
    if h0.device.type != "cuda":
        raise ValueError(f"no kernel for device {h0.device}")
    return _launch(h0, c0, wsum, b, t, h_dims)


def decoder_lstm(h0, c0, wsum, b, t: int, h_dims):
    """All hidden states (t, n, H); ``allh[0] == h0``."""
    return decoder_lstm_fwd(h0, c0, wsum, b, t, h_dims)[0]


def _launch(h0, c0, wsum, b, t, h_dims):
    global LAUNCHES
    n, H = h0.shape
    fn = _build.kernel(
        "decoder_lstm_fwd",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    allh = torch.empty((t, n, H), dtype=torch.float32, device=h0.device)
    allc = torch.empty((t, n, H), dtype=torch.float32, device=h0.device)
    gates = torch.empty((t, n, 4 * H), dtype=torch.float32, device=h0.device)
    dims = (ctypes.c_int * len(h_dims))(*h_dims)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(h0.data_ptr(), c0.data_ptr(), wsum.data_ptr(), b.data_ptr(),
                 allh.data_ptr(), allc.data_ptr(), gates.data_ptr(),
                 t, n, H, len(h_dims), dims, ROWS, THREADS, stream)
    _build.check(err, "decoder_lstm_fwd")
    LAUNCHES += 1
    return allh, allc, gates


def decoder_lstm_plain(h0, c0, wsum, b, t: int):
    """The same function as the kernel in plain PyTorch: the scan branch
    of the JAX package's ``fused_decoder_scan`` as a Python loop, keeping
    the gates the kernel writes."""
    b = b.reshape(-1)
    allh, allc, gates = [h0], [c0], [h0.new_zeros((h0.shape[0], b.numel()))]
    h, c = h0, c0
    for _ in range(t - 1):
        g = h @ wsum + b
        h, c = lstm_step(c, g)
        allh.append(h)
        allc.append(c)
        gates.append(g)
    return torch.stack(allh), torch.stack(allc), torch.stack(gates)
