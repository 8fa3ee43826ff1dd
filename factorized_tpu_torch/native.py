"""The data readers' host loops in C++ (port of ``factorized_tpu/native.py``):
``segment_average``, the word-window mean of the real MOSI reader, and
``pad_truncate_batch``, the padding of the dict datasets' segments.

``csrc/segavg.cpp`` (the port's copy of ``native/segavg.cpp``) is built at
first use with the host C++ compiler, ``c++`` then ``g++`` (the one nvcc
uses), with ``-O2 -std=c++17 -fPIC -shared`` and no ``-march=native`` or
``-ffast-math``, into ``build/factorized_tpu_torch/libftt_segavg_<hash>.so``
at the repository root, named by a hash of the source, the compiler and
its flags, and loaded with ``ctypes``. Nothing is built when this module is
imported.

Where the JAX package's module falls back to numpy when its build fails,
this one raises, naming the compiler and what it printed: the numpy copy
(``data/segavg.py``) loops frame by frame in Python, so a quiet fall back
would make the real reader many times slower without a word. The results
equal ``data/segavg.py``'s bit for bit (each column summed in double in
frame order, times ``1 / (end - start)``, rounded to float32).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "segavg.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "factorized_tpu_torch"
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    """The host C++ compiler: ``c++``, else ``g++``, on PATH."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++ on PATH) to build "
                       f"{SOURCE.name}")


def library_path() -> Path:
    """Where the library of the current source, compiler and flags lives."""
    digest = hashlib.sha256(" ".join((compiler(),) + FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libftt_segavg_{digest.hexdigest()[:16]}.so"


def _build(path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode})"
                           f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)       # atomic: no process loads half a file


def load_library() -> ctypes.CDLL:
    """Build (once per hash) and load the library, its functions typed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i64, c_int = ctypes.c_int64, ctypes.c_int
            lib.segment_average.argtypes = [f32p, i64, i64, i64p, i64p, i64,
                                            f32p]
            lib.segment_average.restype = None
            lib.pad_truncate_batch.argtypes = [
                f32p, i64p, i64p, i64, i64, i64, c_int, ctypes.c_float,
                c_int, f32p]
            lib.pad_truncate_batch.restype = None
            _lib = lib
        return _lib


def segment_average(feats, starts, ends):
    """(n_words, dim) float32 means of ``feats[s:e]`` per (s, e) window,
    clipped to the rows; zeros for an empty window; NaN and -inf set to
    zero where a mean reaches them (``data/segavg.py``'s contract)."""
    feats = np.ascontiguousarray(feats, np.float32)
    if feats.ndim != 2:
        raise ValueError(f"feats must be (frames, dim), got {feats.shape}")
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    if starts.shape != ends.shape or starts.ndim != 1:
        raise ValueError(f"starts {starts.shape} and ends {ends.shape} must "
                         f"be one window each")
    out = np.empty((len(starts), feats.shape[1]), np.float32)
    load_library().segment_average(feats, feats.shape[0], feats.shape[1],
                                   starts, ends, len(starts), out)
    return out


def pad_truncate_batch(segments, max_len, left_pad, clip=None,
                       nan_to_num=False):
    """(n, max_len, dim) float32 of (len_i, dim) ``segments``: zeros
    before (``left_pad``) or after a short one, the last ``max_len`` rows
    of a long one; then, with ``nan_to_num``, NaN to 0 and +-inf to
    +-3.4e38, and with ``clip``, values clipped to [-clip, clip]."""
    segs = [np.asarray(s, np.float32) for s in segments]
    dim = segs[0].shape[1]
    if any(s.ndim != 2 or s.shape[1] != dim for s in segs):
        raise ValueError("segments must be (len, dim) of one dim")
    lens = np.array([len(s) for s in segs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = np.ascontiguousarray(np.concatenate(segs).reshape(-1, dim))
    out = np.empty((len(segs), max_len, dim), np.float32)
    load_library().pad_truncate_batch(
        flat, offsets, lens, len(segs), dim, max_len, int(bool(left_pad)),
        float(clip or 0.0), int(bool(nan_to_num)), out.reshape(-1))
    return out
