"""Build the CUDA sources under ``csrc/`` at first use and load them.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, under ``build/factorized_tpu_torch/``
at the repository root, named by a hash of the sources and flags; a
library whose hash matches is reused. It is loaded with ``ctypes``.
Nothing is compiled or imported when this module is imported, so the
CPU-only tests can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "factorized_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_functions = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libftt_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use and need "
        "the CUDA toolkit (nvcc on PATH or under /usr/local/cuda)")


def _build(path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)  # atomic: no process loads half a file


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' library."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            _lib = ctypes.CDLL(str(path))
        return _lib


def build_log() -> str:
    """What nvcc printed for the loaded library, ``-Xptxas -v`` included."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel(name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` with its types declared. Every launcher
    returns the ``cudaError_t`` of its launch as an int."""
    lib = load_library()
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _functions[name] = fn
        return fn


def check(err: int, name: str):
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        describe = kernel("ftt_error_string", [ctypes.c_int],
                          ctypes.c_char_p)
        raise RuntimeError(
            f"{name} launch failed: cudaError_t {err} "
            f"({describe(err).decode()})")
