"""Build the CUDA sources under ``csrc/`` at first use and load them.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles
each source for ``sm_90a``; one more links the objects into one shared
library with a plain C interface, under ``build/factorized_tpu_torch/``
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_functions = {}


def define(macro: str, value=None):
    """Build with ``-D<macro>[=<value>]``: ``FTT_PHASE_CLOCKS`` makes the
    chain kernels stamp each phase of each step (``csrc/lstm_common.cuh``)
    for the per-phase probe (``perf_probe.py phases``); ``FTT_*_ROWS``
    overrides a chain's batch rows for the sweep (``perf_probe.py
    rows``). Only before the library is loaded; such a library is a file
    of its own (the flags are in its hash)."""
    global NVCC_FLAGS
    flag = f"-D{macro}" if value is None else f"-D{macro}={value}"
    with _lock:
        if _lib is not None:
            raise RuntimeError("the kernels' library is already loaded")
        if flag not in NVCC_FLAGS:
            NVCC_FLAGS = NVCC_FLAGS + (flag,)


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


def _run_all(cmds, out_stem: Path):
    """Run the commands at once; (exit codes, their joined output). Each
    one's output goes to a file beside the build, so no process waits on
    a full pipe."""
    outs = [out_stem.with_name(f"{out_stem.name}.{k}.out")
            for k in range(len(cmds))]
    try:
        procs = []
        for cmd, out in zip(cmds, outs):
            with open(out, "w") as fh:
                procs.append(subprocess.Popen(cmd, stdout=fh,
                                              stderr=subprocess.STDOUT))
        rcs = [proc.wait() for proc in procs]
        log = "".join(" ".join(cmd) + "\n" + out.read_text()
                      for cmd, out in zip(cmds, outs))
    finally:
        for out in outs:
            out.unlink(missing_ok=True)
    return rcs, log


def _build(path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [path.with_name(f"{stem}.{src.stem}.o") for src in sources()]
    tmp = path.with_name(f"{stem}.tmp.so")
    try:
        rcs, log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(src)] for src, obj in zip(sources(), objs)],
                            path.with_name(stem))
        if any(rcs):
            raise RuntimeError(f"nvcc failed (exit codes {rcs}):\n{log}")
        rcs, link_log = _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                   str(tmp), *map(str, objs)]],
                                 path.with_name(stem))
        log += link_log
        if rcs[0] != 0:
            raise RuntimeError(f"nvcc link failed (exit {rcs[0]}):\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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
