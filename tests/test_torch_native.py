"""The port's C++ data-path loops (``factorized_tpu_torch/native.py``,
``csrc/segavg.cpp``), built here with the host compiler, on the CPU.

``segment_average`` equals its numpy version (``data/segavg.py``) bit for
bit, and both equal the JAX package's ``factorized_tpu.native``, on word
windows of every kind (empty, reversed, clipped at either end, over NaN,
-inf and +inf rows); ``pad_truncate_batch`` equals the port's padding
(``data/synthetic.pad_dict_segment``) with NaN set to 0 and the clip, and
maps +-inf to +-3.4e38 as the C++ does (numpy's ``nan_to_num`` gives the
float32 maximum); a failed build raises naming the compiler and its
output, with no fall back to numpy; the library sits under
``build/factorized_tpu_torch/`` apart from the kernels' (whose hash
covers ``csrc/*.cu*`` only).

The JAX package's library is compiled for this module from its own
``native/segavg.cpp`` with its Makefile's flags (``jax_segavg``), so the
comparison never reads the numpy fall back that ``factorized_tpu.native``
takes where its own build of ``native/libsegavg.so`` is missing or was
half written by another process."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from factorized_tpu import native as jax_native
from factorized_tpu_torch import native
from factorized_tpu_torch.data.segavg import segment_average
from factorized_tpu_torch.data.synthetic import pad_dict_segment
from factorized_tpu_torch.ops import _build


def _windows(seed, n=900, dim=43, words=120):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    feats[rng.integers(0, n, 3)] = np.nan
    feats[rng.integers(0, n, 3), rng.integers(0, dim, 3)] = -np.inf
    feats[rng.integers(0, n, 2), rng.integers(0, dim, 2)] = np.inf
    starts = np.sort(rng.integers(0, n, words)).astype(np.int64)
    ends = starts + rng.integers(1, 30, words)
    ends[:4] = starts[:4]                      # empty
    ends[4:6] = starts[4:6] - 3                # reversed
    starts[6], ends[-1] = -5, n + 17           # clipped at either end
    for w, value in ((7, np.inf), (8, np.nan), (9, -np.inf)):
        starts[w], ends[w] = 90 * w, 90 * w + 10
        rows = slice(starts[w], ends[w])
        feats[rows] = rng.standard_normal(feats[rows].shape)
        feats[starts[w], 0] = value             # a window over one of each
    return feats, starts, ends


def _bits(a):
    return a.view(np.uint32)


# native/Makefile's CXXFLAGS
JAX_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


@pytest.fixture(scope="module")
def jax_segavg(tmp_path_factory):
    """``factorized_tpu.native`` loading a library compiled here from the
    JAX package's ``native/segavg.cpp`` (written under a temporary name,
    then renamed), its state put back afterwards."""
    src = os.path.join(os.path.dirname(jax_native._LIB_PATH), "segavg.cpp")
    out = tmp_path_factory.mktemp("jax_native") / "libsegavg.so"
    part = out.with_name(out.name + f".{os.getpid()}.part")
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, *JAX_CXXFLAGS, "-o", str(part), src], check=True,
                   capture_output=True, timeout=120)
    os.replace(part, out)
    saved = jax_native._LIB_PATH, jax_native._lib
    jax_native._LIB_PATH, jax_native._lib = str(out), None
    try:
        assert jax_native.available()
        yield jax_native
    finally:
        jax_native._LIB_PATH, jax_native._lib = saved


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_segment_average_is_the_numpy_and_jax_versions(seed,
                                                           jax_segavg):
    feats, starts, ends = _windows(seed)
    got = native.segment_average(feats, starts, ends)
    plain = segment_average(feats, starts, ends)
    assert got.dtype == plain.dtype == np.float32
    assert got.shape == (len(starts), feats.shape[1])
    assert np.array_equal(_bits(got), _bits(plain))
    assert np.array_equal(_bits(got), _bits(
        jax_segavg.segment_average(feats, starts, ends)))
    assert got[7, 0] == np.inf and got[8, 0] == got[9, 0] == 0.0
    assert not np.isnan(got).any()
    assert not got[:6].any()                   # empty and reversed: zeros


@pytest.mark.parametrize("left_pad,clip,nan_to_num", [
    (True, None, False), (False, 2.5, False), (True, 1.0, True),
    (False, None, True)])
def test_pad_truncate_batch_is_the_ports_padding(left_pad, clip,
                                                  nan_to_num):
    rng = np.random.default_rng(3)
    segments = [rng.standard_normal((n, 7)).astype(np.float32)
                for n in (0, 1, 5, 12, 30)]
    segments[2][1, 3] = np.nan
    segments[3][4, 0] = np.inf
    segments[3][6, 2] = -np.inf
    got = native.pad_truncate_batch(segments, 12, left_pad, clip,
                                    nan_to_num)
    side = "left" if left_pad else "right"
    want = np.stack([pad_dict_segment(s, 12, side, 7) for s in segments])
    if nan_to_num:
        want = np.where(np.isnan(want), 0.0, want)
        want = np.where(np.isinf(want), np.sign(want) * np.float32(3.4e38),
                        want).astype(np.float32)
    if clip:
        want = np.clip(want, -clip, clip)
    assert got.shape == (5, 12, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if not clip and not nan_to_num:
        np.testing.assert_array_equal(got, jax_native.pad_truncate_batch(
            segments, 12, left_pad))


def test_a_failed_build_raises_naming_the_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ("-fno-such-option",))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed") as e:
        native.segment_average(*_windows(0))
    assert native.compiler() in str(e.value)
    assert not list(tmp_path.glob("*.so"))


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="c\\+\\+ or g\\+\\+"):
        native.segment_average(*_windows(0))


def test_the_library_is_apart_from_the_kernels():
    path = native.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libftt_segavg_") and path.suffix == ".so"
    assert native.SOURCE.suffix == ".cpp"
    assert native.SOURCE not in _build.sources()
    assert native.SOURCE.name not in [p.name for p in
                                      _build.CSRC.glob("*.cu*")]
    native.load_library()
    assert path.exists()
