"""The port's real CMU-MOSI reader against the JAX package's, on a
fabricated data root in the real files' layout (the port's
``data.mosi.fabricate_root``, the JAX package's
``tests/test_real_mosi_pipeline.py`` fixture): the six arrays of
``get_data`` equal bit for bit for feature selection 1 and 0, with and
without the covarep normalisation, and on the synthetic set; the word
windows' average equals ``factorized_tpu.native.segment_average`` bit for
bit (empty, NaN and -inf windows included)."""

import numpy as np
import pytest

from factorized_tpu import native
from factorized_tpu.data import mosi as jax_mosi
from factorized_tpu.data import synthetic as jax_synthetic
from factorized_tpu_torch.data import mosi, synthetic
from factorized_tpu_torch.data.segavg import segment_average


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return mosi.fabricate_root(str(tmp_path_factory.mktemp("mosi_root")))


def _same(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("fs", [1, 0])
def test_get_data_on_the_real_files_is_the_jax_packages(root, fs,
                                                        normalize):
    got = mosi.get_data(20, bool(fs), root, normalize)
    _same(got, jax_mosi.get_data(20, bool(fs), root, normalize))
    assert got[0].shape == (52, 20, 325 if fs else 377)
    assert got[2].shape[0] == 10 and got[4].shape[0] == 8
    assert np.isfinite(got[0]).all()


def test_get_data_cuts_and_pads_as_the_jax_package(root):
    """A seqlength below the longest segment (truncation keeping the last
    words) and one above it (left padding)."""
    for t in (3, 7):
        _same(mosi.get_data(t, True, root), jax_mosi.get_data(t, True, root))


def test_get_data_without_a_root_is_the_synthetic_set():
    _same(mosi.get_data(20, True, "/nonexistent/mosi"),
          jax_mosi.get_data(20, True, "/nonexistent/mosi"))
    _same(mosi.get_data(20, False), jax_mosi.get_data(20, False))


def test_input_dims_are_the_jax_packages():
    for fs in (True, False):
        assert mosi.input_dims(fs) == jax_mosi.input_dims(fs)


def test_pad_segments_pads_either_side_as_the_jax_package():
    segs = synthetic.synthetic_segments(5, seed=3, max_len=9)
    for side in ("left", "right"):
        got = synthetic.pad_segments(segs, 6, side=side)
        want = jax_synthetic.pad_segments(segs, 6, side=side)
        for k in ("facet", "covarep", "text", "lengths", "label"):
            np.testing.assert_array_equal(got[k], want[k])


WINDOWS = {
    "plain": ([0, 3, 10], [3, 9, 30]),
    "empty": ([4, 7, 50, -5], [4, 2, 60, -1]),
    "clipped": ([-3, 35], [2, 80]),
    "nan_and_neginf": ([0, 1, 2, 5], [2, 3, 6, 8]),
    "long": ([0], [40]),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_segment_average_is_the_native_kernels(case):
    """Frames with a NaN, a -inf and a +inf: only the windows whose mean
    they reach are touched (NaN and -inf zeroed, +inf kept)."""
    rng = np.random.default_rng(len(case))
    feats = rng.normal(size=(40, 7)) * 10
    feats[1, 2] = np.nan
    feats[2, 4] = -np.inf
    feats[6, 5] = np.inf
    starts, ends = (np.array(v) for v in WINDOWS[case])
    got = segment_average(feats, starts, ends)
    want = native.segment_average(feats, starts, ends)
    assert got.dtype == np.float32 and got.shape == (len(starts), 7)
    np.testing.assert_array_equal(got, want)
    empty = np.minimum(ends, 40) <= np.maximum(starts, 0)
    assert (got[empty] == 0).all()
    assert not np.isnan(got).any() and not np.isneginf(got).any()
