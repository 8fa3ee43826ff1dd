"""The benchmark's MOSI data: the port's synthetic segments, in MOSI's
shape, the same arrays from the same seed, other arrays from another."""

import numpy as np

from tiny import ROOT  # noqa: F401

from portbench.harness import data


def test_segments_are_the_ports():
    from factorized_tpu_torch.data import synthetic

    ours = data._segments(20, np.random.default_rng(5), data._embedding(300),
                          data._readout((300, 5, 20)), 40)
    theirs = synthetic.synthetic_segments(20, 5)
    for (text, cov, fac, label), s in zip(ours, theirs):
        np.testing.assert_array_equal(text, s["text"])
        np.testing.assert_array_equal(cov, s["covarep"])
        np.testing.assert_array_equal(fac, s["facet"])
        assert label == s["label"]


def test_shapes_and_seeds():
    a = data.mosi_arrays(2**31 + 3, 40, 12, 14)
    b = data.mosi_arrays(2**31 + 3, 40, 12, 14)
    c = data.mosi_arrays(2**31 + 4, 40, 12, 14)
    assert [x.shape for x in a[::2]] == [(40, 20, 325), (12, 20, 325),
                                        (14, 20, 325)]
    assert all(x.dtype == np.float32 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert np.abs(a[1]).max() <= 3.0
