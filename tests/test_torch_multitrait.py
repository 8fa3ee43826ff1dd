"""The port's multi-trait reader and score against the JAX package's.

- ``data/multitrait.get_data``: the arrays of both styles (``pom``, 17
  traits, left-padded; ``iemocap``, 4 traits, right-padded) equal the
  JAX package's bit for bit, with their dtypes, on the synthetic sets and
  on a fabricated root of the reference's pickled dicts and a
  ``trait_annotations.csv`` (segments without a label, a video the CSV
  does not list, NaN and out-of-range features, file names with an
  extension);
- ``utils/metrics.score_multitrait``: the printed ``mae: [..]``,
  ``corr: [..]`` and ``mult_acc: [..]`` lines and the returned dict equal
  the JAX package's, and the non-finite branch too."""

import csv
import io
import pickle

import numpy as np
import pytest

from factorized_tpu.data import multitrait as jmultitrait
from factorized_tpu.utils import metrics as jmetrics
from factorized_tpu_torch.data import multitrait
from factorized_tpu_torch.utils import metrics

STYLES = ("pom", "iemocap")


def _same_arrays(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_constants_equal_the_jax_module():
    assert multitrait.INPUT_DIMS == jmultitrait.INPUT_DIMS == [300, 74, 36]
    assert multitrait.POM_TRAITS == jmultitrait.POM_TRAITS
    assert multitrait.IEMOCAP_TRAITS == jmultitrait.IEMOCAP_TRAITS
    assert multitrait.STYLES == jmultitrait.STYLES
    assert (multitrait.POM_REPORT_INDICES, multitrait.IEMOCAP_REPORT_INDICES
            ) == (jmultitrait.POM_REPORT_INDICES,
                  jmultitrait.IEMOCAP_REPORT_INDICES)


@pytest.mark.parametrize("style", STYLES)
def test_synthetic_sets_equal_the_jax_reader(style):
    got = multitrait.get_data(6, style=style)
    _same_arrays(got, jmultitrait.get_data(6, style=style))
    n_traits = len(multitrait.STYLES[style]["traits"])
    assert got[1].shape[1] == n_traits and got[0].shape[1:] == (6, 410)


def _fabricate(root, n_traits, seed=0):
    """The reference's three pickled dicts and a trait CSV: 14 videos of
    one to three segments (only segment "1" labelled), the last video
    missing from the CSV, NaN and values past 255 among the features."""
    rng = np.random.default_rng(seed)
    dicts = ({}, {}, {})
    rows = []
    for v in range(14):
        vid = f"clip_{v:02d}"
        segments = [str(s) for s in range(1, 1 + int(rng.integers(1, 4)))]
        for d, width in zip(dicts, (300, 74, 36)):
            d[vid] = {}
            for s in segments:
                a = rng.normal(size=(int(rng.integers(2, 12)), width))
                a[0, 0] = np.nan if v % 3 == 0 else 400.0
                d[vid][s] = a.astype(np.float32)
        if v < 13:
            rows.append([f"{vid}.mp4", *np.round(
                rng.uniform(1, 7, size=n_traits), 3)])
    for name, d in zip(("text_dict_s.p", "audio_dict_s.p",
                        "video_dict_s.p"), dicts):
        with open(root / name, "wb") as f:
            pickle.dump(d, f)
    with open(root / "trait_annotations.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video", *(f"t{i}" for i in range(n_traits))])
        w.writerows(rows)


@pytest.mark.parametrize("style", STYLES)
def test_a_fabricated_root_reads_as_the_jax_reader(style, tmp_path):
    n_traits = len(multitrait.STYLES[style]["traits"])
    _fabricate(tmp_path, n_traits)
    got = multitrait.get_data(5, data_root=str(tmp_path), style=style)
    _same_arrays(got, jmultitrait.get_data(5, data_root=str(tmp_path),
                                           style=style))
    X = np.concatenate(got[0::2])
    assert np.isfinite(X).all() and np.abs(X).max() <= 255.0
    # one labelled segment a video, 13 videos in the CSV
    assert sum(len(a) for a in got[1::2]) == 13


@pytest.mark.parametrize("finite", [True, False], ids=["scored", "diverged"])
def test_score_multitrait_prints_the_jax_lines(finite):
    rng = np.random.default_rng(3)
    y = np.round(rng.uniform(1, 7, size=(30, 17)), 2).astype(np.float32)
    p = (y + rng.normal(0, 0.8, size=y.shape)).astype(np.float32)
    if not finite:
        p[4, 2] = np.nan
    got, want = io.StringIO(), io.StringIO()
    m = metrics.score_multitrait(p, y, out=got)
    mj = jmetrics.score_multitrait(p, y, out=want)
    assert got.getvalue() == want.getvalue()
    assert list(m) == ["mae", "corr", "mult_acc"]
    np.testing.assert_array_equal(np.array(list(m.values())),
                                  np.array(list(mj.values())))
    if finite:
        assert got.getvalue().splitlines()[0].startswith("mae: [")
