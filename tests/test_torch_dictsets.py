"""The port's MOUD, YouTube and MMMO readers against the JAX package's, bit
for bit: on their synthetic sets (the default, ``data_root`` absent) and
on fabricated roots in the reference's pickle and CSV layouts (those of
``tests/test_real_dictsets.py``: ``mfm_moud.py:40,193-195``,
``mfm_you.py:204``, ``mfm_mmmo.py:35,211``), garbage rows included; and
the synthetic fixtures ``synthetic_dicts``, ``synthetic_segments``'s
label modes and ``pad_dict_segment``. Exact equality throughout, dtypes
included."""

import pickle

import numpy as np
import pytest

from factorized_tpu.data import mmmo as jax_mmmo
from factorized_tpu.data import moud as jax_moud
from factorized_tpu.data import synthetic as jax_synthetic
from factorized_tpu.data import youtube as jax_youtube
from factorized_tpu_torch.data import mmmo, moud, synthetic, youtube

READERS = {"moud": (moud, jax_moud), "you": (youtube, jax_youtube),
           "mmmo": (mmmo, jax_mmmo)}


def _same(got, want):
    assert len(got) == len(want) == 6
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=str(k))


@pytest.mark.parametrize("seqlength", [20, 7])
@pytest.mark.parametrize("name", list(READERS))
def test_synthetic_sets_are_the_jax_packages(name, seqlength):
    port, ref = READERS[name]
    got = port.get_data(seqlength)
    _same(got, ref.get_data(seqlength))
    assert got[0].shape[1:] == (seqlength, 410)
    assert port.INPUT_DIMS == ref.INPUT_DIMS == [300, 74, 36]


# ---------------------------------------------- fabricated real roots

def _dicts(rng, n_videos, segs, vid_fmt="v{:03d}", dims=(300, 74, 36)):
    text, audio, video = {}, {}, {}
    for v in range(n_videos):
        vid = vid_fmt.format(v)
        text[vid], audio[vid], video[vid] = {}, {}, {}
        for s in range(segs):
            sid = str(s + 1)
            L = int(rng.integers(2, 9))
            text[vid][sid] = rng.normal(size=(L, dims[0])).astype(np.float32)
            # a few values past the clip and a NaN, which the readers clip
            # or zero
            audio[vid][sid] = (300.0 * rng.normal(size=(L, dims[1]))
                               ).astype(np.float32)
            video[vid][sid] = rng.normal(size=(L, dims[2])).astype(np.float32)
            video[vid][sid][0, 0] = np.nan
    return text, audio, video


def _dump(root, dicts, names):
    for d, name in zip(dicts, names):
        with open(root / name, "wb") as f:
            pickle.dump(d, f, protocol=2)


def _moud_root(root, csv_order=None, garbage=False):
    rng = np.random.default_rng(0)
    text, audio, video = _dicts(rng, 64, 2, vid_fmt="sp_{:03d}")
    _dump(root, (text, audio, video),
          ("text_dict.p", "audio_dict.p", "video_dict.p"))
    names = ["positive", "negative", "neutral"]
    lines = [f"{vid}_{sid} {names[(v + int(sid)) % 3]}"
             for v, vid in enumerate(text) for sid in text[vid]]
    if garbage:
        lines += ["nounderscore positive", "one_underscore negative", "",
                  "sp_000_9 maybe", "lonelytoken"]
    (root / "cats.txt").write_text("\n".join(lines))
    if csv_order is not None:
        vids = list(text)[::csv_order]
        (root / "spanish_text.csv").write_text("\n".join(
            f"{vid}.mp4_seg_1,x" for vid in vids))


def _youtube_root(root):
    rng = np.random.default_rng(1)
    text, audio, video = _dicts(rng, 40, 2)
    # a scalar segment: zeros of the modality's fallback width
    text["v003"]["2"] = np.float32(0.0)
    _dump(root, (text, audio, video),
          ("text_dict.p", "audio_dict.p", "video_dict.p"))
    rows = [f"{vid},{sid},{(v % 3) - 1}" for v, vid in enumerate(text)
            for sid in text[vid]]
    rows += ["broken", "v001,1,notanumber"]
    (root / "sentimentAnnotations.csv").write_text("\n".join(rows))


def _mmmo_root(root):
    rng = np.random.default_rng(2)
    text, audio, video = _dicts(rng, 266, 1)
    _dump(root, (text, audio, video),
          ("text_dict_s.p", "audio_dict_s.p", "video_dict_s.p"))
    vids = list(text)
    rows = ["link,score,final", f"{vids[0]}.mp4,4.5,garbage",
            f"{vids[1]}.mp4,notanum,alsonot", "justonecell"]
    rows += [f"{vid}.mp4,3.0,{1 + (v % 7)}" for v, vid in
             enumerate(vids[2:])]
    (root / "annotations_full.csv").write_text("\n".join(rows))


ROOTS = {
    "moud": lambda root: _moud_root(root),
    "moud_csv_order": lambda root: _moud_root(root, csv_order=-1),
    "moud_garbage": lambda root: _moud_root(root, csv_order=1, garbage=True),
    "you": _youtube_root,
    "mmmo": _mmmo_root,
}


@pytest.mark.filterwarnings("ignore:MOUD")
@pytest.mark.parametrize("root_kind", list(ROOTS))
def test_real_roots_read_as_the_jax_package_reads_them(root_kind, tmp_path):
    ROOTS[root_kind](tmp_path)
    port, ref = READERS[root_kind.split("_")[0]]
    got = port.get_data(seqlength=5, data_root=str(tmp_path))
    _same(got, ref.get_data(seqlength=5, data_root=str(tmp_path)))
    if root_kind.startswith("moud"):
        # clipped, but its NaNs kept (no nan_to_num in mfm_moud.py)
        assert np.nanmax(np.abs(got[0])) == 255.0
        assert np.isnan(got[0]).any()
    else:
        assert all(np.isfinite(a).all() for a in got)
    if root_kind == "mmmo":
        assert np.abs(got[0]).max() == 255.0


def test_moud_without_its_csv_warns_as_the_jax_package(tmp_path):
    """Pickle dict order in place of the reference's split order is
    warned about."""
    _moud_root(tmp_path)
    with pytest.warns(UserWarning, match="spanish_text.csv"):
        moud.get_data(seqlength=4, data_root=str(tmp_path))


# ---------------------------------------------------- synthetic fixtures

@pytest.mark.parametrize("kw", [
    dict(n_videos=5, label_mode="2", seed=3),
    dict(n_videos=4, label_mode="3", segs_per_video=2, seed=4),
    dict(n_videos=6, label_mode="mmmo", segs_per_video=1, seed=5,
         dims=(7, 4, 3)),
], ids=["2", "3", "mmmo"])
def test_synthetic_dicts_are_the_jax_packages(kw):
    kw = dict(kw)
    n = kw.pop("n_videos")
    got, want = synthetic.synthetic_dicts(n, **kw), \
        jax_synthetic.synthetic_dicts(n, **kw)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for vid in w:
            assert list(g[vid]) == list(w[vid])
            for sid, value in w[vid].items():
                np.testing.assert_array_equal(g[vid][sid], value)
                assert type(g[vid][sid]) is type(value)


@pytest.mark.parametrize("label_mode", ["mosi", "mmmo", "3"])
def test_synthetic_segments_label_modes_are_the_jax_packages(label_mode):
    got = synthetic.synthetic_segments(12, 9, label_mode=label_mode)
    want = jax_synthetic.synthetic_segments(12, 9, label_mode=label_mode)
    assert [s["label"] for s in got] == [s["label"] for s in want]
    for g, w in zip(got, want):
        for k in ("text", "covarep", "facet"):
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("length", [0, 3, 6, 9])
def test_pad_dict_segment_is_the_jax_packages(side, length):
    data = (np.float64(1.5) if length == 0 else
            np.arange(length * 4, dtype=np.float64).reshape(length, 4))
    got = synthetic.pad_dict_segment(data, 6, side, fallback_dim=4)
    want = jax_synthetic.pad_dict_segment(data, 6, side, fallback_dim=4)
    assert got.dtype == want.dtype == np.float32 and got.shape == (6, 4)
    np.testing.assert_array_equal(got, want)
