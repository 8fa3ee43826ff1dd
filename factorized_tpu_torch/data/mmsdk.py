"""CMU-MultimodalSDK adapter (port of ``factorized_tpu/data/mmsdk.py``):
the computational-sequence (``.csd``) HDF5 files, the public route to the
paper's data that the reference's README points users to.

``.csd`` layout (h5py)::

    <root>/data/<segment_id>/features   (n, d) float
    <root>/data/<segment_id>/intervals  (n, 2) float seconds
    <root>/metadata/...

where ``segment_id`` is ``"<video_id>[<segment_index>]"``.

The pipeline, in three parts so that everything below the read runs
without h5py:

- ``read_csd``, the one function that touches h5py (imported there, and
  a missing h5py is an error that says so): a file ->
  ``{segment_id: (features, intervals)}``;
- ``align_segments``: the four sequences' dicts -> ``{video_id:
  [segment, ...]}``; the text sequence (300-d word vectors with their
  intervals) is the word timeline, audio and visual rows are averaged
  over each word's interval (``align_to_words``, non-finite values
  zeroed, an empty window zeros, as ``data_loader.py:62-101``), one label
  a segment (column 0, or with ``label_mode="vector"`` every column),
  a segment missing a modality filled with zeros of the set's width;
- ``split_arrays``: videos sorted by id and split 52/10/rest on MOSI's
  93 videos, in the same proportions on any other count, or as ``split``
  says (``data_loader.py:118-128``); segments left-padded or cut to their
  last ``seqlength`` words (``data_loader.py:139-152``); visual features
  max-abs normalised by train statistics (``mfm_mosi.py:94-103``), audio
  too with ``normalize_covarep`` (``mfm_mosi.py:181-191``).

``get_data`` runs the three and caches the arrays on disk under
``<data_root>/.factorized_cache``, keyed by each file's size and mtime
and every argument, in the JAX package's format.

numpy throughout, float32 out of a float64 alignment: the arrays equal
the JAX package's bit for bit.
"""

from __future__ import annotations

import hashlib
import os
import re
from collections import defaultdict

import numpy as np

from factorized_tpu_torch.data.batcher import compute_train_max

# the SDK's release file names for CMU-MOSI; ``files=`` overrides them
DEFAULT_FILES = {
    "text": "CMU_MOSI_TimestampedWordVectors.csd",
    "audio": "CMU_MOSI_COVAREP.csd",
    "visual": "CMU_MOSI_Visual_Facet_41.csd",
    "labels": "CMU_MOSI_Opinion_Labels.csd",
}

# CMU-MOSEI: its labels carry 7 columns (sentiment and 6 emotion
# intensities), the multi-trait path
MOSEI_FILES = {
    "text": "CMU_MOSEI_TimestampedWordVectors.csd",
    "audio": "CMU_MOSEI_COVAREP.csd",
    "visual": "CMU_MOSEI_VisualFacet42.csd",
    "labels": "CMU_MOSEI_Labels.csd",
}
MOSEI_TRAITS = ["sentiment", "happy", "sad", "anger", "surprise",
                "disgust", "fear"]

# POM (speaker traits): one label column a trait, in the order of
# data/multitrait.py's POM_TRAITS (17 columns)
POM_FILES = {
    "text": "POM_TimestampedWordVectors.csd",
    "audio": "POM_COVAREP.csd",
    "visual": "POM_Facet_42.csd",
    "labels": "POM_Labels.csd",
}

SEQLENGTH = 20

# the reference's MOSI split: 52 train / 10 valid / 31 test videos of 93
# (data_loader.py:122-124)
MOSI_N_VIDEOS = 93
MOSI_SPLIT = (52, 10)

_SEG_RE = re.compile(r"^(.*)\[(\d+)\]$")


class SdkSplits(tuple):
    """The six arrays ``(X_train, y_train, X_valid, y_valid, X_test,
    y_test)``, unpacking as the other readers' tuples do, with
    ``input_dims`` ([text, audio, visual] widths, known once the files
    are read) as an attribute."""

    input_dims: list

    def __new__(cls, arrays, input_dims):
        obj = super().__new__(cls, arrays)
        obj.input_dims = list(input_dims)
        return obj


def read_csd(path):
    """A ``.csd`` file -> {segment_id: (features (n, d) float32, intervals
    (n, 2) float64)}. Raises where h5py is not installed, the file has no
    or several root sequences, or no segment."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"mmsdk.read_csd reads .csd (HDF5) files through h5py, which "
            f"is not installed; cannot read {path}") from e

    out = {}
    with h5py.File(path, "r") as f:
        roots = list(f.keys())
        if not roots:
            raise ValueError(f"empty csd file: {path}")
        if len(roots) != 1:
            # an SDK file holds exactly one computational sequence
            raise ValueError(
                f"csd file {path} has {len(roots)} root groups "
                f"({sorted(roots)}); expected exactly one computational "
                "sequence - the file is malformed or concatenated")
        data = f[roots[0]]["data"]
        for seg_id in data:
            grp = data[seg_id]
            out[seg_id] = (np.asarray(grp["features"], np.float32),
                           np.asarray(grp["intervals"], np.float64))
    if not out:
        raise ValueError(f"csd has no segments: {path}")
    return out


def split_segment_id(seg_id):
    """``"2iD-tVS8NPw[3]"`` -> ``("2iD-tVS8NPw", 3)``."""
    m = _SEG_RE.match(seg_id)
    if not m:
        return seg_id, 0
    return m.group(1), int(m.group(2))


def align_to_words(word_intervals, feats, feat_intervals):
    """The mean of the feature rows overlapping each word's interval: one
    (n_words, n_rows) overlap mask and one product. Empty windows give
    zeros and non-finite values are zeroed."""
    feats = np.nan_to_num(feats, nan=0.0, posinf=0.0, neginf=0.0)
    if feats.size == 0:
        return np.zeros((len(word_intervals), feats.shape[1] or 0),
                        np.float32)
    w_s = word_intervals[:, 0:1]
    w_e = word_intervals[:, 1:2]
    f_s = feat_intervals[None, :, 0]
    f_e = feat_intervals[None, :, 1]
    mask = ((f_e > w_s) & (f_s < w_e)).astype(np.float32)
    counts = mask.sum(axis=1, keepdims=True)
    sums = mask @ feats
    return np.where(counts > 0, sums / np.maximum(counts, 1.0),
                    0.0).astype(np.float32)


def _pad_keep_last(arr, t):
    """Left-pad with zeros, or keep the last t rows."""
    n = arr.shape[0]
    if n >= t:
        return arr[n - t:]
    out = np.zeros((t,) + arr.shape[1:], arr.dtype)
    out[t - n:] = arr
    return out


def _files(files):
    f = dict(DEFAULT_FILES)
    if files:
        f.update(files)
    return f


def load_segments(data_root, files=None, label_mode="scalar"):
    """Read the four sequences under ``data_root`` (``read_csd``) and
    align them (``align_segments``)."""
    f = _files(files)

    def path(kind):
        p = os.path.join(data_root, f[kind])
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"missing {kind} csd: {p} — point --data-root at a "
                f"directory of CMU-MultimodalSDK .csd files (defaults: "
                f"{sorted(DEFAULT_FILES.values())})")
        return p

    return align_segments(read_csd(path("text")), read_csd(path("audio")),
                          read_csd(path("visual")), read_csd(path("labels")),
                          label_mode=label_mode)


def align_segments(text, audio, visual, labels, label_mode="scalar"):
    """The four sequences' ``{segment_id: (features, intervals)}`` ->
    ``{video_id: [{text, covarep, facet, label, length}, ...]}`` in
    segment order. A segment without a label is dropped. ``label_mode``
    "scalar" takes column 0 of the label features (the sentiment; the
    mean over rows where a segment has several), "vector" every column
    (MOSEI's sentiment and emotions, POM's traits)."""
    by_vid = defaultdict(list)
    for seg_id, (wvecs, w_iv) in text.items():
        if seg_id not in labels:
            continue
        lab_feats, _ = labels[seg_id]
        lab = np.asarray(lab_feats, np.float64).reshape(
            np.asarray(lab_feats).shape[0], -1)
        if label_mode == "vector":
            label = lab.mean(axis=0).astype(np.float32)
        else:
            label = float(lab[:, 0].mean())
        seg = {"text": wvecs, "label": label, "length": wvecs.shape[0]}
        for kind, src in (("covarep", audio), ("facet", visual)):
            if seg_id in src:
                fts, f_iv = src[seg_id]
                seg[kind] = align_to_words(w_iv, fts, f_iv)
            else:
                seg[kind] = None
        vid, idx = split_segment_id(seg_id)
        by_vid[vid].append((idx, seg))

    # a segment missing a modality: zeros of the width the others carry
    widths = {}
    for kind in ("covarep", "facet"):
        widths[kind] = next((seg[kind].shape[1] for segs in by_vid.values()
                             for _, seg in segs if seg[kind] is not None),
                            None)
        if widths[kind] is None:
            raise ValueError(f"no segment carries {kind} features")
    for segs in by_vid.values():
        for _, seg in segs:
            for kind in ("covarep", "facet"):
                if seg[kind] is None:
                    seg[kind] = np.zeros((seg["length"], widths[kind]),
                                         np.float32)
    return {vid: [s for _, s in sorted(segs, key=lambda x: x[0])]
            for vid, segs in by_vid.items()}


def _stack_split(videos, seqlength):
    text, cov, fac, labels = [], [], [], []
    for _, segs in videos:
        for seg in segs:
            text.append(_pad_keep_last(seg["text"], seqlength))
            cov.append(_pad_keep_last(seg["covarep"], seqlength))
            fac.append(_pad_keep_last(seg["facet"], seqlength))
            labels.append(seg["label"])
    return (np.stack(text), np.stack(cov), np.stack(fac),
            np.asarray(labels, np.float32))


def _cache_path(data_root, kind_paths, seqlength, label_mode, split,
                normalize_covarep):
    """The cache file of the arrays: a hash of each file's (kind, name,
    size, mtime_ns), so that the same files bound to other modalities do
    not collide, and of every argument that changes the arrays."""
    h = hashlib.sha256()
    for kind in sorted(kind_paths):
        p = kind_paths[kind]
        st = os.stat(p)
        h.update(f"{kind}={os.path.basename(p)}:{st.st_size}:"
                 f"{st.st_mtime_ns};".encode())
    h.update(f"{seqlength}|{label_mode}|{split}|"
             f"{normalize_covarep}|v1".encode())
    return os.path.join(data_root, ".factorized_cache",
                        h.hexdigest()[:20] + ".npz")


def split_arrays(by_vid, seqlength=SEQLENGTH, split=None,
                 normalize_covarep=False):
    """``align_segments``' videos -> ``SdkSplits``: sorted by id, split
    (by default MOSI's 52/10 on its 93 videos, the same shares on any
    other count, at least one video each), stacked, the visual block (and
    with ``normalize_covarep`` the audio block) divided by its train
    max-abs, concatenated [text | audio | visual] as float32."""
    vids = sorted(by_vid.items(), key=lambda kv: kv[0])
    if split is None and len(vids) == MOSI_N_VIDEOS:
        split = MOSI_SPLIT
    elif split is None:
        split = (max(1, int(len(vids) * MOSI_SPLIT[0] / MOSI_N_VIDEOS)),
                 max(1, int(len(vids) * MOSI_SPLIT[1] / MOSI_N_VIDEOS)))
    n_tr, n_va = split
    if len(vids) <= n_tr + n_va:
        raise ValueError(
            f"only {len(vids)} videos but split={split} needs more — "
            f"pass split=(n_train, n_valid) sized for this dataset")
    parts = [_stack_split(v, seqlength) for v in
             (vids[:n_tr], vids[n_tr:n_tr + n_va], vids[n_tr + n_va:])]
    fa_max = compute_train_max(parts[0][2])
    co_max = compute_train_max(parts[0][1]) if normalize_covarep else None
    arrays, dims = [], None
    for te, co, fa, y in parts:
        fa = fa / fa_max
        if co_max is not None:
            co = co / co_max
        arrays += [np.concatenate([te, co, fa], axis=2).astype(np.float32),
                   y]
        dims = dims or [te.shape[2], co.shape[2], fa.shape[2]]
    return SdkSplits(tuple(arrays), input_dims=dims)


def get_data(seqlength: int = SEQLENGTH, data_root=None, files=None,
             split=None, normalize_covarep: bool = False,
             label_mode: str = "scalar", cache: bool = True):
    """-> ``SdkSplits`` (X_train, y_train, X_valid, y_valid, X_test,
    y_test), X batch-major (n, t, text + audio + visual), the contract of
    ``data.mosi.get_data``; with ``label_mode="vector"`` each y is (n,
    n_traits) (MOSEI: ``files=MOSEI_FILES``, POM: ``files=POM_FILES``).
    ``split=(n_train_videos, n_valid_videos)``, the rest test (default:
    ``split_arrays``'). ``cache``: read and write the arrays under
    ``<data_root>/.factorized_cache`` (a corrupt entry is rebuilt)."""
    if not data_root or not os.path.isdir(data_root):
        raise FileNotFoundError(
            "mosi_sdk needs --data-root pointing at CMU-MultimodalSDK "
            ".csd files (public download; see DEFAULT_FILES)")
    cache_file = None
    if cache:
        kind_paths = {k: os.path.join(data_root, v)
                      for k, v in _files(files).items()}
        if all(os.path.exists(p) for p in kind_paths.values()):
            cache_file = _cache_path(data_root, kind_paths, seqlength,
                                     label_mode, split, normalize_covarep)
            if os.path.exists(cache_file):
                try:
                    z = np.load(cache_file)
                    return SdkSplits(
                        tuple(z[k] for k in ("X_train", "y_train", "X_valid",
                                             "y_valid", "X_test", "y_test")),
                        input_dims=z["input_dims"].tolist())
                except Exception:
                    try:
                        os.remove(cache_file)
                    except OSError:
                        pass

    by_vid = load_segments(data_root, files, label_mode=label_mode)
    out = split_arrays(by_vid, seqlength, split, normalize_covarep)
    if cache_file is not None:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        # a file of this process's own, then one atomic rename: processes
        # building the same entry never interleave their writes
        tmp = f"{cache_file}.{os.getpid()}.tmp"
        np.savez(tmp, X_train=out[0], y_train=out[1], X_valid=out[2],
                 y_valid=out[3], X_test=out[4], y_test=out[5],
                 input_dims=np.asarray(out.input_dims))
        os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", cache_file)
    return out
