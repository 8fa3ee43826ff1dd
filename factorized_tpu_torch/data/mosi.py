"""CMU-MOSI adapter (port of ``factorized_tpu/data/mosi.py``).

The real pipeline (``data_loader.py`` + ``mfm_mosi.py:41-126``):

- the truth CSV gives each video's segments, their sentiment and time
  bounds (``data_loader.py:51-59``);
- word-aligned transcript rows (``data_loader.py:104-115``);
- FACET visual features averaged over each word's frame window at 30 fps
  (``data_loader.py:62-80``), COVAREP audio at 100 Hz with NaN and -inf
  zeroed (``data_loader.py:83-101``), through ``native.segment_average``
  (C++; ``segavg.segment_average`` is its numpy twin);
- videos sorted by id, split 52 train / 10 valid / the rest test
  (``data_loader.py:118-128``);
- segments left-padded with zeros and truncated keeping the last
  ``seqlength`` words (``data_loader.py:139-152``);
- feature selection by the fs mask (covarep -> 5, facet -> 20;
  ``mfm_mosi.py:60-69``) or the raw covarep columns 1:35;
- facet max-abs normalisation by train statistics (``mfm_mosi.py:94-103``;
  ``get_data_missing`` also normalises covarep, ``mfm_mosi.py:181-191``);
- the frozen 300-d embedding lookup, then the feature-axis concat [text |
  audio | video].

Where ``data_root`` is not a directory, the schema-faithful synthetic
generator supplies the word-level dicts and the same pipeline runs on
them, as in the JAX package. ``fabricate_root`` writes a small root in
the real files' layout, for trying ``--data-root`` without the data.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np

from factorized_tpu_torch.data import synthetic
from factorized_tpu_torch.data.batcher import compute_train_max
from factorized_tpu_torch.native import segment_average

INPUT_DIMS_FS = [300, 5, 20]
SEQLENGTH = 20


# ---------------------------------------------------------- real pipeline

def load_truth(truth_path):
    truth = defaultdict(dict)
    with open(truth_path, newline="") as f:
        for line in f.read().replace("\r\n", "\n").split("\n"):
            if not line:
                continue
            row = line.split(",")
            truth[row[2]][row[3]] = {
                "start_time": float(row[0]),
                "end_time": float(row[1]),
                "sentiment": float(row[4]),
            }
    return truth


def load_transcripts(truth, transcript_dir, word2ix):
    for vid in truth:
        for seg in truth[vid]:
            path = os.path.join(transcript_dir, f"{vid}_{seg}")
            truth[vid][seg]["data"] = []
            with open(path) as f:
                for line in f.read().split("\n"):
                    if not line:
                        continue
                    row = line.split(",")
                    truth[vid][seg]["data"].append({
                        "word_ix": word2ix[row[1]],
                        "word": row[1],
                        "start_time_clip": float(row[4]),
                        "end_time_clip": float(row[5]),
                    })


def _assign_word_averages(truth_vid, feats, rate, field):
    """All of a video's word windows averaged at once, each word's
    average stored under ``field``."""
    words = [w for seg in truth_vid.values() for w in seg["data"]]
    starts = np.array([int(w["start_time_clip"] * rate) for w in words],
                      np.int64)
    ends = np.array([int(w["end_time_clip"] * rate) for w in words],
                    np.int64)
    avgs = segment_average(feats.astype(np.float32), starts, ends)
    for w, a in zip(words, avgs):
        w[field] = a


def load_facet(truth, facet_dir, fps=30):
    """Average FACET rows over each word's frame window. A truncated or
    garbled row (too few columns, a non-number) is skipped; a file with
    no valid row raises, naming it."""
    for vid in truth:
        path = os.path.join(facet_dir, f"{vid}.FACET_out.csv")
        with open(path, newline="") as f:
            lines = [ln for ln in
                     f.read().replace("\r\n", "\n").split("\n")[1:] if ln]
        rows = []
        for ln in lines:
            cells = ln.split(",")
            if len(cells) <= 5:
                continue
            try:
                rows.append([float(x) for x in cells])
            except ValueError:
                continue
        if rows:
            width = max(len(r) for r in rows)
            rows = [r for r in rows if len(r) == width]
        if not rows:
            raise ValueError(f"no valid FACET rows in {path}")
        feats = np.array(rows, dtype=np.float64)[:, 5:]
        _assign_word_averages(truth[vid], feats, fps, "facet")


def load_covarep(truth, covarep_dir, hz=100):
    """Average COVAREP frames (``features`` of each video's .mat) over
    each word's window; zero frames of a known width give zero vectors, a
    matrix with no width raises, naming the file."""
    import scipy.io as sio

    for vid in truth:
        path = os.path.join(covarep_dir, f"{vid}.mat")
        fts = np.asarray(sio.loadmat(path)["features"], np.float64)
        if fts.ndim != 2 or fts.shape[1] == 0:
            raise ValueError(
                f"empty/invalid COVAREP features in {path}: "
                f"shape {fts.shape}")
        _assign_word_averages(truth[vid], fts, hz, "covarep")


def split_videos(truth):
    """Sorted by video id; 52 train, 10 valid, the rest test
    (``data_loader.py:122-124``)."""
    data = sorted(truth.items(), key=lambda kv: kv[0])
    return data[:52], data[52:62], data[62:]


def segments_to_arrays(videos, max_segment_len):
    segs = []
    for _, v in videos:
        for seg in v.values():
            fts = seg["data"]
            segs.append({
                "text": np.array([w["word_ix"] for w in fts]),
                "covarep": np.array([w["covarep"] for w in fts], np.float32),
                "facet": np.array([w["facet"] for w in fts], np.float32),
                "label": seg["sentiment"],
                "length": len(fts),
            })
    return synthetic.pad_segments(segs, max_segment_len, side="left")


def load_word_level_features(max_segment_len, data_root):
    """The real files' (train, valid, test) dicts (``data_loader.py:
    168-178``)."""
    with open(os.path.join(data_root,
                           "glove_word_embedding/word2ix_300_mosi.pkl"),
              "rb") as f:
        word2ix = pickle.load(f)
    truth = load_truth(os.path.join(
        data_root, "Meta_data/boundaries_sentimentint_avg.csv"))
    load_transcripts(truth, os.path.join(data_root,
                                         "Transcript/SEGMENT_ALIGNED"),
                     word2ix)
    load_facet(truth, os.path.join(data_root,
                                   "Features/Visual/FACET_GIOTA"))
    load_covarep(truth, os.path.join(data_root, "Features/Audio/raw"))
    train, valid, test = split_videos(truth)
    return (segments_to_arrays(train, max_segment_len),
            segments_to_arrays(valid, max_segment_len),
            segments_to_arrays(test, max_segment_len))


# ------------------------------------------------------------- adapter

def get_data(seqlength: int = SEQLENGTH, feature_selection: bool = True,
             data_root=None, normalize_covarep: bool = False):
    """-> (X_train, y_train, X_valid, y_valid, X_test, y_test), X
    batch-major (n, t, d_total) as ``mfm_mosi.py:41-126`` builds it: from
    the real files under ``data_root`` where it is a directory, else from
    the synthetic set (624, 229 and 686 segments). ``feature_selection``
    False keeps covarep columns 1:35 and the whole facet;
    ``normalize_covarep`` also divides covarep by its train max-abs
    (``get_data_missing``)."""
    if data_root and os.path.isdir(data_root):
        train, valid, test = load_word_level_features(seqlength, data_root)
        with open(os.path.join(data_root, "glove_word_embedding/"
                               "glove_300_mosi.pkl"), "rb") as f:
            embedding = pickle.load(f)
        if feature_selection:
            with open(os.path.join(data_root, "fs_mask.pkl"), "rb") as f:
                covarep_ix, facet_ix = pickle.load(f)
    else:
        train, valid, test = synthetic.synthetic_word_level(seqlength)
        embedding = synthetic.synthetic_embedding()
        if feature_selection:
            covarep_ix, facet_ix = synthetic.synthetic_fs_mask()

    splits = (train, valid, test)
    if feature_selection:
        covs = [d["covarep"][:, :, covarep_ix] for d in splits]
        facs = [d["facet"][:, :, facet_ix] for d in splits]
    else:  # the raw path keeps covarep columns 1:35 (mfm_mosi.py:73)
        covs = [d["covarep"][:, :, 1:35] for d in splits]
        facs = [d["facet"] for d in splits]
    fac_max = compute_train_max(facs[0])
    facs = [fac / fac_max for fac in facs]
    if normalize_covarep:
        cov_max = compute_train_max(covs[0])
        covs = [cov / cov_max for cov in covs]
    out = []
    for d, cov, fac in zip(splits, covs, facs):
        X = np.concatenate([embedding[d["text"]], cov, fac],
                           axis=2).astype(np.float32)
        out += [X, d["label"].astype(np.float32)]
    return tuple(out)


def input_dims(feature_selection: bool = True):
    """The [text, audio, video] widths ``get_data`` gives on the synthetic
    set (the raw path's video width is the files' facet width)."""
    return (INPUT_DIMS_FS if feature_selection
            else [300, 34, synthetic.FACET_RAW])


# ------------------------------------------------------- a fabricated root

FABRICATED_WORDS = ["THE", "CAT", "SAT", "ON", "MAT", "DOG", "RAN", "FAST"]


def fabricate_root(root, n_videos: int = 70, seed: int = 0):
    """Write a small MOSI data root in the real files' layout under
    ``root`` (``data_loader.py:9-22``; the JAX package's
    ``tests/test_real_mosi_pipeline.py`` fixture): the GloVe pickles over
    eight words, the fs mask, the truth CSV, word-aligned transcripts,
    FACET CSVs (30 fps, 5 meta and 43 feature columns) and COVAREP .mat
    files (100 Hz, 74 columns, with a NaN and a -inf frame), one segment
    of 2 to 4 words a video. Returns ``root``."""
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    join = os.path.join
    for sub in ("glove_word_embedding", "Meta_data",
                "Transcript/SEGMENT_ALIGNED", "Features/Visual/FACET_GIOTA",
                "Features/Audio/raw"):
        os.makedirs(join(root, sub), exist_ok=True)
    words = FABRICATED_WORDS
    word2ix = {w: i + 1 for i, w in enumerate(words)}
    emb = rng.normal(size=(len(words) + 1, 300)).astype(np.float32)
    emb[0] = 0
    with open(join(root, "glove_word_embedding/word2ix_300_mosi.pkl"),
              "wb") as f:
        pickle.dump(word2ix, f)
    with open(join(root, "glove_word_embedding/glove_300_mosi.pkl"),
              "wb") as f:
        pickle.dump(emb, f)
    with open(join(root, "fs_mask.pkl"), "wb") as f:
        pickle.dump(list(synthetic.synthetic_fs_mask()), f)
    truth_lines = []
    for v in range(n_videos):
        vid = f"vid{v:03d}"
        n_words = int(rng.integers(2, 5))
        # truth row: start, end, video, segment, sentiment
        truth_lines.append(
            f"0.0,{n_words * 0.5},{vid},1,{float(rng.uniform(-3, 3))}")
        # transcript rows: ?, word, start and end in the segment and clip
        rows = []
        for w in range(n_words):
            word = words[int(rng.integers(0, len(words)))]
            s, e = w * 0.5, (w + 1) * 0.5
            rows.append(f"x,{word},{s},{e},{s},{e}")
        with open(join(root, f"Transcript/SEGMENT_ALIGNED/{vid}_1"),
                  "w") as f:
            f.write("\n".join(rows))
        feats = rng.normal(size=(int(n_words * 0.5 * 30) + 3, 43))
        lines = ["h," * 47 + "h"] + [
            ",".join(["0"] * 5 + [f"{x:.6f}" for x in fr]) for fr in feats]
        with open(join(root, f"Features/Visual/FACET_GIOTA/"
                             f"{vid}.FACET_out.csv"), "w") as f:
            f.write("\r\n".join(lines))
        afeat = rng.normal(size=(int(n_words * 0.5 * 100) + 5, 74))
        afeat[0, 3] = np.nan
        afeat[1, 4] = -np.inf
        sio.savemat(join(root, f"Features/Audio/raw/{vid}.mat"),
                    {"features": afeat})
    with open(join(root, "Meta_data/boundaries_sentimentint_avg.csv"),
              "w") as f:
        f.write("\r\n".join(truth_lines))
    return root
