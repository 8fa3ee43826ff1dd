"""Deterministic synthetic MOSI fixtures (port of the MOSI half of
``factorized_tpu/data/synthetic.py``).

Emits the schema of the reference MOSI loader's word-level output: per
split a dict with keys ``facet / covarep / text / lengths / label / id``,
text as integer word ids and features as per-word vectors. Labels are a
learnable function of the features (a fixed random readout of the
feature-selected channels of the last window of words, plus noise), so
training shows real loss decrease. The same seeds give the same arrays
as the JAX package.

Raw feature dims mirror MOSI: covarep 74, facet 43; ``synthetic_fs_mask``
selects 5 covarep and 20 facet channels like the real ``fs_mask.pkl``.
"""

from __future__ import annotations

import numpy as np

VOCAB = 512
EMBED_DIM = 300
COVAREP_RAW = 74
FACET_RAW = 43


def synthetic_embedding(seed: int = 7):
    """A frozen GloVe-like embedding matrix (row 0 = padding zeros)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 0.3, size=(VOCAB, EMBED_DIM)).astype(np.float32)
    emb[0] = 0.0
    return emb


def synthetic_fs_mask(seed: int = 11):
    """(covarep_ix, facet_ix) like the reference fs_mask.pkl."""
    rng = np.random.default_rng(seed)
    covarep_ix = np.sort(rng.choice(COVAREP_RAW, size=5, replace=False))
    facet_ix = np.sort(rng.choice(FACET_RAW, size=20, replace=False))
    return covarep_ix, facet_ix


def _readout(seed: int = 13):
    """Label readout weights SUPPORTED on the feature-selected channels
    and the last-window of words — i.e. on information the model can
    actually see after fs-mask selection and keep-last truncation — so
    synthetic training exhibits real learning."""
    rng = np.random.default_rng(seed)
    cov_ix, fac_ix = synthetic_fs_mask()
    w_t = rng.normal(size=(EMBED_DIM,)) / np.sqrt(EMBED_DIM)
    w_a = np.zeros(COVAREP_RAW)
    w_a[cov_ix] = rng.normal(size=len(cov_ix)) / np.sqrt(len(cov_ix))
    w_v = np.zeros(FACET_RAW)
    w_v[fac_ix] = rng.normal(size=len(fac_ix)) / np.sqrt(len(fac_ix))
    return w_t, w_a, w_v


def synthetic_segments(n_segments, seed, max_len=40):
    """Generate raw word-aligned segments (variable length)."""
    rng = np.random.default_rng(seed)
    emb = synthetic_embedding()
    w_t, w_a, w_v = _readout()
    segs = []
    for i in range(n_segments):
        length = int(rng.integers(3, max_len + 1))
        text = rng.integers(1, VOCAB, size=(length,))
        base = rng.normal(size=(length, 1))
        covarep = (0.6 * base + rng.normal(0, 1.0, size=(length, COVAREP_RAW))
                   ).astype(np.float32)
        facet = (0.6 * base + rng.normal(0, 1.0, size=(length, FACET_RAW))
                 ).astype(np.float32)
        # signal from the LAST window (what survives keep-last
        # truncation at the default seqlength)
        win = 20
        signal = (
            emb[text[-win:]].mean(0) @ w_t
            + covarep[-win:].mean(0) @ w_a
            + facet[-win:].mean(0) @ w_v
        )
        label = float(np.clip(4.0 * signal + rng.normal(0, 0.3), -3, 3))
        segs.append({"text": text, "covarep": covarep, "facet": facet,
                     "label": label, "length": length})
    return segs


def pad_segments(segs, max_segment_len, side="left"):
    """Fixed-length arrays with MOSI semantics: pad zeros (left by
    default, ``data_loader.py:139-147``), truncate keeping the LAST
    ``max_segment_len`` words (``data_loader.py:148-152``)."""
    data = {"facet": [], "covarep": [], "text": [], "lengths": [],
            "label": [], "id": []}
    for i, s in enumerate(segs):
        text, covarep, facet = s["text"], s["covarep"], s["facet"]
        L = len(text)
        if L > max_segment_len:
            text = text[L - max_segment_len:]
            covarep = covarep[L - max_segment_len:]
            facet = facet[L - max_segment_len:]
        else:
            pad_n = max_segment_len - L
            zt = np.zeros(pad_n, dtype=text.dtype)
            zc = np.zeros((pad_n, covarep.shape[1]), covarep.dtype)
            zf = np.zeros((pad_n, facet.shape[1]), facet.dtype)
            if side == "left":
                text = np.concatenate([zt, text])
                covarep = np.concatenate([zc, covarep])
                facet = np.concatenate([zf, facet])
            else:
                text = np.concatenate([text, zt])
                covarep = np.concatenate([covarep, zc])
                facet = np.concatenate([facet, zf])
        data["text"].append(text)
        data["covarep"].append(covarep)
        data["facet"].append(facet)
        data["lengths"].append(s["length"])
        data["label"].append(s["label"])
        data["id"].append(f"synthetic_{i}")
    return {
        "facet": np.asarray(data["facet"], np.float32),
        "covarep": np.asarray(data["covarep"], np.float32),
        "text": np.asarray(data["text"]),
        "lengths": np.asarray(data["lengths"]),
        "label": np.asarray(data["label"]),
        "id": data["id"],
    }


def synthetic_word_level(max_segment_len, *, n_train=624, n_valid=229,
                         n_test=686, seed=123):
    """(train, valid, test) dicts with the MOSI segment counts by
    default (the real data has 1284 train+valid and 686 test segments;
    these are the same order of magnitude)."""
    return tuple(
        pad_segments(synthetic_segments(count, seed + k), max_segment_len)
        for k, count in enumerate((n_train, n_valid, n_test), start=1))
