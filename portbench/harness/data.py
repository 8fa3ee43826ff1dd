"""CMU-MOSI-shaped data made from a seed.

A frozen copy of the port's synthetic MOSI segments
(``factorized_tpu_torch/data/synthetic.py``: ``synthetic_segments``,
``pad_segments``; ``data/mosi.py::get_data`` with feature selection):
word-aligned segments of 3 to 40 words, GloVe-like 300-wide text
vectors, 74 COVAREP and 43 FACET channels of which 5 and 20 are kept,
FACET scaled by its train max, left-padded and cut to the last ``t``
words, and a sentiment label in [-3, 3] that is a fixed readout of what
survives the cut plus noise, so a trial learns something. The split
sizes come from the configuration's ``split``, as do the widths. The embedding, the channel selection
and the readout are the dataset's own (fixed seeds, as the original);
the segments come from the run's seed. The same seed gives the same
arrays, and the program and the reference are handed the same arrays.
"""

from __future__ import annotations

import numpy as np

VOCAB = 512
EMBED_DIM = 300
COVAREP_RAW = 74
FACET_RAW = 43
WINDOW = 20


def _embedding(width, seed=7):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 0.3, size=(VOCAB, width)).astype(np.float32)
    emb[0] = 0.0
    return emb


def _fs_mask(n_cov, n_fac, seed=11):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.choice(COVAREP_RAW, size=n_cov, replace=False)),
            np.sort(rng.choice(FACET_RAW, size=n_fac, replace=False)))


def _readout(dims, seed=13):
    rng = np.random.default_rng(seed)
    cov_ix, fac_ix = _fs_mask(*dims[1:])
    w_t = rng.normal(size=(dims[0],)) / np.sqrt(dims[0])
    w_a = np.zeros(COVAREP_RAW)
    w_a[cov_ix] = rng.normal(size=len(cov_ix)) / np.sqrt(len(cov_ix))
    w_v = np.zeros(FACET_RAW)
    w_v[fac_ix] = rng.normal(size=len(fac_ix)) / np.sqrt(len(fac_ix))
    return w_t, w_a, w_v


def _segments(n, rng, emb, readout, max_len):
    w_t, w_a, w_v = readout
    segs = []
    for _ in range(n):
        length = int(rng.integers(3, max_len + 1))
        text = rng.integers(1, VOCAB, size=(length,))
        base = rng.normal(size=(length, 1))
        covarep = (0.6 * base + rng.normal(0, 1.0, size=(length, COVAREP_RAW))
                   ).astype(np.float32)
        facet = (0.6 * base + rng.normal(0, 1.0, size=(length, FACET_RAW))
                 ).astype(np.float32)
        signal = (emb[text[-WINDOW:]].mean(0) @ w_t
                  + covarep[-WINDOW:].mean(0) @ w_a
                  + facet[-WINDOW:].mean(0) @ w_v)
        label = float(np.clip(4.0 * signal + rng.normal(0, 0.3), -3, 3))
        segs.append((text, covarep, facet, label))
    return segs


def _pad(segs, t):
    """Left zero-pad, keep the last ``t`` words."""
    n = len(segs)
    text = np.zeros((n, t), np.int64)
    cov = np.zeros((n, t, COVAREP_RAW), np.float32)
    fac = np.zeros((n, t, FACET_RAW), np.float32)
    label = np.zeros(n, np.float32)
    for i, (tx, cv, fc, lab) in enumerate(segs):
        k = min(len(tx), t)
        text[i, t - k:] = tx[len(tx) - k:]
        cov[i, t - k:] = cv[len(cv) - k:]
        fac[i, t - k:] = fc[len(fc) - k:]
        label[i] = lab
    return text, cov, fac, label


def mosi_arrays(seed: int, n_train: int, n_valid: int, n_test: int,
                t: int = 20, max_len: int = 40, dims=(EMBED_DIM, 5, 20)):
    """(X_train, y_train, X_valid, y_valid, X_test, y_test): X batch-major
    (n, t, sum(dims)) float32 (text, the COVAREP channels kept, the FACET
    channels kept: MOSI's 300, 5 and 20), y float32."""
    emb, readout = _embedding(dims[0]), _readout(dims)
    cov_ix, fac_ix = _fs_mask(*dims[1:])
    splits = []
    for k, n in enumerate((n_train, n_valid, n_test), start=1):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), k]))
        splits.append(_pad(_segments(n, rng, emb, readout, max_len), t))
    facs = [fac[:, :, fac_ix] for _, _, fac, _ in splits]
    fac_max = np.max(np.abs(facs[0]), axis=(0, 1))
    fac_max[fac_max == 0] = 1.0
    out = []
    for (text, cov, _, label), fac in zip(splits, facs):
        X = np.concatenate([emb[text], cov[:, :, cov_ix],
                            fac / fac_max.astype(np.float32)], axis=2)
        out += [np.ascontiguousarray(X, dtype=np.float32), label]
    return tuple(out)


def arrays(seed: int, split: dict, cfg):
    """``mosi_arrays`` at a configuration's ``split`` (``n_train``,
    ``n_valid``, ``n_test``, ``max_words``) and widths."""
    return mosi_arrays(seed, split["n_train"], split["n_valid"],
                       split["n_test"], cfg.seqlength, split["max_words"],
                       tuple(cfg.input_dims))
