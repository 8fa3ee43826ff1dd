"""The word-window average of the real MOSI pipeline in numpy: the plain
version of ``factorized_tpu_torch/native.py::segment_average`` (the C++
of ``csrc/segavg.cpp``, which the reader calls), with its arithmetic, so
the tests hold the two equal bit for bit.

For each word's frame window ``[start, end)``, clipped to the feature
rows: the mean of its rows, each column summed in float64 in frame order
and multiplied by ``1 / (end - start)``, then rounded to float32; zeros
for an empty window; NaN and -inf set to zero only in the windows whose
mean they reach, as the reference loader does (``data_loader.py:62-101``).
"""

from __future__ import annotations

import numpy as np


def segment_average(feats, starts, ends):
    """(n_words, dim) float32 means of ``feats[s:e]`` per (s, e) window.
    Each window is summed on its own, frame by frame (no cumulative sum,
    through which one NaN frame would reach every later window)."""
    feats = np.asarray(feats, np.float32).astype(np.float64)
    n_frames, dim = feats.shape
    s = np.maximum(np.asarray(starts, np.int64), 0)
    e = np.minimum(np.asarray(ends, np.int64), n_frames)
    out = np.zeros((len(s), dim), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for w in range(len(s)):
            if e[w] <= s[w]:
                continue
            acc = np.zeros(dim, np.float64)
            for f in range(s[w], e[w]):
                acc += feats[f]
            out[w] = (acc * (1.0 / float(e[w] - s[w]))).astype(np.float32)
    out[np.isnan(out) | np.isneginf(out)] = 0.0
    return out
