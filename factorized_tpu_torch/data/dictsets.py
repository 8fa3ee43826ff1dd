"""Shared machinery for the pre-pickled-dict datasets (MOUD, YouTube,
MMMO): {video_id: {segment_id: (len, dim) array}} per modality (port of
``factorized_tpu/data/dictsets.py``).
"""

from __future__ import annotations

import numpy as np

from factorized_tpu_torch.data.synthetic import pad_dict_segment


def assemble(text_dict, audio_dict, video_dict, labels, index,
             max_segment_len, side, dims, clip=None, nan_to_num=False):
    """Pad + concat one split's segments into (n, t, d_total) X and y."""
    d_t, d_a, d_v = dims
    xs, ys = [], []
    for vid, sid in index:
        t = pad_dict_segment(text_dict[vid][sid], max_segment_len, side, d_t)
        a = pad_dict_segment(audio_dict[vid][sid], max_segment_len, side, d_a)
        v = pad_dict_segment(video_dict[vid][sid], max_segment_len, side, d_v)
        xs.append(np.concatenate([t, a, v], axis=1))
        ys.append(labels[vid][sid])
    X = np.asarray(xs, np.float32)
    y = np.asarray(ys)
    if nan_to_num:
        X = np.nan_to_num(X)
        y = np.nan_to_num(y)
    if clip is not None:
        X = np.clip(X, -clip, clip)
    return X, y
