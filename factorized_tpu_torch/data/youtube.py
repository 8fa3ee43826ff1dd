"""YouTube opinion dataset adapter (port of
``factorized_tpu/data/youtube.py``).

Parity with ``mfm_you.py:34-251``:
- 3 sentiment classes -1/0/1 shifted to 0..2 (``mfm_you.py:243-249``);
- split by dict iteration order: 30 videos train / 5 valid / rest test
  (``mfm_you.py:207-209``);
- RIGHT-padded with per-modality fallback dims 300/74/36 when a segment
  is scalar/missing (``mfm_you.py:173-193``);
- ``np.nan_to_num`` applied to features and labels
  (``mfm_you.py:231-241``).
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np

from factorized_tpu_torch.data import synthetic
from factorized_tpu_torch.data.dictsets import assemble

INPUT_DIMS = [300, 74, 36]
NUM_CLASSES = 3
SEQLENGTH = 20


def get_data(seqlength: int = SEQLENGTH, data_root=None,
             synthetic_seed: int = 123):
    if data_root and os.path.isdir(data_root):
        with open(os.path.join(data_root, "text_dict.p"), "rb") as f:
            text_dict = pickle.load(f, encoding="latin1")
        with open(os.path.join(data_root, "audio_dict.p"), "rb") as f:
            audio_dict = pickle.load(f, encoding="latin1")
        with open(os.path.join(data_root, "video_dict.p"), "rb") as f:
            video_dict = pickle.load(f, encoding="latin1")
        labels = {}
        with open(os.path.join(data_root,
                               "sentimentAnnotations.csv"), newline="") as f:
            for row in csv.reader(f):
                try:
                    vid, sid, lab = row[0], row[1], int(float(row[-1]))
                except (ValueError, IndexError):
                    continue
                labels.setdefault(vid, {})[sid] = lab + 1  # -1..1 -> 0..2
    else:
        text_dict, audio_dict, video_dict, labels = synthetic.synthetic_dicts(
            47, dims=tuple(INPUT_DIMS), label_mode="3", seed=synthetic_seed
        )

    all_ids = list(text_dict.keys())
    splits = (all_ids[:30], all_ids[30:35], all_ids[35:])

    out = []
    for videos in splits:
        idx = [(vid, sid) for vid in videos for sid in text_dict[vid]
               if vid in labels and sid in labels[vid]]
        X, y = assemble(text_dict, audio_dict, video_dict, labels, idx,
                        seqlength, "right", INPUT_DIMS, nan_to_num=True)
        out.extend([X, y.astype(np.int64)])
    return tuple(out)
