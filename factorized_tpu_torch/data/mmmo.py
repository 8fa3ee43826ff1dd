"""MMMO (persuasiveness) adapter (port of ``factorized_tpu/data/mmmo.py``).

Parity with ``mfm_mmmo.py:33-345``:
- persuasiveness scores 1..7 from ``annotations_full.csv``
  (``mfm_mmmo.py:35-55``), regression with binary threshold > 3.5
  (``mfm_mmmo.py:495-496``);
- sentence-aggregated pre-pickled dicts (``mfm_mmmo.py:211-213``);
- LEFT-padded (zeros first: ``mfm_mmmo.py:226-230``) with fallback dims
  300/74/36;
- split by dict order: 220 videos train / 40 valid / rest test
  (``mfm_mmmo.py:240-242``);
- ``np.nan_to_num`` + clip to +-255 (``mfm_mmmo.py:332-337``).
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np

from factorized_tpu_torch.data import synthetic
from factorized_tpu_torch.data.dictsets import assemble

INPUT_DIMS = [300, 74, 36]
SEQLENGTH = 20
BINARY_THRESHOLD = 3.5
THRESHOLD_MODE = "gt"


def get_data(seqlength: int = SEQLENGTH, data_root=None,
             synthetic_seed: int = 123):
    if data_root and os.path.isdir(data_root):
        with open(os.path.join(data_root, "text_dict_s.p"), "rb") as f:
            text_dict = pickle.load(f, encoding="latin1")
        with open(os.path.join(data_root, "audio_dict_s.p"), "rb") as f:
            audio_dict = pickle.load(f, encoding="latin1")
        with open(os.path.join(data_root, "video_dict_s.p"), "rb") as f:
            video_dict = pickle.load(f, encoding="latin1")
        labels = {}
        with open(os.path.join(data_root, "annotations_full.csv"),
                  newline="") as f:
            for i, row in enumerate(csv.reader(f)):
                if i == 0 or not row:
                    continue
                link = row[0]
                # last column, falling back to column 1
                # (data_loader equivalent tolerated garbage rows with a
                # bare except — a row with NO parseable label is skipped)
                try:
                    label = float(row[-1])
                except (ValueError, IndexError):
                    try:
                        label = float(row[1])
                    except (ValueError, IndexError):
                        continue
                vid = link.split(".")[0] if "." in link else link
                labels[vid] = {"1": label}
    else:
        text_dict, audio_dict, video_dict, labels = synthetic.synthetic_dicts(
            300, segs_per_video=1, dims=tuple(INPUT_DIMS),
            label_mode="mmmo", seed=synthetic_seed
        )

    all_ids = list(text_dict.keys())
    splits = (all_ids[:220], all_ids[220:260], all_ids[260:])

    out = []
    for videos in splits:
        idx = [(vid, sid) for vid in videos for sid in text_dict[vid]
               if vid in labels and sid in labels[vid]]
        X, y = assemble(text_dict, audio_dict, video_dict, labels, idx,
                        seqlength, "left", INPUT_DIMS, clip=255.0,
                        nan_to_num=True)
        out.extend([X, y.astype(np.float32)])
    return tuple(out)
