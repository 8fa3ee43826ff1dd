"""MOUD (Spanish sentiment) adapter (port of
``factorized_tpu/data/moud.py``).

Parity with ``mfm_moud.py:34-273``:
- labels from ``cats.txt``: positive=1, negative=0, NEUTRAL DROPPED
  (``mfm_moud.py:53-58``);
- split by first-seen video order (``mfm_moud.py:90-107``): the
  reference adds the video to its seen-set BEFORE the threshold checks,
  so the 49th first-seen video already lands in VALID and the 59th in
  TEST — i.e. train = videos 1..48, valid = 49..58, test = 59.. (the
  in-code comment says "49 train 10 val 20 test" but the code yields
  48/10/21; we reproduce the CODE);
- features from pre-pickled text/audio/video dicts
  (``mfm_moud.py:193-195``);
- RIGHT-padded to seqlength, truncate keeping last
  (``mfm_moud.py:197-209``);
- inputs clipped to +-255 (``mfm_moud.py:267-272``);
- binary labels (argmax of to_categorical == identity on 0/1:
  ``mfm_moud.py:263-265,611-613``).

Input dims [300, 74, 36] (``mfm_moud.py:617``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from factorized_tpu_torch.data import synthetic
from factorized_tpu_torch.data.dictsets import assemble

INPUT_DIMS = [300, 74, 36]
NUM_CLASSES = 2
SEQLENGTH = 20


def _order_preserving_split(video_ids, n_train=48, n_valid=10):
    """Reference semantics (mfm_moud.py:90-107): videos counted BEFORE
    the >=49/>=59 threshold checks -> 48 train / 10 valid / rest test."""
    train_v = video_ids[:n_train]
    valid_v = video_ids[n_train:n_train + n_valid]
    test_v = video_ids[n_train + n_valid:]
    return train_v, valid_v, test_v


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
        with open(os.path.join(data_root, "cats.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                name, lab = parts[0], parts[1]
                # ids are <vid>_<take>_<segment>; a malformed id (fewer
                # than two underscores) is skipped like the reference's
                # bare-except tolerance (mfm_moud.py:91-107)
                try:
                    i = (name.index("_") + 1
                         + name[name.index("_") + 1:].index("_"))
                except ValueError:
                    continue
                vid, sid = name[:i], name[i + 1:]
                if lab == "positive":
                    labels.setdefault(vid, {})[sid] = 1
                elif lab == "negative":
                    labels.setdefault(vid, {})[sid] = 0
                # neutral dropped (mfm_moud.py:55-56)
        # split order: first-seen video order in spanish_text.csv
        # (mfm_moud.py:83-90); fall back to dict order if absent
        csv_path = os.path.join(data_root, "spanish_text.csv")
        if os.path.exists(csv_path):
            import csv as _csv

            seen = []
            with open(csv_path, newline="") as f:
                for row in _csv.reader(f):
                    if not row:
                        continue
                    vid = row[0][:row[0].index(".")] if "." in row[0] \
                        else row[0]
                    if vid not in seen:
                        seen.append(vid)
            video_ids = seen
        else:
            # The 48/10/rest split membership is DEFINED by first-seen
            # order in spanish_text.csv (mfm_moud.py:83-107). Falling
            # back to pickle dict order silently changes which videos
            # land in train/valid/test — warn loudly so a real-data run
            # can't mistake this for the reference split.
            import warnings

            warnings.warn(
                f"MOUD: {csv_path} not found — falling back to pickle "
                "dict order for the 48/10/rest video split. This split "
                "does NOT match the reference (mfm_moud.py:83-107), "
                "whose membership comes from first-seen order in "
                "spanish_text.csv. Provide that file for parity.",
                stacklevel=2,
            )
            video_ids = list(text_dict.keys())
    else:
        text_dict, audio_dict, video_dict, labels = synthetic.synthetic_dicts(
            79, dims=tuple(INPUT_DIMS), label_mode="2", seed=synthetic_seed
        )
        video_ids = list(text_dict.keys())

    train_v, valid_v, test_v = _order_preserving_split(video_ids)

    def index(videos):
        return [
            (vid, sid)
            for vid in videos
            for sid in text_dict.get(vid, {})
            if vid in labels and sid in labels[vid]
        ]

    out = []
    for videos in (train_v, valid_v, test_v):
        X, y = assemble(text_dict, audio_dict, video_dict, labels,
                        index(videos), seqlength, "right", INPUT_DIMS,
                        clip=255.0)
        out.extend([X, y.astype(np.int64)])
    return tuple(out)
