"""CMU-MOSI adapter (port of ``factorized_tpu/data/mosi.py``, the
synthetic branch with feature selection, as the JAX package runs it
without the real files).

The schema-faithful synthetic generator supplies the word-level dicts,
and the reference's pipeline runs on them: feature selection by the fs
mask (covarep -> 5, facet -> 20), facet max-abs normalisation by train
statistics, the frozen 300-d embedding lookup, and the feature-axis
concat [text | audio | video]. Reading the real files is not yet ported.
"""

from __future__ import annotations

import numpy as np

from factorized_tpu_torch.data import synthetic
from factorized_tpu_torch.data.batcher import compute_train_max

SEQLENGTH = 20


def get_data(seqlength: int = SEQLENGTH):
    """-> (X_train, y_train, X_valid, y_valid, X_test, y_test) with X
    batch-major (n, t, 325): 624, 229 and 686 synthetic segments."""
    train, valid, test = synthetic.synthetic_word_level(seqlength)
    embedding = synthetic.synthetic_embedding()
    covarep_ix, facet_ix = synthetic.synthetic_fs_mask()
    splits = (train, valid, test)
    covs = [d["covarep"][:, :, covarep_ix] for d in splits]
    facs = [d["facet"][:, :, facet_ix] for d in splits]
    fac_max = compute_train_max(facs[0])
    out = []
    for d, cov, fac in zip(splits, covs, facs):
        X = np.concatenate([embedding[d["text"]], cov, fac / fac_max],
                           axis=2).astype(np.float32)
        out += [X, d["label"].astype(np.float32)]
    return tuple(out)
