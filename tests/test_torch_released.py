"""The released checkpoints ``best/mfn_mae`` and ``best/mfn_acc``,
converted once into the port's format.

``best/*`` are Orbax stores whose data files are zstd frames. The port
reads them itself (``factorized_tpu_torch.utils.checkpoint.
restore_checkpoint``, through its own zstd, OCDBT, zarr and Orbax
readers; ``tests/test_torch_jax_checkpoint.py``), so ``serve``,
``test_mosi`` and ``Predictor.from_checkpoint`` take ``best/<name>`` as it
is. The conversion kept under ``factorized_tpu_torch/released/`` stays
as the bit-for-bit witness of those reads: ``convert_released`` reads
each store through the JAX package's ``restore_checkpoint`` (Orbax, with
``tensorstore`` and ``zstandard``) and writes it with
``factorized_tpu_torch.utils.checkpoint.save_checkpoint`` (``state.pt``,
and ``meta.json`` with ``"format": "torch"``, the step and the config
copied). To write them anew, from the repository root::

    python tests/test_torch_released.py

The tests: every committed leaf equals the JAX restore bit for bit, and a
fresh conversion equals the committed files (both skip without
``orbax``); the port's ``Predictor`` scores each committed checkpoint on
the synthetic MOSI test set as the release did (``VALIDATION.md`` §4):
``mfn_mae`` MAE 0.6101879 and binary accuracy 0.8250729, ``mfn_acc``
accuracy 0.7813411, within 1e-6."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from factorized_tpu_torch.convert import (  # noqa: E402
    from_numpy, to_state_dict)
from factorized_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)

NAMES = ("mfn_mae", "mfn_acc")
SOURCE = os.path.join(ROOT, "best")
RELEASED = os.path.join(ROOT, "factorized_tpu_torch", "released")
# the release's scores on the synthetic MOSI test set (VALIDATION.md §4)
SCORES = {"mfn_mae": {"mae": 0.6101879, "binary_accuracy": 0.8250729},
          "mfn_acc": {"accuracy": 0.7813411}}


def convert_released(dest=RELEASED, source=SOURCE):
    """Each ``source/<name>`` Orbax store restored by the JAX package and
    written under ``dest/<name>`` in the port's checkpoint format, the
    params (float32 leaves, the JAX tree's keys) and the meta's step and
    config; returns the paths written."""
    import jax

    from factorized_tpu.utils.checkpoint import (
        restore_checkpoint as restore_jax)

    written = []
    for name in NAMES:
        state, meta = restore_jax(os.path.join(source, name))
        params = from_numpy(jax.tree.map(np.asarray, state["params"]))
        written.append(save_checkpoint(os.path.join(dest, name), params,
                                       step=meta["step"],
                                       config=meta["config"]))
    return written


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_leaves(name):
    pytest.importorskip("orbax.checkpoint")
    import jax

    from factorized_tpu.utils.checkpoint import (
        restore_checkpoint as restore_jax)

    state, meta = restore_jax(os.path.join(SOURCE, name))
    return to_state_dict(jax.tree.map(np.asarray, state["params"])), meta


@pytest.mark.parametrize("name", NAMES)
def test_committed_leaves_equal_the_jax_restore(name):
    want, meta = _jax_leaves(name)
    state, port_meta = restore_checkpoint(os.path.join(RELEASED, name))
    got = to_state_dict(state["params"])
    assert list(got) == list(want) and len(got) == 77
    for k, v in want.items():
        assert v.dtype == np.float32
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), v), k
    assert port_meta == {"step": meta["step"], "config": meta["config"],
                         "has_opt_state": False, "format": "torch"}


@pytest.mark.parametrize("name", NAMES)
def test_a_fresh_conversion_equals_the_committed_files(name, tmp_path):
    pytest.importorskip("orbax.checkpoint")
    convert_released(str(tmp_path))
    with open(os.path.join(tmp_path, name, "meta.json")) as f, \
            open(os.path.join(RELEASED, name, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    fresh, _ = restore_checkpoint(os.path.join(tmp_path, name))
    kept, _ = restore_checkpoint(os.path.join(RELEASED, name))
    fresh, kept = to_state_dict(fresh["params"]), to_state_dict(
        kept["params"])
    assert list(fresh) == list(kept)
    for k in kept:
        assert torch.equal(fresh[k], kept[k]), k


@pytest.fixture(scope="module")
def mosi_test_set():
    from factorized_tpu_torch.data import mosi

    _, _, _, _, X_test, y_test = mosi.get_data(20)
    return X_test, y_test


@pytest.mark.parametrize("name", NAMES)
def test_committed_checkpoints_score_as_released(name, mosi_test_set):
    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.utils.metrics import (score_classification,
                                                    score_regression)

    X_test, y_test = mosi_test_set
    predictor = Predictor.from_checkpoint(os.path.join(RELEASED, name),
                                          device="cpu")
    y_hat = predictor.predict(X_test)
    out = io.StringIO()
    if predictor.cfg.task == "regression":
        metrics = score_regression(y_hat, y_test, out=out)
    else:
        # test_mosi's classification: the binarized sentiment y >= 0
        metrics = score_classification(y_hat, (y_test >= 0).astype(np.int64),
                                       out=out)
    for key, want in SCORES[name].items():
        assert abs(metrics[key] - want) <= 1e-6, (key, metrics[key], want)


if __name__ == "__main__":
    for path in convert_released():
        print(f"wrote {path}")
