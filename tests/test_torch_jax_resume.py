"""Resuming the JAX package's ``train_mfm`` snapshot with the port, run
for run, on the CPU.

The JAX trainer runs 3 epochs uninterrupted with ``--ckpt-every 2`` and
writes its snapshot on the way (its own ``save_checkpoint``: Orbax, and
msgpack where Orbax is not used): the live parameters, the flat Adam
state (its moments in ``ravel_pytree``'s sorted-key order, which the
port's optimizer lays out in its own), the lr and the best validation
loss at epoch 2. The port resumes it through ``restore_checkpoint`` and
``resume_from`` for the third epoch, which is held against the JAX run's
under ROADMAP C's bounds (``tests/test_torch_trainers_vs_jax.py``:
parameters within 1e-6, losses within 1e-5 relative, every lr equal, test
metrics within 1e-6). Every dropout is 0 and ``lda_mmd`` 0, so no random
draw weighs on either run (the config of ``tests/test_torch_resume.py``);
the data's seed gives a validation loss that falls every epoch, so the
kept parameters are the last epoch's in both runs (a snapshot carries the
live parameters, which a resumed keeper starts from, as the JAX
package's own resume does). The lanes' and the evolving search's JAX
snapshots are resumed in ``tests/test_torch_multiseed.py`` and
``tests/test_torch_evolve.py``, beside the JAX runs they already make."""

import functools

import jax
import numpy as np
import pytest
import torch

from factorized_tpu import cli as jax_cli
from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.utils import checkpoint as jax_checkpoint
from factorized_tpu.utils.logging import RunLogger as JaxLogger
from factorized_tpu_torch import trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import to_state_dict
from factorized_tpu_torch.utils.checkpoint import restore_checkpoint
from factorized_tpu_torch.utils.logging import RunLogger

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
METRICS = dict(rtol=0.0, atol=1e-6)
CORR = dict(rtol=1e-5, atol=1e-6)
SEED = 6

CFG = JaxConfig(
    seqlength=5, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0, za_to_fa_dropout=0.0,
    zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0, lda_mmd=0.0, out_drop=0.0,
    batchsize=16, num_epochs=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _chunked(monkeypatch):
    monkeypatch.delenv("FACTORIZED_TPU_HOST_LOOP", raising=False)
    monkeypatch.delenv("FACTORIZED_TPU_EPOCH_CHUNK", raising=False)


def _data(n_train=48, n_valid=16, n_test=20):
    rng = np.random.default_rng(SEED)

    def split(n):
        X = rng.normal(size=(n, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        return X, (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)).astype(
            np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def _port_cfg():
    return MFMConfig.from_dict(CFG.to_dict())


def _close_params(got, want):
    flat_j = to_state_dict(jax.tree.map(np.asarray, want))
    flat_p = to_state_dict(got)
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].detach().numpy(), v,
                                   err_msg=k, **PARAMS)


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k,
                                   **(CORR if k == "corr" else METRICS))


@pytest.mark.parametrize("fmt", ["orbax", "msgpack"])
def test_train_mfm_resumes_the_jax_snapshot(tmp_path, monkeypatch, fmt):
    if fmt == "msgpack":
        monkeypatch.setattr(jax_checkpoint, "save_checkpoint",
                            functools.partial(jax_checkpoint.save_checkpoint,
                                              use_orbax=False))
    out = str(tmp_path / "jax")
    want = jtrainers.train_mfm(
        *_data(), CFG, seed=SEED, logger=JaxLogger(echo=False),
        snapshot=jax_cli.make_autosnapshot(out, "t", CFG, 2))
    ck = f"{out}/ckpt_auto_t"
    state, meta = restore_checkpoint(ck)
    assert (meta["format"], meta["step"]) == (fmt, 2)
    assert state["opt_state"]["lr"] == meta["config"]["_resume_lr"]
    got = trainers.train_mfm(*_data(), _port_cfg(), seed=SEED,
                             logger=RunLogger(echo=False), device="cpu",
                             resume_from=ck)
    assert [e["epoch"] for e in got["history"]] == [2]
    g, w = got["history"][0], want["history"][2]
    assert np.float32(g["lr"]) == np.float32(w["lr"])
    for k in ("train_loss", "valid"):
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **LOSSES)
    assert got["step"] == want["step"] == 3
    np.testing.assert_allclose(got["best_valid"], want["best_valid"],
                               **LOSSES)
    _close_params(got["params"], want["params"])
    _close_metrics(got["metrics"], want["metrics"])
