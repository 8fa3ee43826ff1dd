"""Each trainer of the port against the JAX package's, run for run.

The same data, the same initial parameters (the JAX init, handed to the
port through ``convert.from_numpy``) and a configuration that leaves no
randomness in the run: every dropout rate 0 and ``lda_mmd`` 0 (the MMD
sample then weighs nothing). Both packages train a few epochs through
their chunked loops; the port's must give:

- the parameters it returns within 1e-6 (absolute) of the JAX trainer's;
- each epoch's train and validation losses within 1e-5 relative;
- every epoch's ``lr`` equal: both chunked loops record the float32 lr
  the step read;
- the test metrics within 1e-6, the correlation within 1e-6 plus 1e-5
  relative.

Covered: ``train_mfm`` (``mfm``),
``train_beta_vae`` (both stages), ``train_mfm_missing``,
``train_mfm_test_zeros`` and ``train_mfm_ablation`` for ``m_a``..``m_d``
(``m_d`` once more with a scheduler that reduces the lr).
"""

import jax
import numpy as np
import pytest
import torch

from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.utils.logging import RunLogger as JaxLogger
from factorized_tpu.utils.scheduler import ReduceLROnPlateau as JaxPlateau
from factorized_tpu_torch import trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.scheduler import ReduceLROnPlateau

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
METRICS = dict(rtol=0.0, atol=1e-6)
# the Pearson correlation of the test score, over 20 predictions that
# spread little after a few epochs (a std of 5e-4 for train_beta_vae),
# moves by 1.3e-6 where y_hat moves by one ulp: it is held within 1e-6
# plus 1e-5 relative
CORR = dict(rtol=1e-5, atol=1e-6)
EPOCHS = 3

# the small config of tests/test_torch_train.py with no random draw that
# weighs on the run
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0, za_to_fa_dropout=0.0,
    zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0, lda_mmd=0.0,
    batchsize=16, num_epochs=EPOCHS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data(seed, n_train=48, n_valid=16, n_test=20):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        return X, (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)).astype(
            np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def _jax_init(model_type, jcfg, seed):
    """The JAX trainer's initial parameters: ``init`` on the second half
    of ``split(PRNGKey(seed))``."""
    ik = jax.random.split(jax.random.PRNGKey(seed))[1]
    return jax.tree.map(np.asarray, jax_get_model(model_type)[0](ik, jcfg))


def _run_both(monkeypatch, name, model_type, jcfg, seed=3, scheduler=None):
    """The JAX trainer ``name`` and the port's on the same data and
    initial parameters; ``scheduler`` replaces both packages'
    ``ReduceLROnPlateau`` (a factory of the lr and the class)."""
    data = _data(seed)
    init = _jax_init(model_type, jcfg, seed)

    class FromJax:
        def __init__(self, cfg, *, seed, device, model_type):
            self._tree = from_numpy(init, device)

        def tree(self):
            return self._tree

    monkeypatch.setattr(trainers, "MFM", FromJax)
    monkeypatch.delenv("FACTORIZED_TPU_HOST_LOOP", raising=False)
    if scheduler is not None:
        monkeypatch.setattr(jtrainers, "ReduceLROnPlateau",
                            lambda lr: scheduler(lr, JaxPlateau))
        monkeypatch.setattr(trainers, "ReduceLROnPlateau",
                            lambda lr: scheduler(lr, ReduceLROnPlateau))
    want = getattr(jtrainers, name)(*data, jcfg, seed=seed,
                                    logger=JaxLogger(echo=False))
    got = getattr(trainers, name)(*data, MFMConfig.from_dict(jcfg.to_dict()),
                                  seed=seed, device="cpu",
                                  logger=RunLogger(echo=False))
    return got, want


def _assert_same_runs(got, want):
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        assert g["lr"] == w["lr"], (g, w)
        assert g.get("stage") == w.get("stage")
        for k in ("train_loss", "valid"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **LOSSES)
    assert got["step"] == want["step"]
    flat_j = to_state_dict(jax.tree.map(np.asarray, want["params"]))
    flat_p = to_state_dict(got["params"])
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].detach().numpy(), v, err_msg=k,
                                   **PARAMS)
    metrics_j, metrics_p = want["metrics"], got["metrics"]
    if "mae" not in metrics_j:  # keyed by condition
        assert list(metrics_p) == list(metrics_j)
    else:
        metrics_j, metrics_p = {"": metrics_j}, {"": metrics_p}
    for tag, m in metrics_j.items():
        assert set(metrics_p[tag]) == set(m)
        for k, v in m.items():
            np.testing.assert_allclose(
                metrics_p[tag][k], v, err_msg=f"{tag} {k}",
                **(CORR if k == "corr" else METRICS))


@pytest.mark.parametrize("name,model_type,kw", [
    ("train_mfm", "mfm", {}),
    ("train_beta_vae", "kl_ef", dict(model_type="kl_ef")),
    ("train_mfm_missing", "missing", dict(missing=1)),
    ("train_mfm_test_zeros", "mfm", dict(zeros=1)),
    ("train_mfm_ablation", "m_a", dict(model_type="m_a")),
    ("train_mfm_ablation", "m_b", dict(model_type="m_b")),
    ("train_mfm_ablation", "m_c", dict(model_type="m_c")),
    ("train_mfm_ablation", "m_d", dict(model_type="m_d")),
], ids=["mfm", "beta_vae", "missing", "zeros", "m_a", "m_b", "m_c", "m_d"])
def test_trainer_matches_the_jax_trainer(monkeypatch, name, model_type, kw):
    got, want = _run_both(monkeypatch, name, model_type, CFG.replace(**kw))
    _assert_same_runs(got, want)
    if name == "train_beta_vae":
        assert [e["stage"] for e in got["history"]] == [1] * EPOCHS + \
            [2] * EPOCHS


def test_the_chunked_loops_record_the_same_float32_lr(monkeypatch):
    """A schedule that reduces the lr: the port's chunked history beside
    the JAX package's own ``_loop_chunked`` history, lr for lr."""
    def plateau(lr, cls):
        return cls(lr, patience=0, threshold=0.5, min_lr=2e-5)

    got, want = _run_both(monkeypatch, "train_mfm_ablation", "m_d",
                          CFG.replace(model_type="m_d", num_epochs=4),
                          seed=5, scheduler=plateau)
    _assert_same_runs(got, want)
    lrs = [e["lr"] for e in got["history"]]
    assert lrs[0] == float(np.float32(1e-3)) == 0.0010000000474974513
    assert min(lrs) < lrs[0]  # the schedule did reduce
