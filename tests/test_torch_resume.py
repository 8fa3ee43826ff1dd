"""Resuming a run: each of the port's five trainers against the JAX
package's, checkpoint and resume alike.

The port trains from the JAX init (handed to it through
``convert.from_numpy``) with every dropout 0 and ``lda_mmd`` 0, so no
random draw weighs on the run, and saves a checkpoint as the ``mosi``
command's ``--save-ckpt`` does (the best parameters with the last Adam
state and step, ``_resume_lr`` and ``_resume_best_valid``) or, for the
beta-VAE, as ``--ckpt-every``'s auto-snapshot does; the same state is
written in the JAX package's format (Adam's flat moments put in its
order), and each package resumes it to a longer run. The port's resumed
run is held to the JAX package's under the trainer-against-trainer
tolerances (``tests/test_torch_trainers_vs_jax.py``: parameters within
1e-6, losses within 1e-5 relative, every lr equal), and its epochs go on
from the checkpoint's step. Beside that, on the port
alone: the chunked and host loops resume to the same bits; a
``--ckpt-every 2`` snapshot resumed mid-run has the uninterrupted run's
chunk boundaries and epochs; Adam's state is copied into its buffers,
which keep their addresses."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from factorized_tpu import trainers as jtrainers
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.utils.checkpoint import save_checkpoint as jax_save
from factorized_tpu.utils.logging import RunLogger as JaxLogger
from factorized_tpu_torch import cli, train, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
from factorized_tpu_torch.utils.logging import RunLogger

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)

CFG = JaxConfig(
    seqlength=5, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0, za_to_fa_dropout=0.0,
    zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0, lda_mmd=0.0, batchsize=16)
SEED = 4


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


def _data(seed=SEED, n_train=40, n_valid=12, n_test=12):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        return X, (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)).astype(
            np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def _from_jax_init(monkeypatch, model_type, jcfg):
    """The port's trainers start from the JAX trainer's initial
    parameters (``init`` on the second half of ``split(PRNGKey(SEED))``)."""
    ik = jax.random.split(jax.random.PRNGKey(SEED))[1]
    init = jax.tree.map(np.asarray, jax_get_model(model_type)[0](ik, jcfg))

    class FromJax:
        def __init__(self, cfg, *, seed, device, model_type):
            self._tree = from_numpy(init, device)

        def tree(self):
            return self._tree

    monkeypatch.setattr(trainers, "MFM", FromJax)


def _save_like_the_cli(save, path, res, cfg):
    """``--save-ckpt``: the trainer's (best) parameters, its last Adam
    state and step, the last lr and the best validation loss."""
    meta = cfg.to_dict()
    meta["_resume_lr"] = res["history"][-1]["lr"]
    if "best_valid" in res:
        meta["_resume_best_valid"] = res["best_valid"]
    kw = {"use_orbax": False} if save is jax_save else {}
    save(path, res["params"], opt_state=res["opt_state"], step=res["step"],
         config=meta, **kw)


def _as_jax_checkpoint(port_path, jax_path):
    """The port's checkpoint at ``port_path`` in the JAX package's
    (msgpack) format: the same parameters, step and config, and Adam's
    count and moments, each moment cut into the parameters' leaves in the
    port's order and flattened again in the JAX package's
    (``ravel_pytree``)."""
    state, meta = restore_checkpoint(port_path)
    params = state["params"]

    def tree_of(vec):
        at = 0

        def build(t):
            nonlocal at
            out = {}
            for k, v in t.items():
                if isinstance(v, dict):
                    out[k] = build(v)
                else:
                    out[k] = vec[at:at + v.numel()].reshape(v.shape).numpy()
                    at += v.numel()
            return out

        return build(params)

    st = state["opt_state"]["state"]
    opt_state = optax.ScaleByAdamState(
        count=jnp.asarray(int(st["count"]), jnp.int32),
        mu=ravel_pytree(tree_of(st["mu"]))[0],
        nu=ravel_pytree(tree_of(st["nu"]))[0])
    jax_save(jax_path, tree_of(torch.cat([v.reshape(-1) for v in
                                          train.leaves(params)])),
             opt_state=opt_state, step=meta["step"], config=meta["config"],
             use_orbax=False)
    return jax_path


def _port(name, cfg, **kw):
    return getattr(trainers, name)(*_data(), MFMConfig.from_dict(
        cfg.to_dict()), seed=SEED, device="cpu",
        logger=RunLogger(echo=False), **kw)


def _jax(name, cfg, **kw):
    return getattr(jtrainers, name)(*_data(), cfg, seed=SEED,
                                    logger=JaxLogger(echo=False), **kw)


def _assert_same_resumed_runs(got, want):
    assert len(got["history"]) == len(want["history"]) > 0
    for g, w in zip(got["history"], want["history"]):
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


@pytest.mark.parametrize("name,model_type,kw", [
    ("train_mfm", "mfm", {}),
    ("train_mfm_missing", "missing", dict(missing=1)),
    ("train_mfm_test_zeros", "mfm", dict(zeros=1)),
    ("train_mfm_ablation", "m_a", dict(model_type="m_a")),
], ids=["mfm", "missing", "zeros", "m_a"])
def test_a_resumed_trainer_matches_the_jax_packages(tmp_path, monkeypatch,
                                                    name, model_type, kw):
    """2 epochs and ``--save-ckpt``, then ``--resume`` to 4."""
    jcfg = CFG.replace(num_epochs=2, **kw)
    _from_jax_init(monkeypatch, model_type, jcfg)
    ports = str(tmp_path / "port")
    _save_like_the_cli(save_checkpoint, ports, _port(name, jcfg), jcfg)
    jaxs = _as_jax_checkpoint(ports, str(tmp_path / "jax"))
    longer = jcfg.replace(num_epochs=4)
    got = _port(name, longer, resume_from=ports)
    want = _jax(name, longer, resume_from=jaxs)
    _assert_same_resumed_runs(got, want)
    assert [e["epoch"] for e in got["history"]] == [2, 3]
    assert got["step"] == 4
    np.testing.assert_allclose(got["best_valid"], want["best_valid"],
                               **LOSSES)


def test_a_resumed_beta_vae_matches_the_jax_packages(tmp_path, monkeypatch):
    """The beta-VAE at one epoch a stage, auto-snapshotted every 2 epochs
    (``--ckpt-every 2``): the snapshot at whole-run epoch 2; resumed at 3
    epochs a stage, that step falls inside stage 1, which goes on for one
    epoch, and stage 2 runs its three; the snapshots count the epochs of
    both stages."""
    jcfg = CFG.replace(model_type="kl_ef", num_epochs=1)
    _from_jax_init(monkeypatch, "kl_ef", jcfg)
    _port("train_beta_vae", jcfg, snapshot=cli.make_autosnapshot(
        str(tmp_path / "port"), "t", MFMConfig.from_dict(jcfg.to_dict()), 2))
    ports = str(tmp_path / "port" / "ckpt_auto_t")
    assert restore_checkpoint(ports)[1]["step"] == 2
    jaxs = _as_jax_checkpoint(ports, str(tmp_path / "jax"))
    longer = jcfg.replace(num_epochs=3)
    got = _port("train_beta_vae", longer, resume_from=ports,
                snapshot=cli.make_autosnapshot(
                    str(tmp_path / "again"), "t",
                    MFMConfig.from_dict(longer.to_dict()), 2))
    want = _jax("train_beta_vae", longer, resume_from=jaxs)
    _assert_same_resumed_runs(got, want)
    assert [(e["stage"], e["epoch"]) for e in got["history"]] == [
        (1, 2), (2, 0), (2, 1), (2, 2)]
    assert got["step"] == 6
    assert restore_checkpoint(str(tmp_path / "again" / "ckpt_auto_t"))[1][
        "step"] == 6


def _setups(monkeypatch):
    """The ``_Setup`` of each trainer run, kept."""
    made = []

    class Setup(trainers._Setup):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(trainers, "_Setup", Setup)
    return made


def test_the_chunked_and_host_loops_resume_to_the_same_bits(tmp_path,
                                                             monkeypatch):
    """One port checkpoint resumed through each loop (dropout on): the
    same history, parameters and Adam state bit for bit; the host loop
    records the host scheduler's lr, the chunked loop its float32."""
    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(
        num_epochs=2, att1_drop=0.5, zl_to_fl_dropout=0.2)
    path = str(tmp_path / "ck")
    _save_like_the_cli(save_checkpoint, path, _port("train_mfm", cfg), cfg)
    made = _setups(monkeypatch)
    runs = []
    for host in ("1", ""):
        monkeypatch.setenv("FACTORIZED_TPU_HOST_LOOP", host)
        runs.append(_port("train_mfm", cfg.replace(num_epochs=5),
                          resume_from=path))
    host, chunked = runs
    for h, c in zip(host["history"], chunked["history"]):
        assert (h["epoch"], h["train_loss"], h["valid"]) == (
            c["epoch"], c["train_loss"], c["valid"])
        assert np.float32(h["lr"]) == np.float32(c["lr"])
    assert [e["epoch"] for e in chunked["history"]] == [2, 3, 4]
    for a, b in zip(train.leaves(host["params"]),
                    train.leaves(chunked["params"])):
        assert torch.equal(a, b)
    assert torch.equal(made[0].optimizer.state, made[1].optimizer.state)
    assert int(made[0].optimizer.count) == int(made[1].optimizer.count) == 10


def test_a_mid_run_snapshot_resumes_on_the_uninterrupted_boundaries(
        tmp_path, monkeypatch):
    """``--ckpt-every 2`` over 5 epochs chunks them [0, 2), [2, 4), [4, 5)
    and snapshots at 2 and 4. A run stopped after 3 epochs leaves the
    snapshot of epoch 2; resumed to 5, it runs [2, 4), [4, 5): the same
    boundaries, and (no random draw weighing) the same epochs bit for
    bit."""
    cfg = MFMConfig.from_dict(CFG.to_dict())
    calls = []
    run = train.ChunkedLoop.run

    def recorded(self, n):
        calls.append(n)
        return run(self, n)

    monkeypatch.setattr(train.ChunkedLoop, "run", recorded)

    def trained(epochs, out, **kw):
        c = cfg.replace(num_epochs=epochs)
        return _port("train_mfm", c, snapshot=cli.make_autosnapshot(
            str(tmp_path / out), "t", c, 2), **kw)

    full = trained(5, "full")
    assert calls == [2, 2, 1]
    trained(3, "stopped")
    ckpt = str(tmp_path / "stopped" / "ckpt_auto_t")
    assert restore_checkpoint(ckpt)[1]["step"] == 2
    del calls[:]
    resumed = trained(5, "resumed", resume_from=ckpt)
    assert calls == [2, 1]
    assert resumed["history"] == full["history"][2:]
    assert restore_checkpoint(str(tmp_path / "resumed" / "ckpt_auto_t"))[1][
        "step"] == 4


def test_load_state_dict_copies_into_the_buffers():
    """The restored leaves, moments, count and lr go into the flat
    buffers: every address stays, the leaves' views see the new values.
    The moments are read in the key order of the tree handed with them
    (a checkpoint's own parameters; the JAX package's are sorted) and laid
    out in the optimizer's."""
    params = {"a": {"w": torch.zeros(3, 2)}, "b": torch.zeros(4)}
    opt = train.FlatAdam(params, 1e-3)
    before = [opt.state.data_ptr(), params["a"]["w"].data_ptr(),
              opt.mu.data_ptr(), opt.count.data_ptr()]
    n = opt.flat.numel()
    state = {"state": {"count": torch.tensor(7, dtype=torch.int32),
                       "mu": torch.arange(n, dtype=torch.float32),
                       "nu": torch.ones(n)}, "lr": 2e-3}
    tree = {"b": torch.full((4,), 2.0), "a": {"w": torch.ones(3, 2)}}
    opt.load_state_dict(state, params=tree)
    assert before == [opt.state.data_ptr(), params["a"]["w"].data_ptr(),
                      opt.mu.data_ptr(), opt.count.data_ptr()]
    assert torch.equal(params["a"]["w"], torch.ones(3, 2))
    assert torch.equal(params["b"], torch.full((4,), 2.0))
    # the tree's order is b (4 floats), then a/w (6): the optimizer's a/w, b
    mu = state["state"]["mu"]
    assert torch.equal(opt.mu, torch.cat([mu[4:], mu[:4]]))
    assert torch.equal(opt.tree_of(opt.mu)["b"], mu[:4])
    assert int(opt.count) == 7 and float(opt.lr) == np.float32(2e-3)
    with pytest.raises(ValueError, match="mu"):
        opt.load_state_dict({**state, "state": {**state["state"],
                                                "mu": torch.zeros(n + 1)}})


def test_a_checkpoint_without_the_optimizer_state_is_refused(tmp_path):
    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(num_epochs=1)
    res = _port("train_mfm", cfg)
    save_checkpoint(str(tmp_path / "ck"), res["params"], step=1)
    with pytest.raises(ValueError, match="no optimizer state"):
        _port("train_mfm", cfg.replace(num_epochs=2),
              resume_from=str(tmp_path / "ck"))


def test_a_resumed_run_draws_anew(tmp_path):
    """Resumed, the generator is seeded from (seed, start epoch): with
    dropout on, the resumed epochs differ from the uninterrupted run's,
    as the JAX package's do (``fold_in``), and a second resume gives the
    same bits."""
    cfg = MFMConfig.from_dict(CFG.to_dict()).replace(att1_drop=0.5,
                                                     num_epochs=2)
    path = str(tmp_path / "ck")
    res = _port("train_mfm", cfg)
    _save_like_the_cli(save_checkpoint, path, res, cfg)
    a = _port("train_mfm", cfg.replace(num_epochs=3), resume_from=path)
    b = _port("train_mfm", cfg.replace(num_epochs=3), resume_from=path)
    assert a["history"] == b["history"]
    assert os.path.isdir(path)
