"""Lanes of seeds (``--seeds K``): the port's ``train_mfm_multiseed``
against the JAX package's, run for run, on the CPU.

The same data, the same K initial parameter sets (the JAX package's
per-lane init, ``MultiSeedProgram.vinit``, handed to the port) and a
configuration that leaves no randomness in the run: every dropout rate 0
and ``lda_mmd`` 0 (the MMD samples then weigh nothing). Both packages
train 3 epochs of K = 3 lanes; the port's run must give (the bounds of
``tests/test_torch_trainers_vs_jax.py``):

- every lane's scored parameters within 1e-6 (absolute) of the JAX
  run's;
- each epoch's per-lane train and validation numbers within 1e-5
  relative, and every lane's lr equal (float32, as both record it);
- each seed's test metrics within 1e-6, the correlation within 1e-6
  plus 1e-5 relative; the best seed equal.

Covered: ``mfm``, ``kl`` and the four ablations ``m_a`` to ``m_d``
(``m_c``'s correlation NaN in both packages, held equal as NaN); ``m_b``
once more with a scheduler
that cuts the lr in some lanes only (patience 0 and a relative threshold
of 1e-3 in both packages); the
accuracy-keeping mode at K = 2. Then the port alone: the lane plain
kernels against their single-lane twins lane by lane, a snapshot at
epoch 2 resumed against the uninterrupted run bit for bit (the meta with
the JAX package's field names), the JAX run's own snapshot of the K = 2
case (Orbax, at epoch 2) resumed by the port against the rest of the JAX
run, the refusals of the trainer and of the
command with the JAX package's messages, and ``mosi --seeds 2 --mode best
--epochs 2 --device cpu`` through the command.
"""

import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from factorized_tpu import cli as jax_cli
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.parallel import multiseed as jms
from factorized_tpu_torch import cli
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
from factorized_tpu_torch.parallel import multiseed
from factorized_tpu_torch.utils.scheduler import plateau_step

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
METRICS = dict(rtol=0.0, atol=1e-6)
CORR = dict(rtol=1e-5, atol=1e-6)
EPOCHS = 3
SEED = 3

# the small config of tests/test_torch_trainers_vs_jax.py: no draw that
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

# case: (model type, lanes, valid metric, the scheduler's arguments in
# place of its defaults); "cut": patience 0 and a relative threshold of
# 1e-3, which the lanes' first improvements straddle (7.5e-4, 8.7e-4 and
# 1.4e-3), so the lr of two lanes is cut at epoch 1 and of the third at 2
CASES = {"mfm": ("mfm", 3, "loss", None), "kl": ("kl", 3, "loss", None),
         "m_a": ("m_a", 3, "loss", None), "m_b": ("m_b", 3, "loss", None),
         "m_c": ("m_c", 3, "loss", None), "m_d": ("m_d", 3, "loss", None),
         "cut": ("m_b", 3, "loss", dict(patience=0, threshold=1e-3)),
         "accuracy": ("m_d", 2, "accuracy", None)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class Recorder:
    """A run logger of either package that keeps what it is told."""

    def __init__(self):
        self.lines, self.records = [], []

    def text(self, *args):
        self.lines.append(args)

    def record(self, kind, **fields):
        self.records.append(dict(kind=kind, **fields))

    def close(self):
        pass

    def kind(self, kind):
        return [r for r in self.records if r["kind"] == kind]


def _cfg(case):
    name, _, metric, _ = CASES[case]
    cfg = CFG.replace(model_type=name)
    if metric == "accuracy":
        cfg = cfg.replace(task="classification", output_dim=2)
    return cfg


def _data(case, n_train=48, n_valid=16, n_test=20):
    rng = np.random.default_rng(SEED)
    classify = CASES[case][2] == "accuracy"

    def split(n):
        X = rng.normal(size=(n, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        y = X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)
        return X, ((y >= 0).astype(np.int64) if classify
                   else y.astype(np.float32))

    return (*split(n_train), *split(n_valid), *split(n_test))


def _jax_run(case, ckpt_dir=None):
    """The JAX package's run of ``case``, its K initial parameter sets, the
    lanes' scored parameters (what its test predict reads) and each
    epoch's lrs (the chunk program's third output); with ``ckpt_dir``, a
    snapshot every 2 epochs there (its own ``save_checkpoint``)."""
    name, K, metric, sched = CASES[case]
    jcfg = _cfg(case)
    init = jax.tree.map(np.asarray, jms.MultiSeedProgram.vinit(
        jax_get_model(name)[0], jcfg, jax.random.PRNGKey(SEED), K))
    seen = {"lrs": []}
    real_init, real_run = jms._init_lane_programs, \
        jms.MultiSeedProgram.run_epochs

    def spy_init(self, *a, **kw):
        real_init(self, *a, **kw)
        predict = self.predict

        def spy_predict(params, x):
            seen["lanes"] = jax.tree.map(np.asarray, params)
            return predict(params, x)

        self.predict = spy_predict

    def spy_run(self, valid_metric):
        run = real_run(self, valid_metric)

        def spy(*a):
            out = run(*a)
            seen["lrs"].extend(np.asarray(out[-1]))
            return out

        return spy

    log = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jms, "_init_lane_programs", spy_init)
        mp.setattr(jms.MultiSeedProgram, "run_epochs", spy_run)
        if sched is not None:
            mp.setattr(jms, "plateau_step", functools.partial(
                jms.plateau_step, **sched))
        res = jms.train_mfm_multiseed(*_data(case), jcfg, n_seeds=K,
                                      model_type=name, seed=SEED,
                                      logger=log, valid_metric=metric,
                                      ckpt_dir=ckpt_dir,
                                      ckpt_every=2 if ckpt_dir else 0)
    seen["snapshot"] = ckpt_dir
    return init, res, seen, log


def _port_run(case, init, **kw):
    name, K, metric, sched = CASES[case]
    log = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        if sched is not None:
            mp.setattr(multiseed, "plateau_step", functools.partial(
                plateau_step, **sched))
        res = multiseed.train_mfm_multiseed(
            *_data(case), MFMConfig.from_dict(_cfg(case).to_dict()),
            n_seeds=K, model_type=name, seed=SEED, logger=log,
            valid_metric=metric, params=from_numpy(init), device="cpu", **kw)
    return res, log


# the case whose JAX run also writes a snapshot, which the port resumes
SNAPSHOT_CASE = "accuracy"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run and one port run of each case, shared by the module."""
    cache = {}

    def get(case):
        if case not in cache:
            init, want, seen, jlog = _jax_run(
                case, str(tmp_path_factory.mktemp("jax_snapshot"))
                if case == SNAPSHOT_CASE else None)
            got, plog = _port_run(case, init)
            cache[case] = (got, plog, want, seen, jlog, init)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_are_the_jax_runs(case, runs):
    got, plog, want, seen, jlog, _ = runs(case)
    K = CASES[case][1]
    # each epoch's per-lane numbers and lrs
    g_epochs, w_epochs = plog.kind("epoch"), jlog.kind("epoch")
    assert [r["epoch"] for r in g_epochs] == [r["epoch"] for r in w_epochs] \
        == list(range(EPOCHS))
    for g, w in zip(g_epochs, w_epochs):
        for k in ("train_loss", "valid_loss"):
            assert len(g[k]) == K
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **LOSSES)
    assert len(seen["lrs"]) == EPOCHS
    for g, w in zip(got["history"], seen["lrs"]):
        assert np.array_equal(np.float32(g["lrs"]), w), (g["lrs"], w)
    if case == "cut":  # the scheduler cut some lanes, not others
        assert len(set(got["history"][1]["lrs"])) > 1
    # every lane's scored parameters
    flat_j = to_state_dict(seen["lanes"])
    flat_p = to_state_dict(got["lane_params"])
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].numpy(), v, err_msg=k,
                                   **PARAMS)
    # each seed's scores and the pick
    assert got["best_seed"] == want["best_seed"]
    assert got["step"] == want["step"]
    for g, w in zip(got["results"], want["results"]):
        assert g["seed_index"] == w["seed_index"]
        np.testing.assert_allclose(g["best_valid"], w["best_valid"],
                                   **LOSSES)
        assert set(g["metrics"]) == set(w["metrics"])
        for k, v in w["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], v, err_msg=k,
                                       **(CORR if k == "corr" else METRICS))
    g_final, w_final = plog.kind("final")[0], jlog.kind("final")[0]
    assert g_final["best_seed"] == w_final["best_seed"]
    assert len(g_final["per_seed"]) == len(w_final["per_seed"]) == K
    # the best seed's parameters are what --save-ckpt saves
    for k, v in to_state_dict(got["params"]).items():
        np.testing.assert_array_equal(
            v.numpy(), flat_p[k][got["best_seed"]].numpy())


def test_lane_plain_kernels_are_the_single_lane_ones_lane_by_lane():
    """Each lane plain version equals its single-lane twin run on each
    lane, bit for bit (the lane wrappers' CPU route)."""
    g = torch.Generator().manual_seed(0)
    K, t, n, dims = 3, 4, 5, [3, 2]
    H = sum(dims)

    def r(*shape):
        return torch.randn(shape, generator=g)

    h0, c0, wsum, b = r(K, n, H), r(K, n, H), r(K, H, 4 * H), r(K, 4 * H)
    lanes = cuda_lstm.decoder_lstm_fwd_lanes(h0, c0, wsum, b, t, dims)
    for k in range(K):
        for got, want in zip(lanes, cuda_lstm.decoder_lstm_plain(
                h0[k], c0[k], wsum[k], b[k], t)):
            assert torch.equal(got[k], want)
    allh, allc, gates = lanes
    dallh = r(K, t, n, H)
    lanes = cuda_lstm.decoder_lstm_bwd_lanes(wsum, gates, allc, dallh, dims)
    for k in range(K):
        for got, want in zip(lanes, cuda_lstm.decoder_lstm_bwd_plain(
                wsum[k], gates[k], allc[k], dallh[k])):
            assert torch.equal(got[k], want)
    xp, wh = r(K, t, n, 4 * H), r(K, H, 4 * H)
    lanes = cuda_lstm.multi_lstm_fwd_lanes(xp, wh, dims, True)
    for k in range(K):
        for got, want in zip(lanes, cuda_lstm.multi_lstm_plain(xp[k], wh[k],
                                                               True)):
            assert torch.equal(got[k], want)
    dh = r(K, n, H)
    got = cuda_lstm.multi_lstm_bwd_lanes(lanes[3], wh, lanes[2], dh, dims)
    for k in range(K):
        assert torch.equal(got[k], cuda_lstm.multi_lstm_bwd_plain(
            lanes[3][k], wh[k], lanes[2][k], dh[k]))
    # the encode: a stacked K-lane set of MFM's encode operands
    from factorized_tpu_torch.models import mfm

    cfg = MFMConfig.from_dict(CFG.to_dict())
    x = r(cfg.seqlength, n, cfg.d_total)
    ops = [mfm.kernel_operands(mfm.MFM(cfg, seed=k, device="cpu").tree(),
                               x, cfg)[0] for k in range(K)]
    xp = torch.stack([o[0] for o in ops])
    w = {m: torch.stack([o[1][m] for o in ops]) for m in ops[0][1]}
    z_tot, h_dims = ops[0][2], ops[0][3]
    masks = torch.stack([cuda_mfn.make_dropout_masks(
        g, cfg.seqlength, n, cuda_mfn.sizes(ops[0][1])[:4],
        (0.5, 0.5, 0.5, 0.5)) for _ in range(K)])
    eval_lanes = cuda_mfn.mfm_encode_lanes(xp, w, z_tot, h_dims)
    res_lanes = cuda_mfn.mfm_encode_res_lanes(xp, masks, w, z_tot, h_dims)
    dh = r(K, n, sum(h_dims))
    dmem = r(K, n, cfg.memsize)
    dxp, dw = cuda_mfn.mfm_encode_bwd_lanes(xp, w, *res_lanes[2:], dh, dmem,
                                            z_tot, h_dims)
    for k in range(K):
        wk = {m: v[k] for m, v in w.items()}
        for got, want in zip(eval_lanes, cuda_mfn.mfm_encode_plain(
                xp[k], wk, z_tot)):
            assert torch.equal(got[k], want)
        single = cuda_mfn.mfm_encode_res_plain(xp[k], masks[k], wk, z_tot)
        for got, want in zip(res_lanes, single):
            assert torch.equal(got[k], want)
        want_dxp, want_dw = cuda_mfn.mfm_encode_bwd_plain(
            xp[k], wk, *single[2:], dh[k], dmem[k], z_tot)
        assert torch.equal(dxp[k], want_dxp)
        for m in cuda_mfn.W_NAMES:
            assert torch.equal(dw[m][k], want_dw[m])


def test_a_resumed_snapshot_is_the_uninterrupted_run(runs, tmp_path):
    """A snapshot at epoch 2 (``ckpt_every`` 2) resumed for the third
    epoch equals the uninterrupted run bit for bit; its meta holds the
    JAX package's fields."""
    from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

    *_, init = runs("mfm")
    ck = str(tmp_path / "ck")
    full, _ = _port_run("mfm", init, ckpt_dir=ck, ckpt_every=2)
    _, meta = restore_checkpoint(ck)
    assert meta["step"] == 2
    mcfg = meta["config"]
    assert mcfg["_ms_n_seeds"] == 3
    assert len(mcfg["_ms_best_valid"]) == len(mcfg["_ms_lrs"]) == 3
    assert [sorted(d) for d in mcfg["_ms_sched"]] == [
        ["bad", "best", "cooldown", "lr"]] * 3
    resumed, log = _port_run("mfm", init, resume_from=ck)
    assert ("resumed 3-seed state from " + ck + " at epoch 2",) in log.lines
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert resumed["history"][0] == full["history"][2]
    for k, v in to_state_dict(full["lane_params"]).items():
        assert torch.equal(to_state_dict(resumed["lane_params"])[k], v), k
    np.testing.assert_equal(resumed["results"], full["results"])
    with pytest.raises(ValueError, match="holds 3 seeds but --seeds 2"):
        multiseed.train_mfm_multiseed(
            *_data("mfm"), MFMConfig.from_dict(_cfg("mfm").to_dict()),
            n_seeds=2, seed=SEED, logger=Recorder(), resume_from=ck,
            device="cpu")


def test_the_port_resumes_the_jax_snapshot(runs):
    """The JAX run of the K = 2 case wrote a snapshot at epoch 2 (Orbax,
    its ``(K, P)`` Adam state in ``ravel_pytree``'s order, the lanes'
    lrs, scheduler and best records); the port resumes it for the third
    epoch: that epoch's per-lane numbers and lrs, every lane's scored
    parameters and each seed's scores are the JAX run's."""
    from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

    _, _, want, seen, jlog, init = runs(SNAPSHOT_CASE)
    K = CASES[SNAPSHOT_CASE][1]
    state, meta = restore_checkpoint(seen["snapshot"])
    assert (meta["format"], meta["step"]) == ("orbax", 2)
    assert state["opt_state"]["state"]["mu"].shape[0] == K == 2
    assert state["opt_state"]["lr"] == meta["config"]["_ms_lrs"]
    got, plog = _port_run(SNAPSHOT_CASE, init, resume_from=seen["snapshot"])
    assert (f"resumed {K}-seed state from {seen['snapshot']} at epoch 2",) \
        in plog.lines
    g_epochs, w_epochs = plog.kind("epoch"), jlog.kind("epoch")
    assert [r["epoch"] for r in g_epochs] == [2]
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(g_epochs[0][k], w_epochs[2][k],
                                   err_msg=k, **LOSSES)
    assert np.array_equal(np.float32(got["history"][0]["lrs"]),
                          seen["lrs"][2])
    flat_j = to_state_dict(seen["lanes"])
    flat_p = to_state_dict(got["lane_params"])
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].numpy(), v, err_msg=k,
                                   **PARAMS)
    assert got["best_seed"] == want["best_seed"]
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_allclose(g["best_valid"], w["best_valid"],
                                   **LOSSES)
        for k, v in w["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], v, err_msg=k,
                                       **(CORR if k == "corr" else METRICS))


@pytest.mark.parametrize("model_type", ["kl_ef", "missing", "s2s", "bm"])
def test_the_trainer_refuses_what_the_jax_one_refuses(model_type):
    data = _data("mfm")
    with pytest.raises(ValueError) as want:
        jms.train_mfm_multiseed(*data, CFG, n_seeds=2,
                                model_type=model_type)
    with pytest.raises(ValueError) as got:
        multiseed.train_mfm_multiseed(
            *data, MFMConfig.from_dict(CFG.to_dict()), n_seeds=2,
            model_type=model_type, device="cpu")
    assert str(got.value) == str(want.value)


def _small_mosi(*a, **kw):
    """A cut of the synthetic MOSI set (325 floats a step, 20 steps): two
    training batches, the loaders of both packages replaced by it."""
    rng = np.random.default_rng(0)
    out = []
    for n in (64, 24, 24):
        out += [rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32)]
    return tuple(out)


@pytest.mark.parametrize("argv", [
    ["--type", "kl_ef"], ["--missing", "1"], ["--zeros", "1"]],
    ids=["kl_ef", "missing", "zeros"])
def test_the_command_refuses_with_the_jax_message(argv, monkeypatch,
                                                   tmp_path):
    monkeypatch.setattr(cli, "load_dataset", _small_mosi)
    monkeypatch.setattr(jax_cli, "load_dataset", _small_mosi)
    common = ["mosi", "--seeds", "2", "--mode", "best", *argv, "--epochs",
              "1"]
    with pytest.raises(SystemExit) as got:
        cli.main([*common, "--device", "cpu", "--out",
                  str(tmp_path / "port")])
    with pytest.raises(SystemExit) as want:
        jax_cli.main([*common, "--out", str(tmp_path / "jax")])
    assert str(got.value) == str(want.value)
    assert "is only supported for model types" in str(got.value)


def test_the_seeds_command_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``mosi --seeds 2 --mode best --epochs 2 --device cpu`` through the
    command (the synthetic set cut to two batches): the run id, each
    epoch's two lanes, a ``final`` record with ``per_seed`` and
    ``best_seed``, and ``check --dir`` printing the best of the seeds."""
    monkeypatch.setattr(cli, "load_dataset", _small_mosi)
    out = tmp_path / "runs"
    assert cli.main(["mosi", "--seeds", "2", "--mode", "best", "--epochs",
                     "2", "--device", "cpu", "--out", str(out),
                     "--save-ckpt"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["ckpt_mosi_0",
                                                     "mosi_0.jsonl"]
    records = [json.loads(line) for line in
               (out / "mosi_0.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in records] == ["config", "epoch", "epoch",
                                            "final"]
    assert all(len(r["train_loss"]) == 2 for r in records[1:3])
    final = records[-1]
    assert len(final["per_seed"]) == 2 and final["best_seed"] in (0, 1)
    capsys.readouterr()
    assert cli.main(["check", "--dir", str(out)]) == 0
    best = min(m["mae"] for m in final["per_seed"])
    assert f"mae: {best}" in capsys.readouterr().out.splitlines()
    meta = json.loads((out / "ckpt_mosi_0" / "meta.json").read_text())
    assert meta["config"]["_resume_best_valid"] == pytest.approx(
        min(r["valid_loss"][final["best_seed"]] for r in records[1:3]))
    assert Path(out / "ckpt_mosi_0" / "state.pt").exists()
