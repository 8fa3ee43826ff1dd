"""The shape-bucketed search (``--bucket``, ``parallel/multiconfig.py``):
the port's ``train_config_bucket`` against the JAX package's, run for
run, on the CPU, and the port's pieces against the JAX package's.

The run: the same data and the same K initial parameter sets (the JAX
package's ``split(PRNGKey(seed), K)`` inits, handed to the port), K = 4
lanes (2 configs x 2 seeds) whose configs differ in their reconstruction
weights (``lda_xl/xa/xv``) and lr (``use_config_lr``; the multi-trait
case at one lr, 1e-3, as the ``multitrait`` command runs its lanes at
``--lr``), every dropout and ``lda_mmd`` 0, 3 epochs, so no draw weighs on the run (the two packages' draws
cannot match). The bounds are those of
``tests/test_torch_trainers_vs_jax.py``: every lane's scored parameters
within 1e-6; each epoch's per-lane losses within 1e-5 relative; every
lr equal; the metrics within 1e-6, the correlation within 1e-6 plus 1e-5
relative; the best lane equal. Covered: a scalar regression head and a
multi-trait head of 4 traits (ranked by ``mae_mean``), whose per-trait
correlations are held instead on the JAX lanes' own test predictions,
scored by the port (equal to 1e-12): after 3 epochs at 1e-3 a trait's
predictions spread by about 1e-2 and its correlation lies near 0, where
it moves by 6e-6 as the predictions move by 1e-7. Four traits, not three,
as the multi-trait trainer's run of
``tests/test_torch_predictor_trainers_vs_jax.py``: the L1 loss's mean
over a batch of 16 rows and 3 traits steps by an inexact 1/48, so where
one trait's signs balance in a batch its bias gradient is 0 in one
summation order and about 4e-9 in another, and Adam's first step (``g /
(|g| + 1e-8)``) turns that into a quarter of the lr; at 4 traits the
step, 1/64, is exact in both.

Then: ``shape_signature``, ``bucket_configs`` and ``hp_matrix`` against
the JAX functions on the same draws; a tensor dropout rate (0 the
identity exactly, 1 zeros, a ``(K,)`` rate under vmap each lane's keep
share); a diverged lane never wins; and the command's plumbing for the
dataset subcommands and ``multitrait`` against the JAX command's, both
packages' trainers replaced by recorders.
"""

import random

import jax
import numpy as np
import pytest
import torch

from factorized_tpu import cli as jax_cli
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import sample_search_config as jax_sample
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.parallel import multiconfig as jmc
from factorized_tpu_torch import cli
from factorized_tpu_torch.config import MFMConfig, sample_search_config
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.data import multitrait
from factorized_tpu_torch.ops.core import dropout, dropout_mask
from factorized_tpu_torch.parallel import multiconfig as mc

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
METRICS = dict(rtol=0.0, atol=1e-6)
CORR = dict(rtol=1e-5, atol=1e-6)
SEED = 5

# the small config of tests/test_torch_multiseed.py: no draw that weighs
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0, za_to_fa_dropout=0.0,
    zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0, lda_mmd=0.0,
    batchsize=16, num_epochs=3)
# two configs of one shape: other reconstruction weights and lr
CFGS = [CFG.replace(lda_xl=0.5, lda_xa=2.0, lda_xv=0.1, lr=0.004),
        CFG.replace(lda_xl=2.0, lda_xa=0.01, lda_xv=1.0, lr=0.01)]
# case: (output dim, seeds a config, each lane its config's lr)
CASES = {"scalar": (1, 2, True), "multitrait": (4, 2, False)}


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


def _data(out_dim, n_train=48, n_valid=16, n_test=20):
    rng = np.random.default_rng(SEED)

    def split(n):
        X = rng.normal(size=(n, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        y = np.stack([X[:, -1, t:t + 3].sum(1) for t in range(out_dim)], 1)
        y = y + 0.1 * rng.normal(size=y.shape)
        return X, (y[:, 0] if out_dim == 1 else y).astype(np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def _cfgs(case):
    return [c.replace(output_dim=CASES[case][0]) for c in CFGS]


def _jax_run(case):
    """The JAX package's bucket of ``case``: its K initial parameter sets,
    its result, the lanes' scored parameters and each epoch's lrs."""
    _, spc, config_lr = CASES[case]
    cfgs = _cfgs(case)
    K = len(cfgs) * spc
    keys = jax.random.split(jax.random.PRNGKey(SEED), K)
    init = jax.tree.map(np.asarray, jax.vmap(
        lambda k: jax_get_model("mfm")[0](k, cfgs[0]))(keys))
    seen = {"lrs": []}
    real_init, real_run = jmc._init_lane_programs, \
        jmc.ConfigBucketProgram.run_epochs

    def spy_init(self, *a, **kw):
        real_init(self, *a, **kw)
        predict = self.predict

        def spy_predict(params, x):
            seen["lanes"] = jax.tree.map(np.asarray, params)
            seen["preds"] = np.asarray(predict(params, x))
            return seen["preds"]

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
        mp.setattr(jmc, "_init_lane_programs", spy_init)
        mp.setattr(jmc.ConfigBucketProgram, "run_epochs", spy_run)
        res = jmc.train_config_bucket(*_data(cfgs[0].output_dim), cfgs,
                                      seeds_per_config=spc, seed=SEED,
                                      use_config_lr=config_lr, logger=log)
    return init, res, seen, log


def _port_cfgs(cfgs):
    return [MFMConfig.from_dict(c.to_dict()) for c in cfgs]


@pytest.fixture(scope="module")
def runs():
    """One JAX run and one port run of each case, shared by the module."""
    cache = {}

    def get(case):
        if case not in cache:
            init, want, seen, jlog = _jax_run(case)
            log = Recorder()
            got = mc.train_config_bucket(
                *_data(CASES[case][0]), _port_cfgs(_cfgs(case)),
                seeds_per_config=CASES[case][1], seed=SEED,
                use_config_lr=CASES[case][2], logger=log,
                params=from_numpy(init),
                device="cpu")
            cache[case] = (got, log, want, seen, jlog)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_the_bucket_is_the_jax_bucket(case, runs):
    got, plog, want, seen, jlog = runs(case)
    K = len(CFGS) * CASES[case][1]
    g_epochs, w_epochs = plog.kind("epoch"), jlog.kind("epoch")
    assert [r["epoch"] for r in g_epochs] == [r["epoch"] for r in w_epochs] \
        == list(range(CFG.num_epochs))
    for g, w in zip(g_epochs, w_epochs):
        for k in ("train_loss", "valid_loss"):
            assert len(g[k]) == K
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **LOSSES)
    # each lane its config's lr, as the JAX run's
    assert len(seen["lrs"]) == CFG.num_epochs
    for g, w in zip(got["history"], seen["lrs"]):
        assert np.array_equal(np.float32(g["lrs"]), w), (g["lrs"], w)
    assert got["history"][0]["lrs"] == pytest.approx(
        [0.004, 0.004, 0.01, 0.01] if CASES[case][2] else [1e-3] * K)
    flat_j = to_state_dict(seen["lanes"])
    flat_p = to_state_dict(got["lane_params"])
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].numpy(), v, err_msg=k,
                                   **PARAMS)
    assert got["best_lane"] == want["best_lane"]
    for g, w in zip(got["results"], want["results"]):
        assert (g["config_index"], g["seed_index"]) == (
            w["config_index"], w["seed_index"])
        np.testing.assert_allclose(g["best_valid"], w["best_valid"],
                                   **LOSSES)
        assert set(g["metrics"]) == set(w["metrics"])
        for k, v in w["metrics"].items():
            if k == "corr" and case == "multitrait":
                continue  # held below, on the JAX lanes' predictions
            np.testing.assert_allclose(g["metrics"][k], v, err_msg=k,
                                       **(CORR if k == "corr" else METRICS))
    if case == "multitrait":
        # the port's scoring of the JAX lanes' own test predictions is the
        # JAX package's, every trait's correlation included
        yte = _data(CASES[case][0])[5]
        for k, w in enumerate(want["results"]):
            m = mc._score_pred(seen["preds"][k], yte, _port_cfgs(CFGS)[0]
                               .replace(output_dim=4), 0.0, "ge")
            assert set(m) == set(w["metrics"])
            for key, v in w["metrics"].items():
                np.testing.assert_allclose(m[key], v, rtol=1e-12, atol=0,
                                           err_msg=key)
    g_final, w_final = plog.kind("final")[0], jlog.kind("final")[0]
    assert set(g_final) == set(w_final)
    assert (g_final["best_lane"], g_final["best_config_index"]) == (
        w_final["best_lane"], w_final["best_config_index"])
    for k, v in to_state_dict(got["params"]).items():
        np.testing.assert_array_equal(
            v.numpy(), flat_p[k][got["best_lane"]].numpy())


def test_signatures_buckets_and_matrix_are_the_jax_ones():
    """On the same search draws both packages group the same buckets and
    build the same (K, n_hp) matrix; the field lists are the JAX
    package's."""
    assert mc.HP_FIELDS == jmc.HP_FIELDS
    assert mc.SHAPE_FIELDS == jmc.SHAPE_FIELDS
    for dataset in ("mosi", "moud", "mmmo"):
        r = random.Random(11)
        got = [sample_search_config(dataset, r) for _ in range(12)]
        r = random.Random(11)
        want = [jax_sample(dataset, r) for _ in range(12)]
        # a shape repeated with other values shares the bucket
        got.append(got[0].replace(lda_mmd=3.0, att1_drop=0.1))
        want.append(want[0].replace(lda_mmd=3.0, att1_drop=0.1))
        assert [mc.shape_signature(c) for c in got] == [
            jmc.shape_signature(c) for c in want]
        assert mc.bucket_configs(got) == jmc.bucket_configs(want)
        assert mc.bucket_configs(got)[0][-1] == len(got) - 1
        np.testing.assert_array_equal(mc.hp_matrix(got, 2),
                                      jmc.hp_matrix(want, 2))


def test_a_tensor_rate_is_exact_at_0_and_1_and_a_lane_each_under_vmap():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 32, generator=g)
    assert torch.equal(dropout(x, torch.tensor(0.0), True, g), x)
    assert torch.equal(dropout_mask(g, (64, 32), torch.tensor(0.0)),
                       torch.ones(64, 32))
    for rate in (1.0, 1.5):
        out = dropout(x, torch.tensor(rate), True, g)
        assert torch.count_nonzero(out) == 0
    # eval mode and the float path are what they were
    assert torch.equal(dropout(x, torch.tensor(0.5), False, g), x)
    assert torch.equal(dropout(x, 0.0, True), x)
    a, b = (torch.Generator().manual_seed(3) for _ in range(2))
    kept = torch.rand((64, 32), generator=b) < 0.75
    assert torch.equal(dropout_mask(a, (64, 32), 0.25),
                       kept.to(torch.float32) * (1.0 / 0.75))
    # a (K,) rate under vmap: each lane keeps its own share, scaled
    rates = torch.tensor([0.0, 0.25, 0.5, 0.9])
    ones = torch.ones(4, 200, 100)

    def lane(x, r):
        return dropout(x, r, True, g)

    out = torch.func.vmap(lane, randomness="different")(ones, rates)
    assert torch.equal(out[0], ones[0])
    for k in range(1, 4):
        keep = (out[k] != 0).float().mean()
        assert abs(float(keep) - (1 - float(rates[k]))) < 0.01
        np.testing.assert_allclose(out[k][out[k] != 0].numpy(),
                                   1.0 / (1.0 - float(rates[k])), rtol=1e-6)


def test_a_diverged_lane_never_wins(monkeypatch):
    """A lane whose metrics are not finite is never the bucket's pick,
    though its ``mae`` compares lowest as a number would."""
    real = mc._score_pred
    calls = {"n": 0}

    def nan_first(*a):
        m = real(*a)
        if calls["n"] == 0:
            m = {k: float("nan") for k in m}
        calls["n"] += 1
        return m

    monkeypatch.setattr(mc, "_score_pred", nan_first)
    log = Recorder()
    res = mc.train_config_bucket(*_data(1), _port_cfgs(CFGS),
                                 seeds_per_config=1, seed=SEED, logger=log,
                                 device="cpu")
    assert np.isnan(res["results"][0]["metrics"]["mae"])
    assert res["best_lane"] == 1 == log.kind("final")[0]["best_lane"]


# ---- the command ---------------------------------------------------------

def _mosi(*a, **kw):
    rng = np.random.default_rng(0)
    out = []
    for n in (40, 16, 16):
        out += [rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32)]
    return tuple(out)


def _wide(*a, **kw):
    rng = np.random.default_rng(1)
    out = []
    for n in (40, 16, 16):
        out += [rng.normal(size=(n, 20, 410)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32)]
    return tuple(out)


def _traits(*a, **kw):
    rng = np.random.default_rng(2)
    out = []
    for n in (40, 16, 16):
        out += [rng.normal(size=(n, 20, 410)).astype(np.float32),
                rng.normal(size=(n, 4)).astype(np.float32)]
    return tuple(out)


@pytest.fixture
def recorded(monkeypatch):
    """Both packages' bucket and evolve trainers replaced by recorders,
    both loaders by the same arrays: {"port": calls, "jax": calls}, each
    call (trainer, the positional arguments after the data as dicts, the
    keyword arguments but the logger, the device and the rng)."""
    from factorized_tpu.data import multitrait as jmultitrait

    calls = {"port": [], "jax": []}

    def recorder(side, name):
        def train(*args, **kw):
            for k in ("logger", "device", "rng"):
                kw.pop(k, None)
            rest = [[c.to_dict() for c in a] if isinstance(a, list)
                    else a.to_dict() if hasattr(a, "to_dict") else a
                    for a in args[6:]]
            calls[side].append((name, rest, kw))
            if name == "train_config_bucket":
                return {"results": []}
            return {"explored_configs": kw["n_configs"], "best": {
                "metrics": {"mae": 1.0, "mae_mean": 1.0}, "rung": 0}}
        return train

    for side, mod in (("port", mc), ("jax", jmc)):
        for name in ("train_config_bucket", "train_evolving_search"):
            monkeypatch.setattr(mod, name, recorder(side, name))

    def load(name, *a, **kw):
        return _mosi() if name == "mosi" else _wide()

    monkeypatch.setattr(cli, "load_dataset", load)
    monkeypatch.setattr(jax_cli, "load_dataset", load)
    monkeypatch.setattr(multitrait, "get_data", _traits)
    monkeypatch.setattr(jmultitrait, "get_data", _traits)
    return calls


PLUMBING = {
    "mosi_bucket": ["mosi", "--mode", "search", "--bucket", "--trials", "6",
                    "--seeds", "2"],
    "moud_bucket": ["moud", "--mode", "search", "--bucket", "--trials", "5"],
    "mmmo_bucket_lr": ["mmmo", "--mode", "search", "--bucket", "--trials",
                       "4", "--lr", "0.003"],
    "mosi_evolve": ["mosi", "--mode", "search", "--evolve", "3", "--trials",
                    "4", "--seeds", "2", "--cull-frac", "0.25"],
    "you_evolve": ["you", "--mode", "search", "--evolve", "2", "--trials",
                   "3", "--type", "m_b"],
    "evolve_ckpt_resume": ["mosi", "--mode", "search", "--evolve", "2",
                           "--trials", "4", "--ckpt-every", "1", "--resume",
                           "some_ck"],
    "multitrait_bucket": ["multitrait", "--mode", "search", "--bucket",
                          "--trials", "3", "--seeds", "2"],
    "multitrait_evolve": ["multitrait", "--style", "iemocap", "--mode",
                          "search", "--evolve", "2", "--trials", "2"],
}


@pytest.mark.parametrize("run", list(PLUMBING))
def test_the_search_command_is_the_jax_command(run, recorded, tmp_path,
                                               capsys):
    """The same trainers called with the same configs (each bucket one
    shape, ``--epochs`` applied), seeds, lanes a config, lrs, thresholds,
    rungs, cull share, snapshot directory and resume path, the same run
    ids and records and the same printed lines."""
    import json

    argv = [*PLUMBING[run], "--epochs", "2", "--seed", "9"]
    assert cli.main([*argv, "--device", "cpu", "--out",
                     str(tmp_path / "port")]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    assert jax_cli.main([*argv, "--out", str(tmp_path / "jax")]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert port_lines == jax_lines
    got, want = recorded["port"], recorded["jax"]
    assert got and len(got) == len(want)
    for (gn, ga, gk), (wn, wa, wk) in zip(got, want):
        assert gn == wn
        gk = {k: (v.replace(str(tmp_path / "port"), "OUT")
                  if isinstance(v, str) else v) for k, v in gk.items()}
        wk = {k: (v.replace(str(tmp_path / "jax"), "OUT")
                  if isinstance(v, str) else v) for k, v in wk.items()}
        assert ga == wa and gk == wk
    name = got[0][0]
    if name == "train_config_bucket":
        assert sum(len(a[0]) for _, a, _ in got) == int(
            argv[argv.index("--trials") + 1])
        for _, (bucket, *_), _ in got:
            assert len({mc.shape_signature(MFMConfig.from_dict(c))
                        for c in bucket}) == 1
            assert all(c["num_epochs"] == 2 for c in bucket)
    else:
        assert got[0][2]["rungs"] == int(argv[argv.index("--evolve") + 1])

    def records(side):
        out = {}
        for path in sorted((tmp_path / side).glob("*.jsonl")):
            out[path.stem] = [{k: v for k, v in json.loads(line).items()
                               if k != "ts"}
                              for line in path.read_text().splitlines()]
        return out

    assert records("port") == records("jax")
    if run == "evolve_ckpt_resume":
        assert got[0][2]["ckpt_dir"] == str(
            tmp_path / "port" / "ckpt_auto_mosi_evolve0")
        assert got[0][2]["resume_from"] == "some_ck"
