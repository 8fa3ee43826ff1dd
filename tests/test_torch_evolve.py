"""The evolving search (``--evolve``, successive halving with lanes
recycled, ``parallel/multiconfig.py``): the port's
``train_evolving_search`` against the JAX package's on the CPU, then the
port alone.

Against the JAX package: 4 configs of one seed, 2 rungs of 2 epochs,
``cull_frac`` 0.5, each lane its config's lr. Both packages'
``resample_values`` are wrapped so that a draw keeps its lr and loss
weights but has every dropout and ``lda_mmd`` at 0 (no draw weighs on
the run; the template has them at 0 too); the first inits are the JAX
package's ``split(PRNGKey(seed), K)`` and the recycled lanes' its
``fold_in(PRNGKey(seed + 1000 * (rung + 1)), lane)`` inits, handed to the
port through ``params=`` and ``init_lanes=``. Held, with the bounds of
``tests/test_torch_trainers_vs_jax.py``: each rung's scores (1e-5
relative) and culls, the explored count, the best record (its rung,
config, best validation number, metrics and parameters), every epoch's
lrs, the record kinds of the two logs, and ``check --dir`` printing the
same lines over either log as the JAX package's ``check``. The JAX
search also writes its rung-boundary snapshot (Orbax), which the port
resumes to the JAX search's second rung, best record and parameters.

The port alone: a recycle leaves the survivors' parameters bit for bit
those of a run with no recycle; it resets the lane's records and Adam
(a recycled lane's first step is a fresh ``LaneAdam``'s); a run killed at
a rung boundary and resumed from its snapshot is the uninterrupted run;
the refusals (another lane count on resume, ``defer_scoring`` without
``return_state``, ``prep=`` of other arrays); no cull at ``cull_frac``
0.
"""

import io
import json
import random
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from factorized_tpu import check as jcheck
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.parallel import multiconfig as jmc
from factorized_tpu.utils.logging import RunLogger as JaxLogger
from factorized_tpu_torch import check
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.parallel import multiconfig as mc
from factorized_tpu_torch.parallel import multiseed
from factorized_tpu_torch.train import LaneAdam
from factorized_tpu_torch.utils.logging import RunLogger

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
METRICS = dict(rtol=0.0, atol=1e-6)
CORR = dict(rtol=1e-5, atol=1e-6)
SEED = 21
N_CONFIGS, RUNGS = 4, 2

# the small config of tests/test_torch_multiseed.py: no draw that weighs
CFG = JaxConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0, gamma2_drop=0.0,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0, za_to_fa_dropout=0.0,
    zv_to_fv_dropout=0.0, fy_to_y_dropout=0.0, lda_mmd=0.0, out_drop=0.0,
    batchsize=16, num_epochs=2)
# the draws' fields that weigh through a random draw
QUIET = {f: 0.0 for f in mc.HP_FIELDS if f.endswith("drop")
         or f.endswith("dropout") or f == "lda_mmd"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data(n_train=48, n_valid=16, n_test=20):
    rng = np.random.default_rng(SEED)

    def split(n):
        X = rng.normal(size=(n, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        y = X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)
        return X, y.astype(np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def _quiet(module):
    real = module.resample_values

    def resample(template, dataset, rng=None):
        return real(template, dataset, rng).replace(**QUIET)

    return resample


def _port_cfg():
    return MFMConfig.from_dict(CFG.to_dict())


def _jax_inits():
    """The JAX package's first inits of the K lanes and its recycled
    lanes' inits, as the port's ``params=`` and ``init_lanes=``."""
    init = jax_get_model("mfm")[0]
    keys = jax.random.split(jax.random.PRNGKey(SEED), N_CONFIGS)
    first = from_numpy(jax.tree.map(np.asarray, jax.vmap(
        lambda k: init(k, CFG))(keys)))

    def recycled(lanes, rung):
        base = jax.random.PRNGKey(SEED + 1000 * (rung + 1))
        ks = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            np.asarray(lanes, np.int32))
        return from_numpy(jax.tree.map(np.asarray, jax.vmap(
            lambda k: init(k, CFG))(ks)))

    return first, recycled


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's search and the port's, their logs under one
    directory each, the JAX run's lrs a chunk."""
    out = tmp_path_factory.mktemp("evolve")
    seen = {"lrs": []}
    real_run = jmc.ConfigBucketProgram.run_epochs

    def spy_run(self, valid_metric):
        run = real_run(self, valid_metric)

        def spy(*a):
            res = run(*a)
            seen["lrs"].extend(np.asarray(res[-1]))
            return res

        return spy

    kw = dict(n_configs=N_CONFIGS, rungs=RUNGS, cull_frac=0.5,
              seeds_per_config=1, seed=SEED, use_config_lr=True)
    jlog = JaxLogger(str(out / "jax"), run_id="mosi_evolve0", echo=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmc, "resample_values", _quiet(jmc))
        mp.setattr(jmc.ConfigBucketProgram, "run_epochs", spy_run)
        want = jmc.train_evolving_search(*_data(), CFG, "mosi",
                                         rng=random.Random(SEED),
                                         logger=jlog,
                                         ckpt_dir=str(out / "jax_ck"), **kw)
    jlog.close()
    first, recycled = _jax_inits()
    plog = RunLogger(str(out / "port"), run_id="mosi_evolve0", echo=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mc, "resample_values", _quiet(mc))
        got = mc.train_evolving_search(*_data(), _port_cfg(), "mosi",
                                       rng=random.Random(SEED), logger=plog,
                                       params=first, init_lanes=recycled,
                                       device="cpu", **kw)
    plog.close()
    return got, want, seen, out


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_the_search_is_the_jax_search(runs):
    got, want, seen, out = runs
    assert got["explored_configs"] == want["explored_configs"] == 6
    assert len(got["rungs"]) == len(want["rungs"]) == RUNGS
    for g, w in zip(got["rungs"], want["rungs"]):
        assert g["rung"] == w["rung"]
        assert g["culled"] == w["culled"]
        assert g["configs"] == w["configs"]
        np.testing.assert_allclose(g["scores"], w["scores"], **LOSSES)
    assert len(got["rungs"][0]["culled"]) == 2
    gb, wb = got["best"], want["best"]
    assert (gb["rung"], gb["config"]) == (wb["rung"], wb["config"])
    np.testing.assert_allclose(gb["best_valid"], wb["best_valid"], **LOSSES)
    assert set(gb["metrics"]) == set(wb["metrics"])
    for k, v in wb["metrics"].items():
        np.testing.assert_allclose(gb["metrics"][k], v, err_msg=k,
                                   **(CORR if k == "corr" else METRICS))
    flat_j = to_state_dict(jax.tree.map(np.asarray, want["params"]))
    flat_p = to_state_dict(got["params"])
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].numpy(), v, err_msg=k,
                                   **PARAMS)
    # every epoch's lrs, a recycled lane's its new config's
    port_epochs = [r for r in _records(out / "port" / "mosi_evolve0.jsonl")
                   if r["kind"] == "epoch"]
    assert len(seen["lrs"]) == len(port_epochs) == RUNGS * CFG.num_epochs
    lrs = [np.float32(r["lr"]) for r in got["rungs"][1]["configs"]]
    assert np.array_equal(seen["lrs"][-1], lrs)
    assert not np.array_equal(seen["lrs"][0], seen["lrs"][-1])


def test_the_logs_read_as_the_jax_logs(runs, capsys):
    """The same record kinds and keys in both logs; ``check --dir`` prints
    over either log what the JAX package's ``check`` prints."""
    _, _, _, out = runs
    got = _records(out / "port" / "mosi_evolve0.jsonl")
    want = _records(out / "jax" / "mosi_evolve0.jsonl")
    assert [(r["kind"], sorted(r)) for r in got] == [
        (r["kind"], sorted(r)) for r in want]
    assert [r["kind"] for r in got].count("final") == RUNGS
    for side in ("port", "jax"):
        for fn in (check.check_dir, jcheck.check_dir):
            buf = io.StringIO()
            with redirect_stdout(buf):
                fn(str(out / side))
            printed = buf.getvalue()
            if fn is check.check_dir:
                port_printed = printed
            else:
                assert printed == port_printed
        assert "mae: " in printed


def test_the_port_resumes_the_jax_snapshot(runs):
    """The JAX search's snapshot at its rung boundary (Orbax, after the
    culls' recycles: the live, per-lane best and overall best parameters,
    the ``(K, P)`` Adam state, the search's RNG and books) resumed by the
    port, with another RNG: the second rung's culls and scores, the best
    record and its parameters are the JAX search's."""
    from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

    _, want, _, out = runs
    ck = str(out / "jax_ck")
    state, meta = restore_checkpoint(ck)
    assert meta["format"] == "orbax"
    assert meta["config"]["_ev"]["rung_next"] == 1
    assert sorted(state["params"]) == ["best", "live", "overall"]
    _, recycled = _jax_inits()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mc, "resample_values", _quiet(mc))
        got = mc.train_evolving_search(
            *_data(), _port_cfg(), "mosi", n_configs=N_CONFIGS, rungs=RUNGS,
            cull_frac=0.5, seeds_per_config=1, seed=SEED,
            use_config_lr=True, rng=random.Random(999),
            logger=RunLogger(echo=False), resume_from=ck,
            init_lanes=recycled, device="cpu")
    assert got["explored_configs"] == want["explored_configs"]
    assert len(got["rungs"]) == len(want["rungs"]) == RUNGS
    for g, w in zip(got["rungs"], want["rungs"]):
        assert (g["rung"], g["culled"], g["configs"]) == (
            w["rung"], w["culled"], w["configs"])
        np.testing.assert_allclose(g["scores"], w["scores"], **LOSSES)
    gb, wb = got["best"], want["best"]
    assert (gb["rung"], gb["config"]) == (wb["rung"], wb["config"])
    np.testing.assert_allclose(gb["best_valid"], wb["best_valid"], **LOSSES)
    for k, v in wb["metrics"].items():
        np.testing.assert_allclose(gb["metrics"][k], v, err_msg=k,
                                   **(CORR if k == "corr" else METRICS))
    flat_j = to_state_dict(jax.tree.map(np.asarray, want["params"]))
    flat_p = to_state_dict(got["params"])
    assert set(flat_p) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_allclose(flat_p[k].numpy(), v, err_msg=k,
                                   **PARAMS)


# ---- the port alone --------------------------------------------------------

def _program():
    _, apply_fn = get_model("mfm")
    return mc.ConfigBucketProgram(apply_fn, _port_cfg(), torch.Generator())


def _rung(cfgs, state=None, program=None, rung=0, **kw):
    return mc.train_config_bucket(
        *_data(), cfgs, seeds_per_config=1, seed=SEED, state_in=state,
        return_state=True, key_salt=777 + rung, program=program,
        logger=RunLogger(echo=False), device="cpu", **kw)


def test_a_recycle_leaves_the_survivors_as_they_were():
    """Two lanes with dropout on, rung 2 after recycling lane 1 and after
    no cull: lane 0's parameters, Adam state and best record equal bit
    for bit; lane 1 restarted."""
    cfg = _port_cfg().replace(att1_drop=0.25, zl_to_fl_dropout=0.5,
                              lda_mmd=1.0)
    new = cfg.replace(lda_xl=3.0, att1_drop=0.0)
    runs = []
    for recycle in (True, False):
        r1 = _rung([cfg, cfg])
        st = r1["state"]
        if recycle:
            mc.recycle_lanes(st, [1], cfg=cfg, init=get_model("mfm")[0],
                             lrs_new=[0.005], seed=99)
        r2 = _rung([cfg, new if recycle else cfg], state=st, rung=1)
        opt = r2["state"]["opt"]
        runs.append((opt.flat.clone(), opt.mu.clone(), opt.count.clone(),
                     r2["results"]))
    (fa, ma, ca, ra), (fb, mb, cb, rb) = runs
    assert torch.equal(fa[0], fb[0]) and torch.equal(ma[0], mb[0])
    assert ra[0]["best_valid"] == rb[0]["best_valid"]
    assert not torch.equal(fa[1], fb[1])
    assert ca.tolist() == [2 * 3 * 2, 2 * 3] and cb.tolist() == [12, 12]


def test_a_recycle_resets_the_lane_and_its_adam():
    """``recycle_lanes`` sets the lane's lr, clears its scheduler and best
    record, zeroes its Adam state and count and writes its seeded init;
    the survivor keeps its own. Then the recycled lane's first step is a
    fresh ``LaneAdam``'s on the same parameters and batch."""
    cfgs = [_port_cfg(), _port_cfg().replace(lda_xa=2.0)]
    st = _rung(cfgs)["state"]
    opt = st["opt"]
    keep = {k: v.clone() for k, v in (("flat", opt.flat), ("mu", opt.mu),
                                      ("count", opt.count))}
    init = get_model("mfm")[0]
    mc.recycle_lanes(st, [1], cfg=cfgs[0], init=init, lrs_new=[0.02],
                     seed=7)
    assert float(opt.lr[1]) == pytest.approx(0.02)
    assert float(st["sched"]["lr"][1]) == pytest.approx(0.02)
    assert float(st["sched"]["best"][1]) == np.inf
    assert int(st["sched"]["bad"][1]) == int(st["sched"]["cooldown"][1]) == 0
    assert float(st["best"][1]) == np.inf and not bool(st["has_best"][1])
    assert int(opt.count[1]) == 0 and not opt.mu[1].any()
    assert not opt.nu[1].any()
    fresh = init(torch.Generator().manual_seed(multiseed._run_seed(7, 1)),
                 cfgs[0])
    assert torch.equal(opt.flat[1], opt.flatten(multiseed.stack_lanes(
        [fresh], "cpu"))[0])
    assert torch.equal(opt.flat[0], keep["flat"][0])
    assert torch.equal(opt.mu[0], keep["mu"][0])
    assert int(opt.count[0]) == int(keep["count"][0]) > 0
    assert np.isfinite(float(st["best"][0])) and bool(st["has_best"][0])
    # the next step of lane 1 is a fresh optimizer's first step
    prog = st["loop"].programs
    x, y = st["loop"].batches[0][0], st["loop"].batches[1][0]
    hps = st["hps"]
    fresh_opt = LaneAdam(opt.tree_of(opt.flat), opt.lr.clone())
    for o, params in ((opt, st["params"]), (fresh_opt, fresh_opt.params)):
        prog.generator.manual_seed(3)
        prog.step(params, o, x, y, hps=hps)
    assert torch.equal(opt.flat[1], fresh_opt.flat[1])
    assert torch.equal(opt.mu[1], fresh_opt.mu[1])
    assert torch.equal(opt.nu[1], fresh_opt.nu[1])
    assert opt.count.tolist() == [int(keep["count"][0]) + 1, 1]


def test_no_cull_at_cull_frac_zero():
    res = mc.train_evolving_search(
        *_data(), _port_cfg(), "mosi", n_configs=2, rungs=2, cull_frac=0.0,
        seeds_per_config=1, seed=2, logger=RunLogger(echo=False),
        device="cpu")
    assert res["explored_configs"] == 2
    assert all(r["culled"] == [] for r in res["rungs"])


def test_a_search_killed_at_a_rung_resumes_to_the_same_run(tmp_path,
                                                           monkeypatch):
    """Killed in rung 2 of 3, resumed from the rung-boundary snapshot
    with another RNG: the same draws, culls, scores, best record and
    parameters bit for bit; another lane count is refused."""
    kw = dict(n_configs=4, rungs=3, cull_frac=0.5, seeds_per_config=1,
              seed=SEED, device="cpu")
    cfg = _port_cfg().replace(att1_drop=0.25, zv_to_fv_dropout=0.5,
                              lda_mmd=1.0)
    ra = mc.train_evolving_search(*_data(), cfg, "mosi",
                                  logger=RunLogger(echo=False),
                                  rng=random.Random(SEED), **kw)
    ck = str(tmp_path / "ev_ck")
    real = mc.train_config_bucket
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("killed in rung 2")
        return real(*a, **k)

    monkeypatch.setattr(mc, "train_config_bucket", dying)
    with pytest.raises(RuntimeError, match="killed in rung 2"):
        mc.train_evolving_search(*_data(), cfg, "mosi",
                                 logger=RunLogger(echo=False),
                                 rng=random.Random(SEED), ckpt_dir=ck, **kw)
    monkeypatch.setattr(mc, "train_config_bucket", real)
    log = []

    class Log(RunLogger):
        def text(self, *a):
            log.append(a)

    rb = mc.train_evolving_search(*_data(), cfg, "mosi", logger=Log(),
                                  rng=random.Random(999), resume_from=ck,
                                  **kw)
    assert any("resumed evolving search" in str(a[0]) for a in log)
    assert rb["explored_configs"] == ra["explored_configs"] == 8
    assert rb["rungs"] == ra["rungs"]
    assert rb["best"]["config"] == ra["best"]["config"]
    assert rb["best"]["metrics"] == ra["best"]["metrics"]
    for k, v in to_state_dict(ra["params"]).items():
        assert torch.equal(to_state_dict(rb["params"])[k], v), k
    with pytest.raises(ValueError, match="holds 4 lanes but this run has 2"):
        mc.train_evolving_search(*_data(), cfg, "mosi",
                                 logger=RunLogger(echo=False),
                                 resume_from=ck, **dict(kw, n_configs=2))


def test_the_bucket_refuses_what_the_jax_one_refuses():
    cfgs = [_port_cfg(), _port_cfg()]
    with pytest.raises(ValueError, match="defer_scoring"):
        mc.train_config_bucket(*_data(), cfgs, defer_scoring=True,
                               device="cpu")
    prep = multiseed.prepare_bucket_data(*_data(), cfgs[0], seed=SEED,
                                         device="cpu")
    bad = list(_data())
    bad[1] = bad[1] + 1.0  # the same X, other train labels
    with pytest.raises(ValueError, match="different dataset"):
        mc.train_config_bucket(*bad, cfgs, seed=SEED, prep=prep,
                               device="cpu")
    with pytest.raises(ValueError, match="distinct shape"):
        mc.train_config_bucket(*_data(), [cfgs[0], cfgs[0].replace(
            memsize=8)], device="cpu")
    with pytest.raises(ValueError, match="supports model types"):
        mc.train_config_bucket(*_data(), [cfgs[0].replace(
            model_type="kl_ef")], device="cpu")


def test_lane_adam_without_a_reset_steps_as_one_shared_count():
    """With no lane reset, each lane's update is bit for bit the update of
    a count shared by the lanes (``LaneAdam`` before its counts were
    per lane): the moments, the bias corrections and the step."""
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 4, 5, generator=g),
              "b": {"c": torch.randn(3, 7, generator=g)}}
    opt = LaneAdam(params, [1e-3, 5e-3, 2e-2])
    flat, mu, nu = (opt.flat.clone(), torch.zeros_like(opt.flat),
                    torch.zeros_like(opt.flat))
    count = torch.zeros((), dtype=torch.int32)
    B1, B2, EPS = LaneAdam.B1, LaneAdam.B2, LaneAdam.EPS
    for _ in range(5):
        grad = torch.randn(opt.grad.shape, generator=g)
        opt.grad.copy_(grad)
        opt.step()
        mu.mul_(B1).add_(grad, alpha=1.0 - B1)
        nu.mul_(B2).addcmul_(grad, grad, value=1.0 - B2)
        count.add_(1)
        c = count.to(torch.float32)
        u = (mu / (1.0 - B1 ** c)).div_((nu / (1.0 - B2 ** c)).sqrt_().add_(
            EPS))
        flat.sub_(u.mul_(opt.lr[:, None]))
        assert torch.equal(opt.flat, flat) and torch.equal(opt.mu, mu)
        assert torch.equal(opt.nu, nu)
    assert opt.count.tolist() == [5, 5, 5]
    # a snapshot from before the per-lane counts restores to every lane
    state = opt.state_dict()
    state["state"]["count"] = torch.tensor(5, dtype=torch.int32)
    opt.load_state_dict(state)
    assert opt.count.tolist() == [5, 5, 5]
