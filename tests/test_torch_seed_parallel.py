"""Lanes over ranks (the ``mesh=`` paths of ``factorized_tpu_torch/
parallel/multiseed.py`` and ``multiconfig.py``, the CLI's
``--seed-parallel`` and ``--multihost``) on the CPU, over gloo ranks on
127.0.0.1.

Two ranks on a 1-D ``"seed"`` mesh, spawned once for the module, train
K = 4 lanes of seeds with dropout and the MMD on, a bucket of two configs
x two seeds and a two-rung evolving search; four ranks on a ``("seed",
"batch")`` mesh of 2 x 2 train the K = 4 lanes data-parallel within each
lane group. Each equals the same run in one process within the bounds of
the port's other two-run comparisons (parameters 1e-6, losses 1e-5
relative); so do three ranks on the two-rank mesh that ``--seed-parallel``
sizes for 4 lanes, the third rank outside it taking rank 0's result. The
two-rank runs' snapshots (the lanes' at epoch 2, the search's at its rung
boundary; written by rank 0 in the layout of an unsharded run) resume in
one process to the uninterrupted runs. In the comparison with the JAX
package of ``tests/test_torch_multiseed.py`` (its config with no draw
that weighs, its data and seed), the two ranks' K = 4 lanes from the
JAX package's per-lane init equal the JAX package's own
``train_mfm_multiseed`` within the same bounds. K must divide the mesh, and the batch its ``batch``
axis, with the JAX package's messages; ``--seed-parallel`` sizes its mesh
by the JAX package's rule; ``--multihost`` joins the world before any
device is used.
"""

import json
import random
import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from factorized_tpu_torch import cli
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import (from_numpy, from_state_dict,
                                          to_state_dict)
from factorized_tpu_torch.parallel import multiconfig, multiseed, sharding
from factorized_tpu_torch.utils.logging import RunLogger
from torch_ranks import run_ranks

PARAMS = dict(rtol=0.0, atol=1e-6)
LOSSES = dict(rtol=1e-5, atol=0.0)
K = 4
CFG = MFMConfig(input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
                zy_size=5, zl_size=6, za_size=4, zv_size=5,
                fy_size=4, fl_size=5, fa_size=4, fv_size=3,
                att1_shape=8, att2_shape=8, gamma1_shape=8,
                gamma2_shape=8, seqlength=5, batchsize=8, num_epochs=2)
# no random draw that weighs: a resumed run re-seeds its generator
CALM = CFG.replace(att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0,
                   gamma2_drop=0.0, zl_to_fl_dropout=0.0,
                   za_to_fa_dropout=0.0, zv_to_fv_dropout=0.0,
                   lda_mmd=0.0, num_epochs=3)




def _c_run():
    """C's run (``tests/test_torch_multiseed.py``, case ``mfm``): its
    config (every dropout 0, ``lda_mmd`` 0), data and seed, in the JAX
    package's config class."""
    import test_torch_multiseed as c

    return c._cfg("mfm"), c._data("mfm"), c.SEED


def _data():
    rng = np.random.default_rng(0)

    def split(n):
        X = rng.normal(size=(n, CFG.seqlength, CFG.d_total)).astype(
            np.float32)
        return X, X[:, -1, :3].sum(1).astype(np.float32)

    return (*split(32), *split(12), *split(10))


def _quiet():
    return RunLogger(echo=False)


def _lanes(device, mesh=None, cfg=CFG, **kw):
    out = multiseed.train_mfm_multiseed(*_data(), cfg, n_seeds=K,
                                        logger=_quiet(), device=device,
                                        mesh=mesh, **kw)
    return _host(out)


def _host(out):
    keep = {k: v for k, v in out.items() if k != "state"}
    return pytree.tree_map(
        lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else a, keep)


def _bucket_cfgs():
    return [CFG, multiconfig.resample_values(CFG, "mosi", random.Random(1))]


def _bucket(device, mesh=None):
    return _host(multiconfig.train_config_bucket(
        *_data(), _bucket_cfgs(), seeds_per_config=2, logger=_quiet(),
        device=device, mesh=mesh))


def _evolve(device, mesh=None, **kw):
    return _host(multiconfig.train_evolving_search(
        *_data(), CFG.replace(num_epochs=1), "mosi", n_configs=2, rungs=2,
        seeds_per_config=2, logger=_quiet(), device=device, mesh=mesh,
        **kw))


def _two_ranks(device, ckpt, jax_init):
    mesh = sharding.make_mesh(axes=("seed",), device=device)
    c = np.load(f"{jax_init}/c_run.npz")
    jax_lanes = multiseed.train_mfm_multiseed(
        *(c[f"data{i}"] for i in range(6)),
        MFMConfig.from_dict(json.loads(str(c["cfg"]))), n_seeds=K,
        model_type="mfm", seed=int(c["seed"]), logger=_quiet(),
        device=device, mesh=mesh, params=from_numpy(from_state_dict(
            dict(np.load(f"{jax_init}/init.npz")))))
    return {"lanes": _lanes(device, mesh), "jax": _host(jax_lanes),
            "calm": _lanes(device, mesh, CALM, ckpt_dir=f"{ckpt}/lanes",
                           ckpt_every=2),
            "bucket": _bucket(device, mesh),
            "evolve": _evolve(device, mesh, ckpt_dir=f"{ckpt}/evolve")}


def _four_ranks(device):
    mesh = sharding.make_mesh(axes=("seed", "batch"), shape=(2, 2),
                              device=device)
    assert mesh.group("batch").size == 2
    return _lanes(device, mesh)


def _three_ranks(device):
    mesh = cli.seed_parallel_mesh(K, device)
    return {"member": mesh.member, "shape": mesh.shape,
            "lanes": _lanes(device, mesh)}


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded"))


class Recorder:
    """A run logger of the JAX package that keeps its records."""

    def __init__(self):
        self.records = []

    def text(self, *args):
        pass

    def record(self, kind, **fields):
        self.records.append(dict(kind=kind, **fields))

    def close(self):
        pass


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX package's K initial parameter sets of C's run
    (``MultiSeedProgram.vinit``, what its trainer starts from) and the
    run's config, data and seed, written for the ranks (which so import
    no JAX)."""
    import jax

    from factorized_tpu.models import get_model as jax_get_model
    from factorized_tpu.parallel import multiseed as jms

    jcfg, data, seed = _c_run()
    init = jms.MultiSeedProgram.vinit(jax_get_model("mfm")[0], jcfg,
                                      jax.random.PRNGKey(seed), K)
    path = tmp_path_factory.mktemp("jax_lanes")
    np.savez(path / "init.npz",
             **to_state_dict(jax.tree.map(np.asarray, init)))
    np.savez(path / "c_run.npz", cfg=json.dumps(jcfg.to_dict()), seed=seed,
             **{f"data{i}": a for i, a in enumerate(data)})
    return str(path)


@pytest.fixture(scope="module")
def two(snapshot, jax_init):
    return run_ranks(f"{__file__}:_two_ranks", 2,
                     {"ckpt": snapshot, "jax_init": jax_init}, timeout=240)


@pytest.fixture(scope="module")
def four():
    return run_ranks(f"{__file__}:_four_ranks", 4, timeout=240)


def _params_close(got, want):
    g, w = to_state_dict(got), to_state_dict(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **PARAMS)


def _same_lanes(got, want):
    assert [h["epoch"] for h in got["history"]] == [
        h["epoch"] for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["valids"], w["valids"], **LOSSES)
        np.testing.assert_allclose(g["lrs"], w["lrs"], **LOSSES)
    _params_close(got["lane_params"], want["lane_params"])
    for g, w in zip(got["results"], want["results"]):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["best_valid"], w["best_valid"],
                                   **LOSSES)
        for k, v in w["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], v, err_msg=k,
                                       rtol=1e-5, atol=1e-6)


def test_lanes_over_a_seed_axis_are_one_process(two):
    assert CFG.att1_drop > 0 and CFG.lda_mmd > 0
    want = _lanes("cpu")
    for got in two:
        _same_lanes(got["lanes"], want)
        assert got["lanes"]["best_seed"] == want["best_seed"]


def test_lanes_over_a_seed_axis_are_the_jax_packages(two):
    """The two ranks' lanes against the JAX package's unsharded
    ``train_mfm_multiseed`` (C's run: its init, no draw that weighs)."""
    import jax

    from factorized_tpu.parallel import multiseed as jms

    jcfg, data, seed = _c_run()
    log = Recorder()
    want = jms.train_mfm_multiseed(*data, jcfg, n_seeds=K, model_type="mfm",
                                   seed=seed, logger=log)
    epochs = [r for r in log.records if r["kind"] == "epoch"]
    assert len(epochs) == len(want["history"]) == jcfg.num_epochs
    for got in (r["jax"] for r in two):
        for g, w, r in zip(got["history"], want["history"], epochs,
                           strict=True):
            assert g["epoch"] == w["epoch"]
            np.testing.assert_allclose(g["valids"], w["valids"], **LOSSES)
            np.testing.assert_allclose(g["valids"], r["valid_loss"],
                                       **LOSSES)
        assert got["best_seed"] == want["best_seed"]
        for g, w in zip(got["results"], want["results"], strict=True):
            assert g["seed_index"] == w["seed_index"]
            np.testing.assert_allclose(g["best_valid"], w["best_valid"],
                                       **LOSSES)
            for k, v in w["metrics"].items():
                np.testing.assert_allclose(g["metrics"][k], v, err_msg=k,
                                           rtol=1e-5, atol=1e-6)
        _params_close(got["params"], jax.tree.map(np.asarray,
                                                  want["params"]))


def test_lanes_over_seed_and_batch_are_one_process(four):
    want = _lanes("cpu")
    for got in four:
        _same_lanes(got, want)


def test_a_rank_outside_the_mesh_gets_the_result():
    three = run_ranks(f"{__file__}:_three_ranks", 3, timeout=240)
    assert [r["member"] for r in three] == [True, True, False]
    assert all(r["shape"] == {"data": 2} for r in three)
    want = _lanes("cpu")
    for got in three:
        _same_lanes(got["lanes"], want)


def test_a_bucket_over_ranks_is_one_process(two):
    want = _bucket("cpu")
    for got in two:
        _same_lanes(got["bucket"], want)
        assert got["bucket"]["best_lane"] == want["best_lane"]


def _same_search(got, want):
    assert got["explored_configs"] == want["explored_configs"]
    for g, w in zip(got["rungs"], want["rungs"], strict=True):
        assert g["culled"] == w["culled"]
        np.testing.assert_allclose(g["scores"], w["scores"], **LOSSES)
    assert got["best"]["rung"] == want["best"]["rung"]
    assert got["best"]["config"] == want["best"]["config"]
    _params_close(got["params"], want["params"])


def test_an_evolving_search_over_ranks_is_one_process(two, snapshot):
    want = _evolve("cpu")
    for got in two:
        _same_search(got["evolve"], want)
    # its rung-boundary snapshot, gathered from both ranks, resumes here
    _same_search(_evolve("cpu", resume_from=f"{snapshot}/evolve"), want)


def test_calm_at_seed_3_parts_by_adams_first_step_alone():
    """ROADMAP C1, a conditioning limit and no fault: at ``CALM``, K = 4
    lanes from the JAX package's init at seed 3, the two packages' step-0
    gradients agree within 1e-5 of each leaf's largest (2.1e-6 at worst:
    float32 sums in other orders through the backward). Lane
    1's y head sees 8 rows whose fy are bit for bit equal and whose L1
    cotangents are +1/8 and -1/8, four each, so its ``fc1.w`` gradient is
    exactly 0; the port gets 0 there, the JAX package a rounding residue
    (8.75e-10 at [0, 3], under one ulp of the terms, about 0.027), and
    Adam's first step, ``g / (sqrt(v) + eps)`` at count 1, makes that
    8.05e-5 of the parameter, which later steps carry unchanged (the
    head's units see no gradient). The lanes part there and nowhere
    else."""
    import jax

    from factorized_tpu.config import MFMConfig as JaxConfig
    from factorized_tpu.models import get_model as jax_get_model
    from factorized_tpu.parallel import multiseed as jms
    from factorized_tpu.train import make_loss_fn, make_optimizer
    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.train import LaneAdam

    seed, lr, leaf, lane, at = 3, 1e-3, "fy_to_y.fc1.w", 1, (0, 3)
    jcfg = JaxConfig(**CALM.to_dict())
    init_fn, apply_fn = jax_get_model("mfm")
    init = jax.tree.map(np.asarray, jms.MultiSeedProgram.vinit(
        init_fn, jcfg, jax.random.PRNGKey(seed), K))
    prep = multiseed.prepare_bucket_data(*_data(), CALM, seed=seed,
                                         device="cpu")
    x, y = prep["Xb"][0], prep["yb"][0]
    keys = jax.random.split(jax.random.PRNGKey(0), K)
    loss = make_loss_fn(apply_fn, jcfg, "joint")
    grads = jax.jit(jax.vmap(jax.grad(lambda p, x, y, k: loss(p, x, y, k)[0]),
                             in_axes=(0, None, None, 0)))(
        init, x.numpy(), y.numpy(), keys)
    opt = make_optimizer("adam", lr)
    program = jms.MultiSeedProgram(apply_fn, jcfg, opt)
    stepped = program.epoch(init, jax.vmap(opt.init)(init), x.numpy()[None],
                            y.numpy()[None], keys,
                            np.full((K,), lr, np.float32))[0]
    params = multiseed.stack_lanes([multiseed.take_lane(from_numpy(init), k)
                                    for k in range(K)], "cpu")
    programs = multiseed.LanePrograms(get_model("mfm")[1], CALM,
                                      torch.Generator().manual_seed(seed))
    programs.step(params, LaneAdam(params, lr), x, y)
    got = to_state_dict(params)
    g_jax = to_state_dict(jax.tree.map(np.asarray, grads))
    p_jax = to_state_dict(jax.tree.map(np.asarray, stepped))
    for k, g in g_jax.items():
        assert (np.abs(got[k].grad.numpy() - g).max()
                <= LOSSES["rtol"] * np.abs(g).max()), k
    # lane 1's head: every fc1.w gradient 0 in the port, a residue under
    # one ulp of the terms in the JAX package, 8.75e-10 at its largest
    g_port, g_ref = got[leaf].grad.numpy()[lane], g_jax[leaf][lane]
    assert not g_port.any()
    assert np.abs(g_ref).max() == np.abs(g_ref[at]) > 8e-10
    assert np.abs(g_ref).max() < np.spacing(np.float32(0.027))
    # count 1: the bias-corrected m / (sqrt(v) + eps) is g / (|g| + eps),
    # elementwise the whole parting (to the parameters' rounding)
    want = lr * np.abs(g_ref) / (np.abs(g_ref) + 1e-8)
    parted = np.abs(got[leaf].detach().numpy() - p_jax[leaf])
    np.testing.assert_allclose(parted[lane], want, rtol=1e-3, atol=1e-7)
    assert want[at] > 10 * PARAMS["atol"]
    for k, p in p_jax.items():
        d = np.abs(got[k].detach().numpy() - p)
        if k == leaf:
            d[lane] = 0.0
        assert d.max() <= PARAMS["atol"], k


def test_a_sharded_snapshot_resumes_unsharded(two, snapshot):
    full = _lanes("cpu", cfg=CALM)
    _same_lanes(two[0]["calm"], full)
    resumed = _lanes("cpu", cfg=CALM, resume_from=f"{snapshot}/lanes")
    assert [h["epoch"] for h in resumed["history"]] == [2]
    np.testing.assert_allclose(resumed["history"][0]["valids"],
                               full["history"][2]["valids"], **LOSSES)
    _params_close(resumed["lane_params"], full["lane_params"])


def test_a_lanes_draws_are_vmaps_own():
    """Lane k draws the k-th of one (K, ...) draw, what ``vmap(randomness=
    "different")`` draws: the lanes' draws are not re-keyed."""
    from factorized_tpu_torch.ops import rows
    from factorized_tpu_torch.ops.core import dropout_mask

    gen = torch.Generator()

    def old(x):
        return dropout_mask(gen, (5, 3), 0.5) * x

    def new(idx, x):
        with rows.lane_index(K, idx):
            return dropout_mask(gen, (5, 3), 0.5) * x

    gen.manual_seed(3)
    want = torch.func.vmap(old, randomness="different")(torch.ones(K))
    gen.manual_seed(3)
    got = torch.func.vmap(new, randomness="same")(torch.arange(K),
                                                  torch.ones(K))
    assert torch.equal(got, want) and not torch.equal(got[0], got[1])


def _mesh_of(shape, axes=("seed",)):
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)),
                                 member=True, partial=False,
                                 coords={a: 0 for a in axes})


def test_the_lanes_must_divide_the_mesh():
    with pytest.raises(ValueError, match=r"n_seeds=4 must divide the mesh "
                                         r"'seed' axis \(3\)"):
        multiseed.train_mfm_multiseed(*_data(), CFG, n_seeds=4,
                                      device="cpu", mesh=_mesh_of((3,)))
    with pytest.raises(ValueError, match=r"lanes=4 \(configs x seeds\) must "
                                         r"divide the mesh 'data' axis"):
        multiconfig.train_config_bucket(*_data(), _bucket_cfgs(),
                                        seeds_per_config=2, device="cpu",
                                        mesh=_mesh_of((3,), ("data",)))
    with pytest.raises(ValueError, match=r"lanes=6 \(configs x seeds\)"):
        multiconfig.train_evolving_search(*_data(), CFG, "mosi",
                                          n_configs=3, seeds_per_config=2,
                                          device="cpu", mesh=_mesh_of((4,)))
    with pytest.raises(ValueError, match=r"batchsize=8 must divide the mesh "
                                         r"'batch' axis \(3\)"):
        multiseed.prepare_bucket_data(*_data(), CFG, device="cpu",
                                      mesh=_mesh_of((1, 3),
                                                    ("seed", "batch")))


@pytest.mark.parametrize("world,lanes,want,note", [
    (8, 4, ((8,), {"axes": ("seed", "batch"), "shape": (4, 2)}), False),
    (2, 4, ((), {}), False),
    (1, 8, ((), {}), False),
    (3, 4, ((2,), {}), True),
    (4, 6, ((3,), {}), True)])
def test_seed_parallel_sizes_its_mesh(world, lanes, want, note,
                                      monkeypatch, capsys):
    made = []
    monkeypatch.setattr(sharding, "world_size", lambda: world)
    monkeypatch.setattr(sharding, "make_mesh",
                        lambda *a, **kw: made.append((a, kw)))
    cli.seed_parallel_mesh(lanes, "cpu")
    args, kw = made[0]
    assert kw.pop("device") == "cpu"
    assert (args, kw) == want
    err = capsys.readouterr().err
    if note:
        assert (f"--seed-parallel: {lanes} lanes do not divide {world} "
                f"devices; using {want[0][0]} device(s) for this program"
                in err)
    else:
        assert not err


def test_multihost_joins_before_any_device_is_used(monkeypatch, tmp_path):
    import factorized_tpu_torch

    seen = []

    class Stop(Exception):
        pass

    def device(dev=None):
        seen.append(("device", dev))
        raise Stop

    monkeypatch.setattr(sharding, "init_distributed",
                        lambda **kw: seen.append(("join", kw)))
    monkeypatch.setattr(factorized_tpu_torch, "resolve_device", device)
    monkeypatch.setattr(cli, "load_dataset", lambda *a, **kw: seen.append(
        ("load",)) or (_ for _ in ()).throw(Stop))
    with pytest.raises(Stop):
        cli.main(["mosi", "--multihost", "--seeds", "2", "--seed-parallel",
                  "--device", "cpu", "--out", str(tmp_path)])
    assert seen[0] == ("join", {"device": "cpu"})
    assert len(seen) == 2
