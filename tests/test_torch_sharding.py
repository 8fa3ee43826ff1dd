"""The port's meshes and data- and tensor-parallel training
(``factorized_tpu_torch/parallel/sharding.py``) on the CPU.

The mesh's default 2-D shape is the JAX package's for n = 1..16, errors
included; a mesh wider than the world raises; ``init_distributed`` takes
its fields by the stated precedence and does nothing where a process
group exists; a tensor-parallel rule that does not divide raises with the
JAX package's wording. Two gloo ranks on 127.0.0.1, spawned once for the
module (``tests/torch_ranks.py``), then hold: ``full_set``'s padding
and gather; a data-parallel epoch against the port's one-process epoch
on the whole batch, with dropout and the MMD on (``mfm``) and with the
KLD's sum over rows (``kl``); a data-parallel epoch from the JAX
package's initial parameters against the JAX package's single-device
``TrainProgram.epoch``, with no random draw that weighs (every dropout 0,
``lda_mmd`` 0); and a tensor-parallel epoch on a ``("data", "model")``
mesh against the replicated one. The bound is 1e-5 absolute, the JAX
package's multi-process one.
"""

import types

import numpy as np
import pytest
import torch

import factorized_tpu_torch.parallel.sharding as sharding
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import (from_numpy, from_state_dict,
                                          to_state_dict)
from torch_ranks import run_ranks

ATOL = 1e-5
SMALL = dict(input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
             zy_size=5, zl_size=6, za_size=4, zv_size=5,
             fy_size=4, fl_size=5, fa_size=4, fv_size=3,
             att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
             seqlength=5, batchsize=16)
NO_DRAWS = dict(att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0,
                gamma2_drop=0.0, zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0,
                za_to_fa_dropout=0.0, zv_to_fv_dropout=0.0,
                fy_to_y_dropout=0.0, lda_mmd=0.0)
EPOCHS, BATCHES = 2, 3


def _batches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    Xb = rng.normal(size=(BATCHES, cfg.seqlength, cfg.batchsize,
                          cfg.d_total)).astype(np.float32)
    return Xb, rng.normal(size=(BATCHES, cfg.batchsize)).astype(np.float32)


def _init(model, cfg):
    from factorized_tpu_torch.models import get_model

    return get_model(model)[0](torch.Generator().manual_seed(0), cfg)


def _epochs(tree, cfg, model, device, mesh=None, tp=False):
    """EPOCHS epochs of the joint loss from ``tree``: one process on the
    whole batch (``mesh`` None), data-parallel over ``mesh``, or with
    ``tp`` tensor-parallel over its ``model`` axis too. Returns the
    trained parameters by key and the per-epoch tracked losses."""
    from factorized_tpu_torch.models import get_model
    from factorized_tpu_torch.train import FlatAdam, TrainProgram

    apply_fn = get_model(model)[1]
    Xb, yb = _batches(cfg)
    tree = from_numpy(to_state_dict(tree), device)
    tree = from_state_dict(tree)
    tpar = None
    if mesh is None:
        params, program = tree, TrainProgram(apply_fn, cfg, "joint")
    else:
        dp = sharding.DataParallel(mesh)
        Xb, yb = dp.epoch_batches(Xb, yb)
        params = dp.params(tree)
        if tp:
            tpar = sharding.tp_param_shardings(mesh, params)
            params, apply_fn = tpar.params, tpar.apply(apply_fn)
        program = dp.program(apply_fn, cfg, "joint")
    opt = FlatAdam(params, 1e-3)
    Xs, ys = torch.from_numpy(Xb).to(device), torch.from_numpy(yb).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    accs = [float(program.epoch(params, opt, Xs, ys, gen))
            for _ in range(EPOCHS)]
    out = opt.tree_of(opt.flat)
    if tpar is not None:
        out = tpar.full(out)
    return {k: v.detach().cpu().numpy()
            for k, v in to_state_dict(out).items()}, accs


def _rank_cases(device, jax_init):
    """What each of two ranks computes (run by ``run_ranks``)."""
    mesh = sharding.make_mesh(device=device)
    dp = sharding.DataParallel(mesh)
    X = np.arange(3 * 7 * 2, dtype=np.float32).reshape(3, 7, 2)
    y = np.arange(7, dtype=np.float32) * 100
    Xl, yl, n = dp.full_set(X, y)
    rows = torch.from_numpy(Xl).sum((0, 2)) + torch.from_numpy(yl)
    draws = MFMConfig(**SMALL)
    jax_tree = from_state_dict(dict(np.load(jax_init)))
    tp_mesh = sharding.make_mesh(axes=("data", "model"), device=device)
    return {
        "full_set": (Xl.shape, yl.shape, n, dp.gather(rows, n).numpy()),
        "mfm": _epochs(_init("mfm", draws), draws, "mfm", device, mesh),
        "kl": _epochs(_init("kl", draws), draws, "kl", device, mesh),
        "jax": _epochs(jax_tree, MFMConfig(**SMALL, **NO_DRAWS), "mfm",
                       device, mesh),
        "tp": _epochs(_init("mfm", draws), draws, "mfm", device, tp_mesh,
                      tp=True),
    }


def _jax_cfg():
    from factorized_tpu.config import MFMConfig as JaxConfig

    return JaxConfig(**SMALL, **NO_DRAWS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks' ``_rank_cases``, from the JAX package's initial
    parameters at seed 0."""
    import jax

    from factorized_tpu.models import get_model as jax_get_model

    init = jax_get_model("mfm")[0](jax.random.PRNGKey(0), _jax_cfg())
    path = tmp_path_factory.mktemp("jax_init") / "init.npz"
    np.savez(path, **to_state_dict(jax.tree.map(np.asarray, init)))
    return run_ranks(f"{__file__}:_rank_cases", 2,
                     {"jax_init": str(path)}, timeout=240)


def _assert_close(got, want, atol=ATOL):
    (gp, ga), (wp, wa) = got, want
    assert set(gp) == set(wp)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=atol)


@pytest.mark.parametrize("n", range(1, 17))
def test_the_default_2d_shape_is_the_jax_packages(n):
    from factorized_tpu.parallel.sharding import _default_2d_shape as jax_2d

    axes = ("data", "model")
    try:
        want = jax_2d(n, axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sharding._default_2d_shape(n, axes)
        assert str(got.value) == str(e)
    else:
        assert sharding._default_2d_shape(n, axes) == want


def test_a_mesh_of_the_world_and_its_oversubscription():
    mesh = sharding.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.coords == {"data": 0}
    assert mesh.member and not mesh.partial
    assert mesh.group("data").size == 1 and mesh.group("data").pg is None
    two = sharding.make_mesh(axes=("seed", "batch"), device="cpu")
    assert two.shape == {"seed": 1, "batch": 1}
    assert two.group().ranks == (0,)
    with pytest.raises(ValueError, match="need 2 devices, have 1 rank"):
        sharding.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not lay"):
        sharding.make_mesh(1, axes=("a", "b"), shape=(1, 2), device="cpu")


@pytest.fixture
def fake_world(monkeypatch):
    calls = []
    monkeypatch.setattr(sharding.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(sharding.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    return calls


def test_init_distributed_takes_arguments_then_torchrun_then_jax(
        fake_world, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "jaxhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert sharding.init_distributed(device="cpu") is True
    assert fake_world[-1] == ("gloo", {"init_method": "tcp://jaxhost:1234",
                                       "rank": 2, "world_size": 4})
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    sharding.init_distributed(device="cpu")
    assert fake_world[-1][1] == {"init_method": "tcp://127.0.0.1:29511",
                                 "rank": 5, "world_size": 8}
    sharding.init_distributed("argh:9", 2, 1, device="cpu", backend="nccl")
    assert fake_world[-1] == ("nccl", {"init_method": "tcp://argh:9",
                                       "rank": 1, "world_size": 2})


def test_init_distributed_alone_is_a_world_of_one(fake_world):
    sharding.init_distributed(device="cpu")
    backend, kw = fake_world[-1]
    assert backend == "gloo" and kw["world_size"] == 1 and kw["rank"] == 0
    assert kw["init_method"].startswith("tcp://127.0.0.1:")
    with pytest.raises(ValueError, match="coordinator address"):
        sharding.init_distributed(num_processes=2, device="cpu")


def test_init_distributed_does_nothing_in_a_joined_world(monkeypatch):
    called = []
    monkeypatch.setattr(sharding.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(sharding.dist, "init_process_group",
                        lambda *a, **kw: called.append(a))
    assert sharding.init_distributed("host:1", 2, 0, device="cpu") is False
    assert called == []


def test_make_mesh_multihost_joins_first(monkeypatch):
    called = []
    monkeypatch.setattr(sharding, "init_distributed",
                        lambda **kw: called.append(kw))
    mesh = sharding.make_mesh(multihost=True, device="cpu")
    assert called == [{"device": "cpu"}] and mesh.shape == {"data": 1}


def _tp_mesh():
    return types.SimpleNamespace(shape={"data": 4, "model": 2},
                                 coords={"data": 0, "model": 1},
                                 group=lambda *axes: None)


def test_a_tensor_parallel_rule_that_does_not_divide_raises():
    params = {"decoder_l": {"fc1": {"w": torch.zeros(4, 7),
                                    "b": torch.zeros(7)}}}
    with pytest.raises(ValueError, match="does not divide"):
        sharding.tp_param_shardings(_tp_mesh(), params)


def test_a_dividing_weight_keeps_its_columns():
    w = torch.arange(32.0).reshape(4, 8)
    params = {"decoder_l": {"fc1": {"w": w, "b": torch.zeros(8)}}}
    tp = sharding.tp_param_shardings(_tp_mesh(), params)
    assert torch.equal(tp.params["decoder_l"]["fc1"]["w"], w[:, 4:])
    assert tp.params["decoder_l"]["fc1"]["b"] is params["decoder_l"]["fc1"][
        "b"]
    assert tp.sharded == {"decoder_l/fc1/w": 1}


def test_full_set_pads_and_gathers_over_two_ranks(ranks):
    X = np.arange(3 * 7 * 2, dtype=np.float32).reshape(3, 7, 2)
    want = X.sum((0, 2)) + np.arange(7, dtype=np.float32) * 100
    for r in ranks:
        x_shape, y_shape, n, rows = r["full_set"]
        assert x_shape == (3, 4, 2) and y_shape == (4,) and n == 7
        np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("model", ["mfm", "kl"])
def test_data_parallel_is_one_process_with_dropout_and_mmd(ranks, model):
    cfg = MFMConfig(**SMALL)
    assert cfg.lda_mmd > 0 and cfg.att1_drop > 0 and cfg.zv_to_fv_dropout > 0
    want = _epochs(_init(model, cfg), cfg, model, "cpu")
    for r in ranks:
        _assert_close(r[model], want)
    assert all(np.array_equal(ranks[0][model][0][k], ranks[1][model][0][k])
               for k in want[0])


def test_data_parallel_is_the_jax_single_device_epoch(ranks):
    import jax
    import jax.numpy as jnp

    from factorized_tpu.models import get_model as jax_get_model
    from factorized_tpu.train import TrainProgram, make_optimizer

    jcfg = _jax_cfg()
    init, apply_fn = jax_get_model("mfm")
    params = init(jax.random.PRNGKey(0), jcfg)
    opt = make_optimizer("adam")
    opt_state = opt.init(params)
    program = TrainProgram(apply_fn, jcfg, "joint", opt)
    Xb, yb = _batches(jcfg)
    accs = []
    for e in range(EPOCHS):
        params, opt_state, acc = program.epoch(
            params, opt_state, jnp.asarray(Xb), jnp.asarray(yb),
            jax.random.fold_in(jax.random.PRNGKey(1), e),
            jnp.asarray(1e-3, jnp.float32))
        accs.append(float(acc))
    want = to_state_dict(jax.tree.map(np.asarray, params)), accs
    for r in ranks:
        _assert_close(r["jax"], want)


def test_tensor_parallel_is_the_replicated_epoch(ranks):
    cfg = MFMConfig(**SMALL)
    want = _epochs(_init("mfm", cfg), cfg, "mfm", "cpu")
    for r in ranks:
        _assert_close(r["tp"], want)
