"""The port's chunked training loop against its per-epoch host loop, and
its device-side pieces against the JAX package's.

``trainers._loop`` runs chunks of epochs through ``train.ChunkedLoop``
(on the CPU each epoch runs its body eagerly; on a CUDA card it is one
graph replay); ``FACTORIZED_TPU_HOST_LOOP=1`` picks ``_loop_host``. The
two must give the same run bit for bit: history, lr trace, final and
best parameters, Adam's state and the scheduler's, as
``tests/test_chunked_loop.py`` holds the JAX package's two loops. Beside
them: ``plateau_step`` against the JAX package's, the flat Adam against
``optax.flatten(scale_by_adam(eps=1e-8))`` with leaves that get no
gradient in some steps (rtol 1e-6, atol 1e-7), and the ``kl_ef`` stage-2
step that such leaves come from."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from factorized_tpu.utils.scheduler import plateau_init
from factorized_tpu.utils.scheduler import plateau_step as jax_plateau_step
from factorized_tpu_torch import train, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import mfm
from factorized_tpu_torch.ops import counts, cuda_lstm, cuda_mfn
from factorized_tpu_torch.utils.checkpoint import keeps
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.scheduler import (ReduceLROnPlateau,
                                                  plateau_step)

ADAM = dict(rtol=1e-6, atol=1e-7)

# the small config of tests/test_torch_train.py, every dropout site of
# best_acc_mosi_config active at its rate
SMALL = dict(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
    att1_drop=0.5, att2_drop=0.5, gamma1_drop=0.5, gamma2_drop=0.5,
    zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.2,
    za_to_fa_dropout=0.2, zv_to_fv_dropout=0.7, fy_to_y_dropout=0.0)


def _cfg(**kw):
    return MFMConfig(**SMALL).replace(batchsize=16, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _small_data(seed, n_train=70, n_valid=20, n_test=24, t=6, d=17):
    rng = np.random.default_rng(seed)

    def split(n):
        X = rng.normal(size=(n, t, d)).astype(np.float32)
        return X, (X[:, -1, :3].sum(1) + 0.1 * rng.normal(size=n)).astype(
            np.float32)

    return (*split(n_train), *split(n_valid), *split(n_test))


def _run(monkeypatch, host, trainer, *args, **kw):
    """One trainer run on the CPU through the host loop or the chunked
    one: (its results, its ``_Setup``: live parameters, Adam and the
    scheduler)."""
    setups = []

    class Setup(trainers._Setup):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            setups.append(self)

    with monkeypatch.context() as m:
        m.setattr(trainers, "_Setup", Setup)
        if host:
            m.setenv("FACTORIZED_TPU_HOST_LOOP", "1")
        else:
            m.delenv("FACTORIZED_TPU_HOST_LOOP", raising=False)
        res = trainer(*args, device="cpu", logger=RunLogger(echo=False),
                      **kw)
    return res, setups[0]


def _same(a, b):
    """Equal bit for bit, NaN where NaN (a diverged run's values)."""
    a, b = (np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for v in (a, b))
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


def _assert_same_trees(a, b):
    a, b = to_state_dict(a), to_state_dict(b)
    assert list(a) == list(b)
    for k in a:
        assert _same(a[k], b[k]), k


def _assert_same_runs(monkeypatch, trainer, *args, **kw):
    (host, hs), (chunk, cs) = (_run(monkeypatch, h, trainer, *args, **kw)
                               for h in (True, False))
    assert len(host["history"]) == len(chunk["history"])
    for a, b in zip(host["history"], chunk["history"]):
        assert a.keys() == b.keys()
        for k in a:
            if k == "lr":
                # the host loop records the host class's float, the
                # chunked one the float32 the step read, as the JAX
                # package's two loops do
                assert np.float32(a[k]) == np.float32(b[k]), (a, b)
                assert b[k] == float(np.float32(b[k])), b
            else:
                assert _same(a[k], b[k]), (k, a, b)
    assert host["step"] == chunk["step"]
    if "best_valid" in host:
        assert _same(host["best_valid"], chunk["best_valid"])
    _assert_same_trees(host["params"], chunk["params"])  # best or last
    _assert_same_trees(hs.params, cs.params)  # the live parameters
    for k, v in host["opt_state"]["state"].items():
        assert _same(v, chunk["opt_state"]["state"][k]), k
    assert host["opt_state"]["lr"] == chunk["opt_state"]["lr"]
    host_sched, chunk_sched = vars(hs.scheduler), vars(cs.scheduler)
    assert np.float32(host_sched.pop("lr")) == np.float32(
        chunk_sched.pop("lr"))
    assert host_sched == chunk_sched
    return host, chunk


# ---------------------------------------------- chunked loop == host loop

def test_train_mfm_chunked_equals_host(monkeypatch):
    _assert_same_runs(monkeypatch, trainers.train_mfm, *_small_data(0),
                      _cfg(num_epochs=5), seed=3)


def test_train_mfm_remainder_batch(monkeypatch):
    # 70 samples, batch 16: 4 full batches and a ragged one of 6
    host, _ = _assert_same_runs(monkeypatch, trainers.train_mfm,
                                *_small_data(1), _cfg(num_epochs=3), seed=4,
                                include_remainder=True)
    assert len(host["history"]) == 3


def test_train_mfm_lr_trace_through_the_scheduler(monkeypatch):
    # a schedule that reduces the lr twice and then holds at min_lr
    monkeypatch.setattr(
        trainers, "ReduceLROnPlateau",
        lambda lr: ReduceLROnPlateau(lr, patience=0, threshold=0.5,
                                     cooldown=1, min_lr=2e-5))
    host, _ = _assert_same_runs(monkeypatch, trainers.train_mfm,
                                *_small_data(2), _cfg(num_epochs=6), seed=5)
    lrs = [e["lr"] for e in host["history"]]
    assert lrs[0] == 1e-3 and min(lrs) == float(np.float32(2e-5))


def test_train_beta_vae_save_always(monkeypatch):
    host, chunk = _assert_same_runs(
        monkeypatch, trainers.train_beta_vae, *_small_data(3),
        _cfg(num_epochs=3, model_type="kl_ef"), seed=6)
    assert [e["stage"] for e in chunk["history"]] == [1] * 3 + [2] * 3
    assert int(chunk["opt_state"]["state"]["count"]) == 6 * 4


def test_train_mfm_missing(monkeypatch):
    _assert_same_runs(monkeypatch, trainers.train_mfm_missing,
                      *_small_data(4), _cfg(num_epochs=3, missing=1), seed=7)


@pytest.mark.parametrize("how", ["lr_1e18", "nan_valid_at_epoch_2"])
def test_divergence_truncates_identically(monkeypatch, how):
    kw = {}
    if how == "lr_1e18":
        kw["lr"] = 1e18
    else:
        evaluate = train.TrainProgram.evaluate

        def nan_at_epoch_2(self, *a):
            # each run has a program of its own: its third eval is NaN
            self.evals = getattr(self, "evals", 0) + 1
            out = evaluate(self, *a)
            return out * float("nan") if self.evals == 3 else out

        monkeypatch.setattr(train.TrainProgram, "evaluate", nan_at_epoch_2)
    host, chunk = _assert_same_runs(
        monkeypatch, trainers.train_mfm, *_small_data(5),
        _cfg(num_epochs=5), seed=8, **kw)
    at = 0 if how == "lr_1e18" else 2
    assert len(chunk["history"]) == at + 1
    assert chunk["history"][-1]["diverged"] and host["step"] == at


def test_chunk_of_4_over_6_epochs(monkeypatch):
    monkeypatch.setenv("FACTORIZED_TPU_EPOCH_CHUNK", "4")
    reads = []
    run = train.ChunkedLoop.run
    monkeypatch.setattr(train.ChunkedLoop, "run",
                        lambda self, n: reads.append(n) or run(self, n))
    _assert_same_runs(monkeypatch, trainers.train_mfm, *_small_data(6),
                      _cfg(num_epochs=6), seed=9)
    assert reads == [4, 2]  # two chunks, one host read each


# ------------------------------------------------------ the loop's pieces

def test_leaves_and_grads_are_views_of_the_flat_buffers():
    cfg = _cfg()
    tree = mfm.MFM(cfg, seed=0, device="cpu").tree()
    before = {k: v.detach().clone() for k, v in to_state_dict(tree).items()}
    opt = train.make_optimizer(tree, 1e-3)
    program = train.TrainProgram(mfm.mfm_apply, cfg)
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(6, 4, cfg.d_total, generator=g), torch.randn(4)
    program.step(tree, opt, x, y, g)
    flat, grad = opt.flat.data_ptr(), opt.grad.data_ptr()
    end = opt.flat.numel() * 4
    at = 0
    for k, leaf in to_state_dict(tree).items():
        assert leaf.requires_grad and leaf.is_leaf
        assert leaf.shape == before[k].shape
        assert leaf.data_ptr() == flat + at and leaf.grad.data_ptr() == \
            grad + at, k
        at += leaf.numel() * 4
    assert at == end
    assert torch.equal(opt.grad, torch.cat([v.grad.reshape(-1) for v in
                                            to_state_dict(tree).values()]))
    # the step moved the leaves through the flat vector
    assert any(not torch.equal(v.detach(), before[k])
               for k, v in to_state_dict(tree).items())
    assert int(opt.count) == 1 and opt.lr.dtype == torch.float32
    _assert_same_trees(opt.tree_of(opt.flat), tree)


def _sched(lr, mode):
    return {"lr": torch.tensor(lr, dtype=torch.float64),
            "best": torch.tensor(np.inf if mode == "min" else -np.inf,
                                 dtype=torch.float32),
            "bad": torch.tensor(0, dtype=torch.int32),
            "cooldown": torch.tensor(0, dtype=torch.int32)}


@pytest.mark.parametrize("mode,kw,metrics", [
    ("min", dict(patience=2, cooldown=1, min_lr=1e-5),
     [1.0, 0.9, 0.95, 0.96, 0.97, np.nan, 0.8, 0.85, 0.86, 0.87, 0.88,
      0.89, 0.9, 0.91, 0.92, 0.93]),
    ("min", dict(patience=0, threshold=0.3, factor=0.5),
     [2.0, 1.5, 1.2, np.nan, 1.0, 0.5, 0.45, 0.44]),
    ("max", dict(patience=1, cooldown=2, min_lr=1e-4, factor=0.3),
     [0.1, 0.2, 0.2, 0.19, 0.25, 0.24, 0.23, np.nan, 0.22, 0.3, 0.29,
      0.28, 0.27]),
], ids=["min-patience-cooldown-min_lr-nan", "min-threshold-nan",
        "max-cooldown-min_lr-nan"])
def test_plateau_step_matches_jax_and_the_host_class(mode, kw, metrics):
    kw = dict(mode=mode, **kw)
    port = _sched(1e-3, mode)
    ref = plateau_init([1e-3], mode)
    host = ReduceLROnPlateau(1e-3, **kw)
    lrs = []
    for m in np.asarray(metrics, np.float32):
        port = plateau_step(port, torch.tensor(m), **kw)
        ref = jax_plateau_step(ref, jnp.asarray([m]), **kw)
        assert np.float32(port["lr"]) == np.asarray(ref["lr"])[0]
        assert port["lr"].dtype == torch.float64
        for k in ("best", "bad", "cooldown"):
            assert _same(port[k].numpy().reshape(1), np.asarray(ref[k])), k
        # the host class, bit for bit (lr as a Python float)
        lrs.append(host.step(float(m)))
        assert float(port["lr"]) == lrs[-1]
        assert (float(port["best"]), int(port["bad"]),
                int(port["cooldown"])) == (host.best, host.num_bad_epochs,
                                           host.cooldown_counter)
    assert min(lrs) < 1e-3  # the schedule did reduce


@pytest.mark.parametrize("mode,save_always", [("min", False), ("max", False),
                                              ("min", True)])
def test_keeps_is_the_best_keepers_rule(mode, save_always):
    from factorized_tpu_torch.utils.checkpoint import BestKeeper

    host = BestKeeper(mode)
    best = torch.tensor(host.best, dtype=torch.float32)
    for m in np.asarray([3.0, 2.0, 2.0, 2.5, np.nan, 1.0, 1.0, 4.0],
                        np.float32):
        ok = torch.tensor(bool(np.isfinite(m)))
        take = keeps(torch.tensor(m), best, ok, mode, save_always)
        want = bool(ok) and host.update(float(m), {}, 0)
        if save_always and bool(ok) and not want:
            host.best, want = float(m), True
        assert bool(take) == want
        best = torch.where(take, torch.tensor(m), best)
        assert float(best) == host.best


def test_counts_snapshot_and_add():
    before = counts.snapshot()
    try:
        cuda_mfn.DW_LAUNCHES += 2
        cuda_lstm.L2_LAUNCHES["decoder_lstm_fwd"] = \
            cuda_lstm.L2_LAUNCHES.get("decoder_lstm_fwd", 0) + 1
        delta = counts.since(before)
        assert delta[(cuda_mfn, "DW_LAUNCHES")] == 2
        assert delta[(cuda_lstm, "L2_LAUNCHES")] == {"decoder_lstm_fwd": 1}
        assert delta[(cuda_lstm, "LAUNCHES")] == 0
        counts.add(delta)
        assert counts.since(before)[(cuda_mfn, "DW_LAUNCHES")] == 4
    finally:
        counts.restore(before)
    assert counts.snapshot() == before


# ------------------------------------------------- the flat Adam vs optax

# the leaves each step's loss reaches: "c" only in the first four steps
# and "d" only in the last four, as kl_ef's decoders and label head in
# its two stages; "e" never
USED = [("a", "c"), ("a", "c"), ("c",), ("a", "c"), ("a", "d"), ("d",),
        ("a", "d"), ("a", "d")]


def test_flat_adam_matches_optax_when_leaves_get_no_gradient():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": {"c": (5,)}, "d": (2, 2), "e": (3,)}

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.normal(size=v).astype(np.float32)
                for k, v in tree.items()}

    p0 = draw(shapes)
    coefs = [draw(shapes) for _ in USED]

    def loss(p, coef, k):
        # grad = coef + p on the leaves reached: exact in float32 on both
        # sides; zero on the others
        leaf = {"a": p["a"], "c": p["b"]["c"], "d": p["d"]}
        c = {"a": coef["a"], "c": coef["b"]["c"], "d": coef["d"]}
        return sum((c[n] * leaf[n]).sum() + 0.5 * (leaf[n] ** 2).sum()
                   for n in USED[k])

    lr = 1e-3
    opt = optax.flatten(optax.scale_by_adam(eps=1e-8))
    pj = jax.tree.map(jnp.asarray, p0)
    state = opt.init(pj)
    for k, coef in enumerate(coefs):
        g = jax.grad(loss)(pj, jax.tree.map(jnp.asarray, coef), k)
        u, state = opt.update(g, state, pj)
        pj = jax.tree.map(lambda p, u_: p - lr * u_, pj, u)

    tree = from_numpy(p0)
    for leaf in train.leaves(tree):
        leaf.requires_grad_()
    optimizer = train.make_optimizer(tree, lr)
    for k, coef in enumerate(coefs):
        optimizer.zero_grad()
        loss(tree, from_numpy(coef), k).backward()
        optimizer.step()

    got = to_state_dict(tree)
    want = to_state_dict(jax.tree.map(np.asarray, pj))
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name],
                                   err_msg=name, **ADAM)
    # the moments and the one global count, leaf by leaf
    assert int(optimizer.state_dict()["state"]["count"]) == \
        int(state.count) == len(USED)
    unravel = ravel_pytree(pj)[1]
    for moment in ("mu", "nu"):
        ours = to_state_dict(optimizer.tree_of(getattr(optimizer, moment)))
        theirs = to_state_dict(jax.tree.map(
            np.asarray, unravel(getattr(state, moment))))
        for name in theirs:
            np.testing.assert_allclose(ours[name].numpy(), theirs[name],
                                       err_msg=f"{moment} {name}", **ADAM)


def test_kl_ef_stage_2_moves_the_decoders_on_one_count():
    cfg = MFMConfig(**SMALL).replace(model_type="kl_ef")
    tree = mfm.MFM(cfg, seed=0, device="cpu", model_type="kl_ef").tree()
    opt = train.make_optimizer(tree, 1e-3)
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(6, 4, cfg.d_total, generator=g), torch.randn(4)
    stage = {s: train.TrainProgram(mfm.mfm_kl_ef_apply, cfg, "beta_vae",
                                   stage=s) for s in (1, 2)}
    for _ in range(2):
        stage[1].step(tree, opt, x, y, g)
    flat = to_state_dict(tree)
    head = [k for k in flat if k.startswith("fy_to_y.")]
    dec = [k for k in flat if k.startswith("dec.")]
    assert head and dec
    b1, b2, eps, lr = opt.B1, opt.B2, opt.EPS, 1e-3
    mu = to_state_dict(opt.tree_of(opt.mu))
    nu = to_state_dict(opt.tree_of(opt.nu))
    before = {k: v.detach().clone() for k, v in flat.items()}
    # stage 1 does not reach the label head: a zero gradient, no moments,
    # and the head has not moved
    for k in head:
        assert torch.equal(flat[k].grad, torch.zeros_like(flat[k]))
        assert not mu[k].any() and not nu[k].any()

    stage[2].step(tree, opt, x, y, g)
    assert int(opt.count) == 3  # one count over both stages
    for k in dec:
        # stage 2 does not reach the decoders: a zero gradient, yet they
        # move on their stage-1 moments, as under optax
        assert torch.equal(flat[k].grad, torch.zeros_like(flat[k]))
        m, v = b1 * mu[k], b2 * nu[k]
        want = before[k] - lr * (m / (1 - b1 ** 3)) / (
            torch.sqrt(v / (1 - b2 ** 3)) + eps)
        assert not torch.equal(flat[k].detach(), before[k]), k
        torch.testing.assert_close(flat[k].detach(), want, **ADAM)
    for k in head:
        # the head's first gradient, bias-corrected with the global count
        # 3 (a count of its own would be 1)
        gk = flat[k].grad
        m, v = (1 - b1) * gk, (1 - b2) * gk * gk
        want = before[k] - lr * (m / (1 - b1 ** 3)) / (
            torch.sqrt(v / (1 - b2 ** 3)) + eps)
        torch.testing.assert_close(flat[k].detach(), want, **ADAM)


@pytest.mark.parametrize("lr", [1e-3, float(np.float32(1e-3) * np.float32(0.1)),
                                3e-3, 2e-5])
def test_flat_adam_update_is_the_same_with_a_float64_lr(lr):
    """The flat Adam keeps its lr in float32, as the JAX package's chunked
    loop does; ``p -= lr * u`` is taken in float32 whatever the lr's type,
    so three steps move the parameters, moments and count bit for bit as
    with the float64 lr the port kept before."""
    cfg = _cfg()
    states = []
    for dtype in (torch.float64, torch.float32):
        tree = mfm.MFM(cfg, seed=0, device="cpu").tree()
        opt = train.make_optimizer(tree, lr)
        opt.lr = torch.tensor(lr, dtype=dtype)
        program = train.TrainProgram(mfm.mfm_apply, cfg)
        g = torch.Generator().manual_seed(0)
        for _ in range(3):
            x = torch.randn(6, 4, cfg.d_total, generator=g)
            program.step(tree, opt, x, torch.randn(4, generator=g), g)
        states.append((opt.state.clone(), int(opt.count)))
    assert torch.equal(states[0][0], states[1][0])
    assert states[0][1] == states[1][1] == 3
