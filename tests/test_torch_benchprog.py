"""The port's bench programs' build functions
(``factorized_tpu_torch/benchprog.py``)
against the JAX package's: the pinned shapes and configs field for field
(the scale probe's candidates too), ``epoch_inputs`` bit for bit, the
chain plans ``active_paths`` attests on either path, and ``make_chunk``
at E = 2 on a tiny config (dropouts 0, ``lda_mmd`` 0) against the JAX
``make_chunk`` from the same init: parameters within 1e-6, the epochs'
losses within 1e-5 relative (the trainer tests' bounds, ROADMAP C1)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorized_tpu import benchprog as jbench
from factorized_tpu_torch import benchprog
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy, to_state_dict
from factorized_tpu_torch.models import mfm
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
from factorized_tpu_torch.train import TrainProgram, make_optimizer


def _jax_candidates():
    path = Path(__file__).parents[1] / "scripts" / "scale_mfu_probe.py"
    spec = importlib.util.spec_from_file_location("_scale_mfu_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.candidate_configs()


def test_shapes_and_configs_equal_the_jax_package():
    for name in ("BATCH", "T", "NB", "E", "SCALE_NB", "SCALE_E"):
        assert getattr(benchprog, name) == getattr(jbench, name), name
    assert benchprog.build_cfg().to_dict() == jbench.build_cfg().to_dict()
    assert benchprog.scale_cfg().to_dict() == jbench.scale_cfg().to_dict()
    jax_cands = _jax_candidates()
    port_cands = benchprog.scale_candidates()
    assert list(port_cands) == list(jax_cands)
    for name, cfg in port_cands.items():
        assert cfg.to_dict() == jax_cands[name].to_dict(), name


@pytest.mark.parametrize("kw", [{}, dict(nb=3, batch=5, t=4, seed=7)],
                         ids=["pinned", "small"])
def test_epoch_inputs_equal_the_jax_package_bit_for_bit(kw):
    cfg = benchprog.build_cfg()
    Xb, yb = benchprog.epoch_inputs(cfg, device="cpu", **kw)
    jX, jy = jbench.epoch_inputs(cfg, **kw)
    assert Xb.dtype == yb.dtype == torch.float32
    np.testing.assert_array_equal(Xb.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(yb.numpy(), np.asarray(jy))


@pytest.fixture
def port_gate():
    saved = mfm.FUSED
    yield
    mfm.FUSED = saved


def test_active_paths_attest_the_gate_and_the_plans(port_gate):
    cfg = benchprog.build_cfg()
    paths = benchprog.active_paths(cfg)
    assert paths["fused_blockdiag"] is mfm.fused_active(cfg) is True
    h = [cfg.zl_size, cfg.za_size, cfg.zv_size, *cfg.h_dims]
    want = cuda_mfn.encode_plans(h, cfg.gamma1_shape, cfg.gamma2_shape,
                                 cfg.memsize)
    dec = [cfg.fy_size + f for f in (cfg.fl_size, cfg.fa_size, cfg.fv_size)]
    want.update(cuda_lstm.decoder_plans(dec))
    assert {k: v for k, v in paths.items() if k != "fused_blockdiag"} == want
    # the main path's chains hold their weights in one block each
    assert set(want.values()) == {(1, 1), 1}
    assert set(benchprog.active_paths(cfg, train=False)) == {
        "fused_blockdiag", "mfm_encode_fwd", "decoder_lstm_fwd"}
    # forced, the scale config's fused chains read their weights from L2
    scale = benchprog.scale_cfg()
    mfm.FUSED = True
    assert set(benchprog.active_paths(scale).values()) == {True, (0, 0), 0}
    mfm.FUSED = False
    off = benchprog.active_paths(cfg)
    assert off.pop("fused_blockdiag") is False
    assert set(off.values()) == {None}


def test_chain_plans_at_the_widths_the_card_reported():
    # widths whose plans a chip run printed (PERF.md): kl_ef's four cells
    # on clusters of 2, a 160-unit decoder cell on a cluster, a 336-unit
    # one from L2, the chains just past a block's per-row state on the
    # scratch plan
    assert cuda_lstm.multi_plans([32, 8, 80, 120]) == {
        "multi_lstm_fwd": 2, "multi_lstm_bwd": 2}
    assert set(cuda_lstm.decoder_plans([160]).values()) == {2}
    assert set(cuda_lstm.decoder_plans([336]).values()) == {0}
    assert cuda_lstm.decoder_plans([3000])["decoder_lstm_bwd"] == \
        cuda_lstm.SCRATCH
    assert cuda_lstm.multi_plans([1700])["multi_lstm_bwd"] == \
        cuda_lstm.SCRATCH
    assert cuda_lstm.multi_plans([600], train=False)["multi_lstm_fwd"] == \
        cuda_lstm.SCRATCH
    assert cuda_mfn.encode_plans([32, 8, 80, 1400, 64, 48], 128, 128, 64)[
        "mfm_encode_bwd"][1] == cuda_lstm.SCRATCH


TINY = dict(input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
            zy_size=5, zl_size=6, za_size=4, zv_size=5,
            fy_size=4, fl_size=5, fa_size=4, fv_size=3,
            att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
            att1_drop=0.0, att2_drop=0.0, gamma1_drop=0.0,
            gamma2_drop=0.0, zy_to_fy_dropout=0.0, zl_to_fl_dropout=0.0,
            za_to_fa_dropout=0.0, zv_to_fv_dropout=0.0,
            fy_to_y_dropout=0.0, lda_mmd=0.0)


def test_make_chunk_matches_the_jax_chunk():
    jcfg = jbench.build_cfg().replace(**TINY)
    program, params, opt_state = jbench.build_train_state(jcfg)
    jX, jy = jbench.epoch_inputs(jcfg, nb=3, batch=4, t=5)
    chunk = jax.jit(jbench.make_chunk(program, e=2))
    jp, _, jtrs = chunk(params, opt_state, jX, jy, jax.random.PRNGKey(5),
                        jnp.float32(1e-3))

    cfg = MFMConfig.from_dict(jcfg.to_dict())
    assert cfg.to_dict() == benchprog.build_cfg().replace(**TINY).to_dict()
    tree = from_numpy(jax.tree.map(np.asarray, params))
    opt = make_optimizer(tree, 1e-3)
    Xb, yb = benchprog.epoch_inputs(cfg, nb=3, batch=4, t=5, device="cpu")
    port_chunk = benchprog.make_chunk(TrainProgram(mfm.mfm_apply, cfg), e=2)
    trs = port_chunk(tree, opt, Xb, yb, torch.Generator().manual_seed(5),
                     1e-3)
    assert tuple(trs.shape) == (2,)
    np.testing.assert_allclose(trs.numpy(), np.asarray(jtrs), rtol=1e-5)
    flat_j = to_state_dict(jax.tree.map(np.asarray, jp))
    for name, leaf in to_state_dict(tree).items():
        np.testing.assert_allclose(leaf.detach().numpy(), flat_j[name],
                                   rtol=0, atol=1e-6, err_msg=name)


def test_build_train_state_is_seeded():
    cfg = benchprog.build_cfg().replace(**TINY)
    a = benchprog.build_train_state(cfg, seed=3, device="cpu")
    b = benchprog.build_train_state(cfg, seed=3, device="cpu")
    assert isinstance(a[0], TrainProgram)
    for (k, x), (_, y) in zip(to_state_dict(a[1]).items(),
                              to_state_dict(b[1]).items()):
        assert torch.equal(x, y), k
    assert float(a[2].lr) == pytest.approx(1e-3)
