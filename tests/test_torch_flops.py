"""The port's FLOPs of a train step (``factorized_tpu_torch/utils/
flops.py``).

- The model FLOPs (``fused=False``, closed form over the reference's
  per-modality layers) equal the JAX package's count of its modular
  path's jaxpr, to the FLOP: ``mfm`` under ``joint`` at a tiny config and
  at ``best_acc_mosi_config``, and every other model type under the
  composition its trainer uses (the ablations under ``joint``, ``kl_ef``
  under ``beta_vae``, ``missing``, ``s2s``, ``bm``).
- The counter's unit cases, after ``tests/test_flops.py``: one product,
  its gradient's two more, a loop's iterations, a batched product, only
  the branch that runs.
- The executed FLOPs of the port's plain path (``fused=True``) exceed the
  model FLOPs (the block-diagonal zeros); the model FLOPs grow a little
  faster than the batch (the MMD's kernels are quadratic in it)."""

import pytest
import torch

from factorized_tpu.config import best_acc_mosi_config as jax_best
from factorized_tpu.utils.flops import (model_train_flops_per_step as
                                        jax_flops)
from factorized_tpu_torch.config import best_acc_mosi_config
from factorized_tpu_torch.utils.flops import (count_gemm_flops,
                                              model_products,
                                              model_train_flops_per_step)

TINY = dict(batchsize=4, seqlength=3, input_dims=[6, 5, 4])

CASES = [("mfm", "joint", TINY), ("mfm", "joint", {}), ("kl", "joint", TINY),
         ("kl_ef", "beta_vae", TINY), ("missing", "missing", TINY),
         ("m_a", "joint", TINY), ("m_b", "joint", TINY),
         ("m_c", "joint", TINY), ("m_d", "joint", TINY),
         ("s2s", "s2s", TINY), ("bm", "bm", TINY)]


@pytest.mark.parametrize("model,composition,kw", CASES,
                         ids=[f"{m}-{c}-{'tiny' if kw else 'best'}"
                              for m, c, kw in CASES])
def test_model_flops_equal_the_jax_package(model, composition, kw):
    want = jax_flops(jax_best(**kw), model=model, composition=composition)
    got = model_train_flops_per_step(best_acc_mosi_config(**kw), model=model,
                                     composition=composition)
    assert got == want > 0


def test_single_matmul():
    x, w = torch.zeros(32, 100), torch.zeros(100, 50)
    assert count_gemm_flops(lambda: (x @ w).sum()) == 2 * 32 * 100 * 50


def test_grad_counts_forward_plus_two_backward_products():
    x = torch.zeros(32, 100, requires_grad=True)
    w = torch.zeros(100, 50, requires_grad=True)
    assert count_gemm_flops(lambda: (x @ w).sum().backward()) == (
        3 * 2 * 32 * 100 * 50)


def test_loop_multiplies_by_its_iterations():
    w, c = torch.zeros(64, 64), torch.zeros(32, 64)

    def run():
        h = c
        for _ in range(9):
            h = h @ w
        return h

    assert count_gemm_flops(run) == 9 * 2 * 32 * 64 * 64


def test_batched_product():
    a, b = torch.zeros(4, 8, 16), torch.zeros(4, 9, 16)
    assert count_gemm_flops(torch.einsum, "bnd,bmd->bnm", a, b) == (
        2 * 4 * 8 * 9 * 16)


def test_only_the_branch_that_runs_counts():
    x, w = torch.zeros(8, 8), torch.zeros(8, 8)
    for take, flops in ((True, 2 * 8 * 8 * 8), (False, 0)):
        assert count_gemm_flops(
            lambda: (x @ w).sum() if take else x.sum()) == flops


def test_executed_flops_exceed_the_model_flops():
    cfg = best_acc_mosi_config(**TINY)
    model = model_train_flops_per_step(cfg)
    executed = model_train_flops_per_step(cfg, fused=True)
    assert executed > model > 0


def test_model_flops_scale_with_the_batch():
    f1 = model_train_flops_per_step(best_acc_mosi_config(**TINY))
    f2 = model_train_flops_per_step(best_acc_mosi_config(
        **dict(TINY, batchsize=8)))
    assert 2.0 <= f2 / f1 < 4.0


def test_products_name_their_layers_and_refuse_what_no_trainer_runs():
    cfg = best_acc_mosi_config(**TINY)
    products = model_products(cfg)
    layers = {p.layer.split(".")[0] for p in products}
    assert {"enc", "mfn", "mmd4", "zf", "dec", "fy_to_y"} <= layers
    # the products hoisted over the data need no gradient of it
    hoisted = [p for p in products if p.layer.endswith(".wx")
               and p.m == cfg.seqlength * cfg.batchsize]
    assert len(hoisted) == 6 and not any(p.lhs_grad for p in hoisted)
    with pytest.raises(ValueError, match="trains under"):
        model_products(best_acc_mosi_config(**TINY), "s2s", "joint")
    with pytest.raises(ValueError, match="no model FLOPs"):
        model_products(best_acc_mosi_config(**TINY), "eflstm")


MODULAR = [("mfm", "joint"), ("kl", "joint"), ("kl_ef", "beta_vae"),
           ("missing", "missing")]


@pytest.mark.parametrize("model,composition", MODULAR,
                         ids=[m for m, _ in MODULAR])
def test_model_flops_equal_the_modular_step_counted(model, composition):
    # one train step of the port's modular path (models/mfm.py::FUSED =
    # False) on the CPU, counted, against the closed form: the same
    # products but for the gradient of each encoder LSTM's zero state at
    # step 0, which autograd does not take (h_0 is a constant) and the
    # JAX package's scan does (its body is the same at every step)
    from factorized_tpu_torch.models import get_model, mfm
    from factorized_tpu_torch.train import TrainProgram, make_optimizer

    cfg = best_acc_mosi_config(**TINY)
    if model == "missing":
        cfg = cfg.replace(missing=1)
    init, apply_fn = get_model(model)
    params = init(torch.Generator().manual_seed(0), cfg)
    program = TrainProgram(apply_fn, cfg, composition)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((cfg.seqlength, cfg.batchsize, cfg.d_total),
                    generator=gen)
    saved = mfm.FUSED
    mfm.FUSED = False
    try:
        counted = count_gemm_flops(program.step, params,
                                   make_optimizer(params, 1e-3), x,
                                   torch.zeros(cfg.batchsize), gen)
    finally:
        mfm.FUSED = saved
    zero_state = sum(p.train_flops() // 3 for p in model_products(
        cfg, model, composition) if p.layer.endswith(".wh")
        and p.m == cfg.batchsize) // cfg.seqlength
    assert counted == model_train_flops_per_step(
        cfg, model=model, composition=composition) - zero_state > 0
