"""The probe path against the JAX package's probe scripts: each of the five
Pallas probe kernels of ``scripts/bwd_residual_probe.py`` and
``scripts/twostep_bwd_probe.py`` (interpret mode on the CPU) against the
plain version of its counterpart in ``factorized_tpu_torch``, the probes'
autograd variants against ``jax.grad`` through the scripts'
``custom_vjp``s, and both probe entry points on the CPU.

The scripts are no package, so they are loaded from their files. Inputs
are made from a seed with numpy (the probe's ``build_inputs`` at a small
config, masks at rate 0.3) and handed to both sides. Tolerance: 1e-5
absolute and relative, float32."""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorized_tpu.ops import pallas_mfn
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.ops import cuda_mfn
from factorized_tpu_torch.probes import bwd_residual_probe, twostep_bwd_probe

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _script(name):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_RES = _script("bwd_residual_probe")
JAX_TWO = _script("twostep_bwd_probe")


def _cfg(t):
    """H = 16 (encoders 2/2/2, MFN 4/3/3, z_tot 6), MLP widths 8/8/4/4,
    mem 5, n = 3."""
    return MFMConfig(
        seqlength=t, batchsize=3, input_dims=[8, 4, 5], h_dims=[4, 3, 3],
        memsize=5, zy_size=5, zl_size=2, za_size=2, zv_size=2, fy_size=4,
        fl_size=5, fa_size=4, fv_size=3, att1_shape=8, att2_shape=8,
        gamma1_shape=4, gamma2_shape=4)


def _inputs(t, seed=0):
    """Numpy-seeded inputs for both sides: the port's tensors, the same
    as JAX arrays, and cotangents of h_last and mem_last."""
    cfg = _cfg(t)
    rng = np.random.default_rng(seed)
    keep = rng.random((t, 3, 8 + 8 + 4 + 4)) >= 0.3
    masks = torch.from_numpy((keep / 0.7).astype(np.float32))
    xp, masks, weights, z_tot, h_dims = bwd_residual_probe.build_inputs(
        cfg, masks=masks)
    dh = rng.normal(size=(3, sum(h_dims))).astype(np.float32)
    dmem = rng.normal(size=(3, cfg.memsize)).astype(np.float32)
    port = (xp, masks, weights, torch.from_numpy(dh), torch.from_numpy(dmem))
    jx = (jnp.asarray(xp.numpy()), jnp.asarray(masks.numpy()),
          {k: jnp.asarray(v.numpy()) for k, v in weights.items()},
          jnp.asarray(dh), jnp.asarray(dmem))
    return port, jx, z_tot, h_dims


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def test_build_inputs_draws_the_jax_probes_inputs():
    """At the probe's config: the JAX probe's xp and weights, but wh cut to
    the six fused cells' gate-major diagonal blocks."""
    jxp, _, jw, jz = JAX_RES.build_inputs()
    xp, masks, w, z_tot, h_dims = bwd_residual_probe.build_inputs()
    assert z_tot == jz and h_dims == [32, 8, 80, 88, 64, 48]
    assert np.array_equal(xp.numpy(), np.asarray(jxp))
    for k in cuda_mfn.W_NAMES[1:]:
        assert np.array_equal(w[k].numpy(), np.asarray(jw[k])), k
    wh, dense = w["wh"].numpy(), np.asarray(jw["wh"])
    on = wh != 0.0
    assert np.array_equal(wh[on], dense[on])
    H = sum(h_dims)
    assert on.sum() == 4 * sum(h * h for h in h_dims)
    assert on[:32, :32].all() and on[:32, H:H + 32].all()
    assert not on[:32, 32:H].any()
    assert masks.shape == (20, 32, 4 * 128)
    assert set(masks.unique().tolist()) == {0.0, float(np.float32(1 / 0.7))}


@pytest.mark.parametrize("t", [4, 5])
def test_fwd_cat_kernel_matches_the_cat_forward(t):
    (xp, masks, w, _, _), (jxp, jm, jw, _, _), z_tot, _ = _inputs(t)
    ref = JAX_RES._fwd_cat_call(jxp, jm, jw, z_tot, True)
    port = cuda_mfn.mfm_encode_res_plain(xp, masks, w, z_tot, "cat")
    assert len(port) == len(ref) == 6
    for p, r in zip(port, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r)


@pytest.mark.parametrize("t", [4, 5])
def test_fwd_res_kernel_matches_the_split_forward(t):
    (xp, masks, w, _, _), (jxp, jm, jw, _, _), z_tot, h_dims = _inputs(t)
    ref = JAX_RES._fwd_res_call(jxp, jm, jw, z_tot, True)
    port = cuda_mfn.mfm_encode_res(xp, masks, w, z_tot, h_dims, "split")
    flat = (*port[:5], *port[5])
    assert len(flat) == len(ref) == 15
    for p, r in zip(flat, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r)


def _jax_residuals(jxp, jm, jw, z_tot):
    """The JAX probe's split residuals: (allh, allc, allmem, [ten])."""
    outs = JAX_RES._fwd_res_call(jxp, jm, jw, z_tot, True)
    return outs[2], outs[3], outs[4], list(outs[5:])


def _check_grads(port, ref):
    dxp, dw = port
    ref_dxp, ref_dw = ref
    _close(dxp, ref_dxp)
    assert set(dw) == set(ref_dw) == set(cuda_mfn.W_NAMES)
    for k in cuda_mfn.W_NAMES:
        assert tuple(dw[k].shape) == ref_dw[k].shape, k
        _close(dw[k], ref_dw[k])


@pytest.mark.parametrize("store_att", [False, True], ids=["B", "C"])
@pytest.mark.parametrize("t", [4, 5])
def test_bwd_res_kernel_matches_the_split_backward(t, store_att):
    (xp, _, w, dh, dmem), (jxp, jm, jw, jdh, jdmem), z_tot, h_dims = \
        _inputs(t, seed=1)
    allh, allc, allmem, res = _jax_residuals(jxp, jm, jw, z_tot)
    ref = JAX_RES._bwd_res_call(jxp, jw, allh, allc, allmem, res, jdh,
                                jdmem, z_tot, store_att)
    variant = "stream" if store_att else "recompute_att"
    port = cuda_mfn.mfm_encode_bwd(
        xp, w, _t(allh), _t(allc), _t(allmem), tuple(_t(r) for r in res),
        dh, dmem, z_tot, h_dims, variant)
    _check_grads(port, ref)


def _cat_residuals(jxp, jm, jw, z_tot):
    outs = JAX_RES._fwd_cat_call(jxp, jm, jw, z_tot, True)
    return outs[2:]


@pytest.mark.parametrize("t", [4, 5])
def test_bwd_stream_kernel_matches_the_stream_backward(t):
    (xp, _, w, dh, dmem), (jxp, jm, jw, jdh, jdmem), z_tot, h_dims = \
        _inputs(t, seed=2)
    res = _cat_residuals(jxp, jm, jw, z_tot)
    ref = JAX_RES._bwd_stream_call(jxp, jw, *res, jdh, jdmem, z_tot)
    port = cuda_mfn.mfm_encode_bwd(xp, w, *[_t(r) for r in res], dh, dmem,
                                   z_tot, h_dims)
    _check_grads(port, ref)


def test_bwd2_kernel_matches_the_two_step_backward():
    (xp, _, w, dh, dmem), (jxp, jm, jw, jdh, jdmem), z_tot, h_dims = \
        _inputs(4, seed=3)
    res = _cat_residuals(jxp, jm, jw, z_tot)
    ref = JAX_TWO._bwd2_call(jxp, jw, *res, jdh, jdmem, z_tot)
    port = cuda_mfn.mfm_encode_bwd(xp, w, *[_t(r) for r in res], dh, dmem,
                                   z_tot, h_dims, "two_step")
    _check_grads(port, ref)
    # the same function as the one-step backward, bit for bit here
    steps = cuda_mfn.mfm_encode_bwd_steps_plain(
        xp, w, *[_t(r) for r in res], dh, dmem, z_tot)
    two = cuda_mfn.mfm_encode_bwd_two_step_plain(
        xp, w, *[_t(r) for r in res], dh, dmem, z_tot)
    assert all(torch.equal(a, b) for a, b in zip(steps, two))


def test_two_step_raises_on_odd_t():
    (xp, masks, w, dh, dmem), _, z_tot, h_dims = _inputs(5, seed=4)
    outs = cuda_mfn.mfm_encode_res(xp, masks, w, z_tot, h_dims)
    with pytest.raises(ValueError, match="even t"):
        cuda_mfn.mfm_encode_bwd(xp, w, *outs[2:], dh, dmem, z_tot, h_dims,
                                "two_step")
    with pytest.raises(ValueError, match="even t"):
        cuda_mfn.mfm_encode_bwd_two_step_plain(xp, w, *outs[2:], dh, dmem,
                                               z_tot)
    xr = xp.clone().requires_grad_()
    h, mem = cuda_mfn.make_variant_two_step()(xr, masks, w, z_tot, h_dims)
    with pytest.raises(ValueError, match="even t"):
        (h.sum() + mem.sum()).backward()


def _jax_grads(encode, jxp, jm, jw, z_tot):
    def loss(xp_, w_):
        h, m = encode(xp_, jm, w_, z_tot, True)
        return jnp.sum(h * h) + jnp.sum(m * m)

    return jax.grad(loss, argnums=(0, 1))(jxp, jw)


def _jax_production(xp, masks, weights, z_tot, train):
    return pallas_mfn.mfm_encode_pallas(xp, masks, weights, z_tot, train)


# (the port's encode, the JAX one); the JAX probe has no custom_vjp for the
# two-step backward (it swaps the production one's _bwd_call), so that
# variant is held against the production custom_vjp: the same function
_VARIANTS = {
    "B": (lambda: cuda_mfn.make_variant(False),
          lambda: JAX_RES.make_variant(False)),
    "C": (lambda: cuda_mfn.make_variant(True),
          lambda: JAX_RES.make_variant(True)),
    "D": (cuda_mfn.make_variant_d, JAX_RES.make_variant_d),
    "two_step": (cuda_mfn.make_variant_two_step, lambda: _jax_production),
}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_probe_autograd_variants_match_jax_grad(name):
    (xp, masks, w, _, _), (jxp, jm, jw, _, _), z_tot, h_dims = \
        _inputs(4, seed=5)
    port_encode, jax_encode = (make() for make in _VARIANTS[name])
    ref_dxp, ref_dw = _jax_grads(jax_encode, jxp, jm, jw, z_tot)
    dxp, dw = bwd_residual_probe.loss_grads(port_encode, xp, masks, w,
                                            z_tot, h_dims)
    _check_grads((dxp, dw), (ref_dxp, ref_dw))


def test_cpu_calls_launch_nothing_and_bad_choices_raise():
    (xp, masks, w, dh, dmem), _, z_tot, h_dims = _inputs(4, seed=6)
    counters = ("LAUNCHES", "SPLIT_LAUNCHES", "BWD_LAUNCHES",
                "RECOMPUTE_LAUNCHES", "TWO_STEP_LAUNCHES", "DW_LAUNCHES")
    before = [getattr(cuda_mfn, c) for c in counters]
    outs = cuda_mfn.mfm_encode_res(xp, masks, w, z_tot, h_dims, "split")
    for variant in cuda_mfn.BWD_VARIANTS:
        cuda_mfn.mfm_encode_bwd(xp, w, *outs[2:], dh, dmem, z_tot, h_dims,
                                variant)
    assert [getattr(cuda_mfn, c) for c in counters] == before
    with pytest.raises(ValueError, match="layout must be one of"):
        cuda_mfn.mfm_encode_res(xp, masks, w, z_tot, h_dims, "rows")
    with pytest.raises(ValueError, match="variant must be one of"):
        cuda_mfn.mfm_encode_bwd(xp, w, *outs[2:], dh, dmem, z_tot, h_dims,
                                "three_step")
    with pytest.raises(ValueError, match="10 tensors"):
        cuda_mfn.mfm_encode_bwd(xp, w, *outs[2:5], outs[5][:9], dh, dmem,
                                z_tot, h_dims)
    with pytest.raises(ValueError, match="r1 must be"):
        cuda_mfn.mfm_encode_bwd(
            xp, w, *outs[2:5], (outs[5][0], outs[5][1][..., :-1]
                                .contiguous(), *outs[5][2:]),
            dh, dmem, z_tot, h_dims)


def _last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_bwd_residual_probe_main_on_the_cpu(capsys):
    out = bwd_residual_probe.main(
        ["--device", "cpu", "--iters", "1", "--groups", "1"], cfg=_cfg(4))
    assert _last_json(capsys) == out
    assert out["device"] == "cpu" and (out["t"], out["n"]) == (4, 3)
    for key in ("plain_fwd_bwd", "B_store_noatt", "C_store_att",
                "D_streamed", "plain_fwd_only", "kernel_fwd_only"):
        assert np.isfinite(out[key]) and out[key] > 0.0, key
    assert set(out["max_grad_diff"]) == set(bwd_residual_probe.VARIANTS)
    assert max(out["max_grad_diff"].values()) < 1e-5


def test_twostep_probe_main_on_the_cpu(capsys):
    out = twostep_bwd_probe.main(
        ["--device", "cpu", "--groups", "1", "--epochs", "1"],
        cfg=_cfg(4).replace(batchsize=4), nb=2)
    assert _last_json(capsys) == out
    assert out["tracked_loss_match"] is True
    assert len(out["runs"]) == 4 and out["onestep"] > 0 and out["twostep"] > 0


@pytest.mark.parametrize("probe", [bwd_residual_probe, twostep_bwd_probe])
def test_probes_need_a_card_unless_asked_for_the_cpu(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
