"""The port's CUDA kernels on the card: each against its plain version,
the launch counts, the card's Predictor against the CPU's, and one train
step's gradients on the card against the CPU's. Every test here is marked
``gpu`` and skips without a CUDA card. Run on the card:
``python -m pytest tests/test_torch_cuda.py -m gpu``.

Float32 with TF32 off; tolerance rtol 1e-4 / atol 1e-5 for forward
values, since the kernels sum in another order than cuBLAS, and
rtol 1e-3 / atol 2e-5 for gradients, whose sums run over t * n rows."""

import hashlib

import numpy as np
import pytest
import torch

from factorized_tpu_torch.config import MFMConfig, best_acc_mosi_config
from factorized_tpu_torch.convert import from_state_dict, to_state_dict
from factorized_tpu_torch.models import ablations, baselines, get_model, mfm
from factorized_tpu_torch.models.common import mfn_drops
from factorized_tpu_torch.ops import counts, cuda_lstm, cuda_mfn
from factorized_tpu_torch.serve import Predictor
from factorized_tpu_torch.train import make_loss_fn

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=2e-5)

SMALL = MFMConfig(
    seqlength=6, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _operands(cfg, n, dev):
    """The kernels' inputs as the main path builds them."""
    params = mfm.MFM(cfg, seed=0, device=dev).tree()
    x = torch.randn((cfg.seqlength, n, cfg.d_total),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        return mfm.kernel_operands(params, x, cfg)


@pytest.mark.parametrize("cfg,n", [(SMALL, 5), (best_acc_mosi_config(), 256)],
                         ids=["small", "serving"])
def test_kernels_match_plain(cuda, cfg, n):
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        _operands(cfg, n, cuda)
    t = cfg.seqlength
    with torch.inference_mode():
        got = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
        want = cuda_mfn.mfm_encode_plain(xp, weights, z_tot)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        got = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)
        want = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        torch.cuda.synchronize()


def test_each_wrapper_call_is_one_launch(cuda):
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        _operands(SMALL, 3, cuda)
    before = (cuda_mfn.LAUNCHES, cuda_lstm.LAUNCHES)
    with torch.inference_mode():
        cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
        cuda_mfn.mfm_encode_plain(xp, weights, z_tot)
        cuda_lstm.decoder_lstm(h0, c0, wsum, b, SMALL.seqlength, dec_dims)
        cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, SMALL.seqlength)
    torch.cuda.synchronize()
    assert (cuda_mfn.LAUNCHES, cuda_lstm.LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)


def test_mixed_devices_raise(cuda):
    (xp, weights, z_tot, h_dims), _ = _operands(SMALL, 3, cuda)
    with pytest.raises(ValueError, match="is on"):
        cuda_mfn.mfm_encode(xp, dict(weights, wh=weights["wh"].cpu()),
                            z_tot, h_dims)


def test_predictor_on_the_card_matches_the_cpu(cuda):
    cfg = best_acc_mosi_config()
    params = mfm.MFM(cfg, seed=2, device="cpu").tree()
    X = np.random.default_rng(0).normal(
        size=(300, cfg.seqlength, cfg.d_total)).astype(np.float32)
    on_card = Predictor(cfg, params)
    assert on_card.device.type == "cuda"
    before = (cuda_mfn.LAUNCHES, cuda_lstm.LAUNCHES)
    y = on_card.predict(X)
    # 300 rows = two padded chunks of 256: one encode launch per chunk (a
    # graph replay adds its capture's counts), and no decoder: y_hat
    # does not read it
    assert (cuda_mfn.LAUNCHES - before[0],
            cuda_lstm.LAUNCHES - before[1]) == (2, 0)
    y_cpu = Predictor(cfg, params, device="cpu").predict(X)
    np.testing.assert_allclose(y, y_cpu, **TOL)


@pytest.mark.parametrize("model_type", ["mfm", "kl", "kl_ef", "missing",
                                        "m_a", "m_b", "m_c", "m_d"])
def test_graph_predictor_matches_the_cpu(cuda, model_type):
    cfg = best_acc_mosi_config(model_type=model_type)
    params = mfm.MFM(cfg, seed=4, device="cpu", model_type=model_type).tree()
    X = np.random.default_rng(1).normal(
        size=(300, cfg.seqlength, cfg.d_total)).astype(np.float32)
    on_card = Predictor(cfg, params, model_type=model_type)
    assert set(on_card.graph_stats()) == {256}
    before = counts.snapshot()
    y = on_card.predict(X)
    launched = {(m.__name__.rsplit(".", 1)[1], a): v for (m, a), v in
                counts.since(before).items() if isinstance(v, int) and v}
    kernel = (("cuda_lstm", "MULTI_LAUNCHES")
              if model_type in ("kl_ef", "m_b", "m_d")
              else ("cuda_mfn", "LAUNCHES"))
    assert launched == {kernel: 2}
    y_cpu = Predictor(cfg, params, model_type=model_type,
                      device="cpu").predict(X)
    np.testing.assert_allclose(y, y_cpu, **TOL)
    # the same again: the replays read this call's input
    np.testing.assert_allclose(on_card.predict(X[::-1]), y_cpu[::-1], **TOL)


def test_graph_predictor_autotune_keeps_the_winner(cuda):
    cfg = best_acc_mosi_config()
    params = mfm.MFM(cfg, seed=5, device="cpu").tree()
    X = np.random.default_rng(2).normal(
        size=(100, cfg.seqlength, cfg.d_total)).astype(np.float32)
    p = Predictor(cfg, params, batch_size=32)
    want = Predictor(cfg, params, device="cpu").predict(X)
    rates = p.autotune(X, candidates=(32, 64, 128, 256), reps=1)
    assert set(rates) == {32, 64, 128}  # 256 > 2 n
    assert p.batch_size == max(rates, key=rates.get)
    assert set(p.graph_stats()) == {p.batch_size}
    np.testing.assert_allclose(p.predict(X), want, **TOL)
    out = p.device_latency(X, iters=10)
    assert out["batch"] == p.batch_size and 0 < out["latency_s"]


def test_graph_predictor_captures_on_a_worker_thread(cuda):
    from factorized_tpu_torch.serve import MicroBatcher

    p = Predictor(SMALL, mfm.MFM(SMALL, seed=6, device="cpu").tree(),
                  batch_size=8)
    p.batch_size = 16  # no graph yet: the worker's first batch captures it
    batcher = MicroBatcher(p)
    try:
        X = np.random.default_rng(3).normal(
            size=(5, SMALL.seqlength, SMALL.d_total)).astype(np.float32)
        y = batcher.submit(X)
    finally:
        batcher.close()
    assert set(p.graph_stats()) == {8, 16}
    want = Predictor(SMALL, p.params, device="cpu").predict(X)
    np.testing.assert_allclose(y, want, **TOL)


@pytest.mark.parametrize("model_type", ["mfm", "kl_ef"])
def test_exported_predictor_on_the_card(cuda, tmp_path, model_type):
    from factorized_tpu_torch.serve import ExportedPredictor

    cfg = best_acc_mosi_config(model_type=model_type)
    params = mfm.MFM(cfg, seed=7, device="cpu", model_type=model_type).tree()
    p = Predictor(cfg, params, model_type=model_type)
    p.export(str(tmp_path / "art"))
    served = ExportedPredictor(str(tmp_path / "art"))
    X = np.random.default_rng(4).normal(
        size=(300, cfg.seqlength, cfg.d_total)).astype(np.float32)
    np.testing.assert_allclose(served.predict(X), p.predict(X), **TOL)
    with pytest.raises(ValueError, match="re-export"):
        ExportedPredictor(str(tmp_path / "art"), device="cpu")


def _train_operands(cfg, n, dev):
    """The training kernels' inputs at batch n: the encode's operands and
    masks, the decoder's operands, and cotangents; all on ``dev``."""
    (xp, weights, z_tot, h_dims), (h0, c0, wsum, b, dec_dims) = \
        _operands(cfg, n, dev)
    t = cfg.seqlength
    g = torch.Generator(device=dev).manual_seed(3)
    masks = cuda_mfn.make_dropout_masks(g, t, n, cuda_mfn.sizes(weights)[:4],
                                        mfn_drops(cfg))
    dh = torch.randn(n, sum(h_dims), generator=g, device=dev)
    dmem = torch.randn(n, weights["a2w2"].shape[1], generator=g, device=dev)
    dallh = torch.randn(t, n, sum(dec_dims), generator=g, device=dev)
    return ((xp, masks, weights, z_tot, h_dims, dh, dmem),
            (h0, c0, wsum, b, dec_dims, dallh))


@pytest.mark.parametrize("cfg,n", [(SMALL, 5), (best_acc_mosi_config(), 32)],
                         ids=["small", "train"])
def test_train_kernels_match_plain(cuda, cfg, n):
    (xp, masks, weights, z_tot, h_dims, dh, dmem), \
        (h0, c0, wsum, b, dec_dims, dallh) = _train_operands(cfg, n, cuda)
    t = cfg.seqlength
    with torch.inference_mode():
        got = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        want = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        # the backward kernels on the plain residuals
        res = want[2:]
        dxp, deltas = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem,
                                           z_tot, h_dims)
        want_dxp, want_deltas = cuda_mfn.mfm_encode_bwd_steps_plain(
            xp, weights, *res, dh, dmem, z_tot)
        torch.testing.assert_close(dxp, want_dxp, **GRAD)
        torch.testing.assert_close(deltas, want_deltas, **GRAD)
        dw = cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                 want_deltas, z_tot)
        want_dw = cuda_mfn.mfm_encode_dw_plain(res[1], res[2], res[3],
                                               want_deltas, weights, z_tot)
        for k in cuda_mfn.DW_NAMES:
            torch.testing.assert_close(dw[k], want_dw[k], **GRAD)
        # deterministic: a rerun gives the same bits
        again = cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                    want_deltas, z_tot)
        assert all(torch.equal(dw[k], again[k]) for k in cuda_mfn.DW_NAMES)

        allh, allc, gates = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t)
        got = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh, dec_dims)
        want = cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc, dallh)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **GRAD)
        torch.cuda.synchronize()


def test_each_train_wrapper_call_is_one_launch(cuda):
    (xp, masks, weights, z_tot, h_dims, dh, dmem), \
        (h0, c0, wsum, b, dec_dims, dallh) = _train_operands(SMALL, 3, cuda)
    before = (cuda_mfn.LAUNCHES, cuda_mfn.BWD_LAUNCHES, cuda_mfn.DW_LAUNCHES,
              cuda_lstm.BWD_LAUNCHES)
    with torch.inference_mode():
        outs = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        cuda_mfn.mfm_encode_bwd(xp, weights, *outs[2:], dh, dmem, z_tot,
                                h_dims)
        allh, allc, gates = cuda_lstm.decoder_lstm_plain(
            h0, c0, wsum, b, SMALL.seqlength)
        cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh, dec_dims)
        cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc, dallh)
    torch.cuda.synchronize()
    assert (cuda_mfn.LAUNCHES, cuda_mfn.BWD_LAUNCHES, cuda_mfn.DW_LAUNCHES,
            cuda_lstm.BWD_LAUNCHES) == tuple(x + 1 for x in before)


# the probe variants: each on the plain version's residuals against its
# plain version, in both residual layouts, one launch per call
_PROBE_COUNTERS = ("SPLIT_LAUNCHES", "RECOMPUTE_LAUNCHES",
                   "TWO_STEP_LAUNCHES", "BWD_LAUNCHES", "DW_LAUNCHES")


def _counts():
    return {k: getattr(cuda_mfn, k) for k in _PROBE_COUNTERS}


@pytest.mark.parametrize("cfg,n", [(SMALL, 5), (best_acc_mosi_config(), 32)],
                         ids=["small", "train"])
def test_probe_variants_match_plain(cuda, cfg, n):
    (xp, masks, weights, z_tot, h_dims, dh, dmem), _ = \
        _train_operands(cfg, n, cuda)
    with torch.inference_mode():
        before = _counts()
        got = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims,
                                      "split")
        assert _counts() == dict(before, SPLIT_LAUNCHES=before[
            "SPLIT_LAUNCHES"] + 1)
        want = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot,
                                             "split")
        for g, w in zip(got[:5] + got[5], want[:5] + want[5]):
            torch.testing.assert_close(g, w, **TOL)
        for layout, res in (("split", want[2:]),
                            ("cat", (*want[2:5], torch.cat(want[5], 2)))):
            for variant, counter in (("stream", "BWD_LAUNCHES"),
                                     ("recompute_att", "RECOMPUTE_LAUNCHES"),
                                     ("two_step", "TWO_STEP_LAUNCHES")):
                before = _counts()
                dxp, deltas = cuda_mfn._launch_bwd(
                    xp, weights, *res, dh, dmem, z_tot, h_dims, variant)
                assert _counts() == dict(before,
                                         **{counter: before[counter] + 1})
                want_dxp, want_deltas = cuda_mfn.mfm_encode_bwd_steps_plain(
                    xp, weights, *res, dh, dmem, z_tot,
                    recompute_att=variant == "recompute_att")
                torch.testing.assert_close(dxp, want_dxp, **GRAD)
                torch.testing.assert_close(deltas, want_deltas, **GRAD)
            dw = cuda_mfn._launch_dw(weights, res[1], res[2], res[3],
                                     want_deltas, z_tot)
            want_dw = cuda_mfn.mfm_encode_dw_plain(res[1], res[2], res[3],
                                                   want_deltas, weights,
                                                   z_tot)
            for k in cuda_mfn.DW_NAMES:
                torch.testing.assert_close(dw[k], want_dw[k], **GRAD)
        torch.cuda.synchronize()


def test_two_step_needs_an_even_t(cuda):
    (xp, masks, weights, z_tot, h_dims, dh, dmem), _ = \
        _train_operands(SMALL.replace(seqlength=5), 3, cuda)
    outs = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
    before = _counts()
    with pytest.raises(ValueError, match="even t"):
        cuda_mfn.mfm_encode_bwd(xp, weights, *outs[2:], dh, dmem, z_tot,
                                h_dims, "two_step")
    assert _counts() == before


def test_layouts_and_variants_keep_the_bits(cuda):
    """The residual layout moves no bit: the split forward writes the cat
    forward's values, and each kernel reading either layout gives the same
    bits. The two-step kernel gives the stream kernel's bits; so does the
    recompute-att one on the kernel forward's residuals, whose att it
    recomputes in the forward's order of operations."""
    (xp, masks, weights, z_tot, h_dims, dh, dmem), _ = \
        _train_operands(best_acc_mosi_config(), 32, cuda)
    with torch.inference_mode():
        cat = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        split = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims,
                                        "split")
        for a, b in zip(cat[:5], split[:5]):
            assert torch.equal(a, b)
        assert torch.equal(cat[5], torch.cat(split[5], dim=2))
        stream = cuda_mfn._launch_bwd(xp, weights, *cat[2:], dh, dmem, z_tot,
                                      h_dims)
        for res, variant in ((cat[2:], "two_step"),
                             (cat[2:], "recompute_att"),
                             (split[2:], "stream"),
                             (split[2:], "recompute_att")):
            got = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                       h_dims, variant)
            assert torch.equal(got[0], stream[0]), variant
            assert torch.equal(got[1], stream[1]), variant
        dw_cat = cuda_mfn._launch_dw(weights, cat[3], cat[4], cat[5],
                                     stream[1], z_tot)
        dw_split = cuda_mfn._launch_dw(weights, split[3], split[4], split[5],
                                       stream[1], z_tot)
        assert all(torch.equal(dw_cat[k], dw_split[k])
                   for k in cuda_mfn.DW_NAMES)


def _encode_digest(mfn_ops, dev):
    """sha256 of the weight-gradient kernel's outputs on the plain
    forward's residuals (cat layout, read through the residual-layout
    table) and the plain reverse pass's deltas, at full width, n = 32,
    t = 20, on numpy-drawn inputs. The forward's and the reverse pass's
    own kernels are left out: their sums run in another order since their
    redesigns. ``mfn_ops`` is the ``cuda_mfn`` module, so that another
    build of the package can be given."""
    cfg = best_acc_mosi_config()
    h_dims = [cfg.zl_size, cfg.za_size, cfg.zv_size, *cfg.h_dims]
    H, z_tot, t, n = sum(h_dims), sum(h_dims[:3]), cfg.seqlength, 32
    m2, mem = 2 * (H - z_tot), cfg.memsize
    s1, s2, s3, s4 = (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
                      cfg.gamma2_shape)
    rng = np.random.default_rng(7)

    def w(*shape):
        return torch.from_numpy((0.1 * rng.normal(size=shape))
                                .astype(np.float32)).to(dev)

    blocks = torch.zeros(H, 4 * H)
    o = 0
    for h in h_dims:
        for g in range(4):
            blocks[o:o + h, g * H + o:g * H + o + h] = 1.0
        o += h
    weights = {
        "wh": w(H, 4 * H) * blocks.to(dev), "a1w1": w(m2, s1),
        "a1b1": w(1, s1), "a1w2": w(s1, m2), "a1b2": w(1, m2),
        "a2w1": w(m2, s2), "a2b1": w(1, s2), "a2w2": w(s2, mem),
        "a2b2": w(1, mem), "gw1": w(m2 + mem, s3 + s4),
        "gb1": w(1, s3 + s4), "g1w2": w(s3, mem), "g1b2": w(1, mem),
        "g2w2": w(s4, mem), "g2b2": w(1, mem)}
    xp = w(t, n, 4 * H) * 10.0
    keep = rng.random(size=(t, n, s1 + s2 + s3 + s4)) >= 0.3
    masks = torch.from_numpy((keep / 0.7).astype(np.float32)).to(dev)
    dh, dmem = w(n, H) * 10.0, w(n, mem) * 10.0
    with torch.inference_mode():
        fwd = mfn_ops.mfm_encode_res_plain(xp, masks, weights, z_tot)
        _, deltas = mfn_ops.mfm_encode_bwd_steps_plain(
            xp, weights, *fwd[2:], dh, dmem, z_tot)
        dw = mfn_ops._launch_dw(weights, fwd[3], fwd[4], fwd[5], deltas,
                                z_tot)
        outs = [dw[k] for k in mfn_ops.DW_NAMES]
        digest = hashlib.sha256()
        for x in outs:
            digest.update(x.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


# _encode_digest of the weight-gradient kernel (split-K tiles over
# thread-block clusters, a fixed order of sums), built with nvcc of CUDA
# 12.8 for sm_90a on an NVIDIA H100 80GB HBM3 (PyTorch 2.11): the cat
# layout, read through the residual-layout table, gives these bits
PRE_TABLE_DIGEST = (
    "a326d4e8d49486c6f62a5ced753f59fd29f04cad864588ce6cca6a56c55e5639")


def test_cat_layout_keeps_the_bits_before_the_table(cuda):
    assert _encode_digest(cuda_mfn, cuda) == PRE_TABLE_DIGEST


def test_redesigned_backward_kernels_rerun_to_the_same_bits(cuda):
    """The reverse pass's four kernels and the decoder backward sum in a
    fixed order, with no atomics."""
    (xp, masks, weights, z_tot, h_dims, dh, dmem), \
        (h0, c0, wsum, b, dec_dims, dallh) = _train_operands(
            best_acc_mosi_config(), 32, cuda)
    with torch.inference_mode():
        res = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)[2:]
        first = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                     h_dims)
        again = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                     h_dims)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        allh, allc, gates = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, 20,
                                                       dec_dims)
        first = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh, dec_dims)
        again = cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh, dec_dims)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# the weight-gradient kernel's widths (H, z_tot, mem, s1, s2, s3, s4): the
# main path's (best_acc_mosi_config), the widest encode of chip_smoke.py's
# step 11 (an MFN cell of 400, mem 400, gamma MLPs 256), and widths whose
# column offsets are not multiples of four floats (4-byte copies)
DW_MAIN = (320, 120, 64, 128, 128, 128, 128)
DW_WIDEST = (632, 120, 400, 128, 128, 256, 256)
DW_ODD = (317, 119, 63, 127, 126, 125, 129)


def _dw_operands(widths, t, n, dev, layout="cat", seed=0):
    """Random operands of the weight-gradient kernel: (weights, allc,
    allmem, res, deltas), the weights zeros that give only the shapes."""
    H, z_tot, mem, s1, s2, s3, s4 = widths
    m2 = 2 * (H - z_tot)
    shapes = {"wh": (H, 4 * H), "a1w1": (m2, s1), "a1b1": (1, s1),
              "a1w2": (s1, m2), "a1b2": (1, m2), "a2w1": (m2, s2),
              "a2b1": (1, s2), "a2w2": (s2, mem), "a2b2": (1, mem),
              "gw1": (m2 + mem, s3 + s4), "gb1": (1, s3 + s4),
              "g1w2": (s3, mem), "g1b2": (1, mem), "g2w2": (s4, mem),
              "g2b2": (1, mem)}
    weights = {k: torch.zeros(v, device=dev) for k, v in shapes.items()}
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=dev)

    offs, R = cuda_mfn.res_layout(weights)
    res = draw(t, n, R)
    if layout == "split":
        res = tuple(res[..., o:o + w].contiguous() for o, w in offs.values())
    return (weights, draw(t, n, H), draw(t, n, mem), res,
            draw(t, n, cuda_mfn.delta_layout(weights)[1]))


@pytest.mark.parametrize("widths,t,n,layout,copy", [
    (DW_MAIN, 20, 32, "cat", 16), (DW_MAIN, 20, 32, "split", 16),
    (DW_MAIN, 1, 32, "cat", 16), (DW_MAIN, 20, 1, "cat", 16),
    (DW_MAIN, 20, 7, "cat", 16), (DW_WIDEST, 20, 32, "cat", 16),
    (DW_ODD, 20, 32, "cat", 4), (DW_ODD, 3, 5, "split", 4)],
    ids=["main", "main-split", "t1", "n1", "n7", "widest", "odd",
         "odd-small"])
def test_weight_gradient_kernel_matches_plain(cuda, widths, t, n, layout,
                                              copy):
    """Against the plain version at the main path's widths, at t = 1, at
    n = 1, at a t n that is no multiple of the kernel's chunk of rows, at
    the widest encode and at widths that need 4-byte copies; a rerun gives
    the same bits; one buffer holds the 14 gradients."""
    weights, allc, allmem, res, deltas = _dw_operands(widths, t, n, cuda,
                                                      layout)
    z_tot = widths[1]
    before = cuda_mfn.DW_LAUNCHES
    with torch.inference_mode():
        got = cuda_mfn._launch_dw(weights, allc, allmem, res, deltas, z_tot)
        want = cuda_mfn.mfm_encode_dw_plain(allc, allmem, res, deltas,
                                            weights, z_tot)
        for k in cuda_mfn.DW_NAMES:
            assert got[k].shape == weights[k].shape, k
            torch.testing.assert_close(got[k], want[k], **GRAD)
        again = cuda_mfn._launch_dw(weights, allc, allmem, res, deltas,
                                    z_tot)
        assert all(torch.equal(got[k], again[k]) for k in cuda_mfn.DW_NAMES)
    torch.cuda.synchronize()
    assert cuda_mfn.DW_LAUNCHES == before + 2
    assert cuda_mfn.DW_PLAN == {"cluster": cuda_mfn.dw_cluster(weights,
                                                               t * n),
                                "copy_bytes": copy}


# shapes at which the host picks each cluster size (dw_cluster)
@pytest.mark.parametrize("widths,t,n,cluster", [
    (DW_WIDEST, 20, 32, 1), ((15, 6, 6, 8, 8, 8, 8), 5, 20, 2),
    (DW_MAIN, 20, 32, 4), ((15, 6, 6, 8, 8, 8, 8), 20, 32, 8)],
    ids=["S1", "S2", "S4", "S8"])
def test_weight_gradient_kernel_takes_each_cluster_size(cuda, widths, t, n,
                                                        cluster):
    weights, allc, allmem, res, deltas = _dw_operands(widths, t, n, cuda,
                                                      seed=1)
    with torch.inference_mode():
        got = cuda_mfn._launch_dw(weights, allc, allmem, res, deltas,
                                  widths[1])
        want = cuda_mfn.mfm_encode_dw_plain(allc, allmem, res, deltas,
                                            weights, widths[1])
        for k in cuda_mfn.DW_NAMES:
            torch.testing.assert_close(got[k], want[k], **GRAD)
    torch.cuda.synchronize()
    assert cuda_mfn.DW_PLAN["cluster"] == cluster


def _chain_operands(h_dims, t, n, dev, seed):
    """Random operands of the two recurrences' backward chains over the
    fused cells ``h_dims``: (w, gates, allc, dallh, dhlast), the weight
    block-diagonal."""
    H = sum(h_dims)
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = torch.zeros(H, 4 * H, device=dev)
    o = 0
    for h in h_dims:
        for q in range(4):
            blocks[o:o + h, q * H + o:q * H + o + h] = 1.0
        o += h
    w = 0.1 * torch.randn(H, 4 * H, generator=g, device=dev) * blocks
    return (w, torch.randn(t, n, 4 * H, generator=g, device=dev),
            torch.randn(t, n, H, generator=g, device=dev),
            torch.randn(t, n, H, generator=g, device=dev),
            torch.randn(n, H, generator=g, device=dev))


def test_a_cell_past_one_block_runs_on_a_cluster(cuda):
    """A 120-unit cell's diagonal blocks (225 KiB) and a memory chain of
    mem 128 with both gamma MLPs 128 wide (256 KiB) pass one block's
    shared memory: every chain kernel splits them over a cluster of 2,
    equals its plain version and reruns to the same bits."""
    cfg = SMALL.replace(h_dims=[120, 5, 4], memsize=128, gamma1_shape=128,
                        gamma2_shape=128)
    (xp, masks, weights, z_tot, h_dims, dh, dmem), _ = \
        _train_operands(cfg, 3, cuda)
    with torch.inference_mode():
        got = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
        assert min(cuda_mfn.CLUSTERS["mfm_encode_fwd"]) >= 2
        for g, w in zip(got, cuda_mfn.mfm_encode_plain(xp, weights, z_tot)):
            torch.testing.assert_close(g, w, **TOL)
        got = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        assert cuda_mfn.CLUSTERS["mfm_encode_fwd"] == (2, 2)
        want = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        again = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        res = want[2:]
        first = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                     h_dims)
        assert cuda_mfn.CLUSTERS["mfm_encode_bwd"] == (2, 2)
        ref = cuda_mfn.mfm_encode_bwd_steps_plain(xp, weights, *res, dh,
                                                  dmem, z_tot)
        for g, w in zip(first, ref):
            torch.testing.assert_close(g, w, **GRAD)
        again = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem, z_tot,
                                     h_dims)
        assert all(torch.equal(a, b) for a, b in zip(first, again))

        w, gates, allc, dallh, dhlast = _chain_operands([120, 24], 6, 3,
                                                        cuda, 8)
        got = cuda_lstm.decoder_lstm_bwd(w, gates, allc, dallh, [120, 24])
        assert cuda_lstm.CLUSTERS["decoder_lstm_bwd"] == 2
        for g, r in zip(got, cuda_lstm.decoder_lstm_bwd_plain(
                w, gates, allc, dallh)):
            torch.testing.assert_close(g, r, **GRAD)
        again = cuda_lstm.decoder_lstm_bwd(w, gates, allc, dallh, [120, 24])
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        got = cuda_lstm.multi_lstm_bwd(gates, w, allc, dhlast, [120, 24])
        assert cuda_lstm.CLUSTERS["multi_lstm_bwd"] == 2
        torch.testing.assert_close(
            got, cuda_lstm.multi_lstm_bwd_plain(gates, w, allc, dhlast),
            **GRAD)
        assert torch.equal(got, cuda_lstm.multi_lstm_bwd(gates, w, allc,
                                                         dhlast, [120, 24]))
        torch.cuda.synchronize()


def test_a_cell_past_a_cluster_of_8_reads_its_weights_from_l2(cuda):
    """A 400-unit cell's diagonal blocks (2.4 MiB), and a memory chain of
    mem 400 with both gamma MLPs 256 wide (1.6 MiB), pass the shared memory
    of a cluster of 8 blocks: every chain kernel plans to read them from L2
    (plan 0, counted in ``L2_LAUNCHES``), raises nothing, and equals its
    plain version."""
    cfg = SMALL.replace(h_dims=[400, 5, 4], memsize=400, gamma1_shape=256,
                        gamma2_shape=256)
    (xp, masks, weights, z_tot, h_dims, dh, dmem), _ = \
        _train_operands(cfg, 3, cuda)
    w, gates, allc, dallh, dhlast = _chain_operands([400, 24], 4, 3, cuda, 9)
    g = torch.Generator(device=cuda).manual_seed(10)
    h0, c0 = (torch.randn(3, 424, generator=g, device=cuda) for _ in "hc")
    b = torch.randn(1, 4 * 424, generator=g, device=cuda)
    for module in (cuda_mfn, cuda_lstm):
        module.L2_LAUNCHES.clear()
    with torch.inference_mode():
        for got, want in zip(
                cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
                cuda_mfn.mfm_encode_plain(xp, weights, z_tot)):
            torch.testing.assert_close(got, want, **TOL)
        assert cuda_mfn.CLUSTERS["mfm_encode_fwd"] == (0, 0)
        res = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)
        for got, want in zip(
                cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims),
                res):
            torch.testing.assert_close(got, want, **TOL)
        for got, want in zip(
                cuda_mfn._launch_bwd(xp, weights, *res[2:], dh, dmem, z_tot,
                                     h_dims),
                cuda_mfn.mfm_encode_bwd_steps_plain(xp, weights, *res[2:],
                                                    dh, dmem, z_tot)):
            torch.testing.assert_close(got, want, **GRAD)
        assert cuda_mfn.CLUSTERS["mfm_encode_bwd"] == (0, 0)
        for got, want in zip(
                cuda_lstm.decoder_lstm_fwd(h0, c0, w, b, 4, [400, 24]),
                cuda_lstm.decoder_lstm_plain(h0, c0, w, b, 4)):
            torch.testing.assert_close(got, want, **TOL)
        for got, want in zip(
                cuda_lstm.decoder_lstm_bwd(w, gates, allc, dallh, [400, 24]),
                cuda_lstm.decoder_lstm_bwd_plain(w, gates, allc, dallh)):
            torch.testing.assert_close(got, want, **GRAD)
        for with_res in (False, True):
            torch.testing.assert_close(
                cuda_lstm.multi_lstm_fwd(gates, w, [400, 24], with_res),
                cuda_lstm.multi_lstm_plain(gates, w, with_res), **TOL)
        torch.testing.assert_close(
            cuda_lstm.multi_lstm_bwd(gates, w, allc, dhlast, [400, 24]),
            cuda_lstm.multi_lstm_bwd_plain(gates, w, allc, dhlast), **GRAD)
        torch.cuda.synchronize()
    assert cuda_mfn.L2_LAUNCHES == {"mfm_encode_fwd": 2, "mfm_encode_bwd": 1}
    assert cuda_lstm.L2_LAUNCHES == {"decoder_lstm_fwd": 1,
                                     "decoder_lstm_bwd": 1,
                                     "multi_lstm_fwd": 2,
                                     "multi_lstm_bwd": 1}
    assert all(cuda_lstm.CLUSTERS[k] == 0 for k in cuda_lstm.L2_LAUNCHES)


# each chain just past the width at which a block's per-row state alone
# passed its shared memory (chip_smoke.py step 16): (kernel, cells, mem)
PAST_STATE = {
    "encode_eval": ("mfm_encode_fwd", [600, 5, 4], 6),
    "multi_eval": ("multi_lstm_fwd", [600, 24], None),
    "encode_bwd": ("mfm_encode_bwd", [1400, 5, 4], 6),
    "multi_bwd": ("multi_lstm_bwd", [1700, 24], None),
    "decoder_fwd": ("decoder_lstm_fwd", [2200, 24], None),
    "multi_train": ("multi_lstm_fwd", [2200, 24], None),
    "decoder_bwd": ("decoder_lstm_bwd", [3000], None),
    "memory_eval": ("mfm_encode_fwd", [6, 5, 4], 7400),
    "memory_bwd": ("mfm_encode_bwd", [6, 5, 4], 7400),
}


@pytest.mark.parametrize("case", list(PAST_STATE))
def test_a_chain_past_a_blocks_state_keeps_it_in_device_memory(cuda, case):
    """Where even a chain's per-row state passes a block's shared memory
    (a launch the kernels refused before), the chain reads its weights
    from L2 and keeps that state in device memory (plan
    ``cuda_lstm.SCRATCH``, counted in ``SCRATCH_LAUNCHES``), and equals
    its plain version (t = 4, n = 8)."""
    name, cells, mem = PAST_STATE[case]
    t, n = 4, 8
    with torch.inference_mode():
        if name.startswith("mfm"):
            cfg = SMALL.replace(h_dims=cells, memsize=mem, seqlength=t)
            (xp, masks, weights, z_tot, h_dims, dh, dmem), _ = \
                _train_operands(cfg, n, cuda)
            # building the operands ran the eval encode: count from here
            cuda_mfn.SCRATCH_LAUNCHES.clear()
            if name == "mfm_encode_fwd":
                pairs = zip(cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
                            cuda_mfn.mfm_encode_plain(xp, weights, z_tot))
                tol = TOL
            else:
                res = cuda_mfn.mfm_encode_res_plain(xp, masks, weights,
                                                    z_tot)
                pairs = zip(cuda_mfn._launch_bwd(xp, weights, *res[2:], dh,
                                                 dmem, z_tot, h_dims),
                            cuda_mfn.mfm_encode_bwd_steps_plain(
                                xp, weights, *res[2:], dh, dmem, z_tot))
                tol = GRAD
            plan = cuda_mfn.CLUSTERS[name]
            counted = cuda_mfn.SCRATCH_LAUNCHES
        else:
            w, gates, allc, dallh, dhlast = _chain_operands(cells, t, n,
                                                            cuda, 11)
            w = w * (2.0 / max(cells) ** 0.5)
            H = sum(cells)
            cuda_lstm.SCRATCH_LAUNCHES.clear()
            if name == "decoder_lstm_fwd":
                g = torch.Generator(device=cuda).manual_seed(12)
                h0, c0 = (torch.randn(n, H, generator=g, device=cuda)
                          for _ in "hc")
                b = torch.randn(1, 4 * H, generator=g, device=cuda)
                pairs = zip(cuda_lstm.decoder_lstm_fwd(h0, c0, w, b, t, cells),
                            cuda_lstm.decoder_lstm_plain(h0, c0, w, b, t))
                tol = TOL
            elif name == "decoder_lstm_bwd":
                pairs = zip(cuda_lstm.decoder_lstm_bwd(w, gates, allc, dallh,
                                                       cells),
                            cuda_lstm.decoder_lstm_bwd_plain(w, gates, allc,
                                                             dallh))
                tol = GRAD
            elif name == "multi_lstm_fwd":
                train = case == "multi_train"
                got = cuda_lstm.multi_lstm_fwd(gates, w, cells, train)
                want = cuda_lstm.multi_lstm_plain(gates, w, train)
                pairs = zip(got, want) if train else [(got, want)]
                tol = TOL
            else:
                pairs = [(cuda_lstm.multi_lstm_bwd(gates, w, allc, dhlast,
                                                   cells),
                          cuda_lstm.multi_lstm_bwd_plain(gates, w, allc,
                                                         dhlast))]
                tol = GRAD
            plan = cuda_lstm.CLUSTERS[name]
            counted = cuda_lstm.SCRATCH_LAUNCHES
        for got, want in pairs:
            torch.testing.assert_close(got, want, **tol)
        torch.cuda.synchronize()
    assert cuda_lstm.SCRATCH in (plan if isinstance(plan, tuple) else (plan,))
    assert counted == {name: 1}


@pytest.mark.parametrize("cfg,n_eval,n_train",
                         [(SMALL, 5, 3), (best_acc_mosi_config(), 256, 32)],
                         ids=["small", "full"])
def test_encode_forward_passes_match_plain(cuda, cfg, n_eval, n_train):
    """The forward's three passes, eval and train, both layouts, masks on
    and off, against the plain mirror of the passes on the card."""
    (xp, weights, z_tot, h_dims), _ = _operands(cfg, n_eval, cuda)
    with torch.inference_mode():
        got = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims)
        want = cuda_mfn.mfm_encode_fwd_passes_plain(xp, weights, z_tot,
                                                    h_dims)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
    (xp, masks, weights, z_tot, h_dims, _, _), _ = \
        _train_operands(cfg, n_train, cuda)
    with torch.inference_mode():
        for m in (masks, None):
            got = cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims, m)
            want = cuda_mfn.mfm_encode_fwd_passes_plain(xp, weights, z_tot,
                                                        h_dims, m)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **TOL)
            for layout in cuda_mfn.LAYOUTS:
                got = cuda_mfn.mfm_encode_res(xp, m, weights, z_tot, h_dims,
                                              layout)
                want = cuda_mfn.mfm_encode_fwd_passes_plain(
                    xp, weights, z_tot, h_dims, m, True, layout)
                flat = (lambda o: (*o[:5], *o[5]) if layout == "split"
                        else o)
                for g, w in zip(flat(got), flat(want)):
                    torch.testing.assert_close(g, w, **TOL)
                again = cuda_mfn.mfm_encode_res(xp, m, weights, z_tot,
                                                h_dims, layout)
                assert all(torch.equal(a, b)
                           for a, b in zip(flat(got), flat(again)))
        torch.cuda.synchronize()


def _multi_operands(cfg, model_type, n, dev):
    """The fused encoder-cell kernels' inputs as the ``kl_ef`` or
    ``missing`` forward builds them, and a cotangent of h_last."""
    params = mfm.MFM(cfg, seed=0, device=dev, model_type=model_type).tree()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((cfg.seqlength, n, cfg.d_total), generator=g, device=dev)
    with torch.inference_mode():
        xp, wh, h_dims = mfm.multi_lstm_operands(params, x, cfg, model_type)
    dh = torch.randn((n, sum(h_dims)), generator=g, device=dev)
    return xp, wh, h_dims, dh


@pytest.mark.parametrize("model_type", ["kl_ef", "missing"])
@pytest.mark.parametrize("cfg,n_eval,n_train",
                         [(SMALL, 5, 3), (best_acc_mosi_config(), 256, 32)],
                         ids=["small", "full"])
def test_multi_lstm_kernels_match_plain(cuda, model_type, cfg, n_eval,
                                        n_train):
    xp, wh, h_dims, _ = _multi_operands(cfg, model_type, n_eval, cuda)
    with torch.inference_mode():
        torch.testing.assert_close(
            cuda_lstm.multi_lstm_fwd(xp, wh, h_dims),
            cuda_lstm.multi_lstm_plain(xp, wh), **TOL)
    xp, wh, h_dims, dh = _multi_operands(cfg, model_type, n_train, cuda)
    with torch.inference_mode():
        got = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims, with_res=True)
        want = cuda_lstm.multi_lstm_plain(xp, wh, with_res=True)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        _, _, allc, gates = want
        dxp = cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims)
        torch.testing.assert_close(
            dxp, cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh), **GRAD)
        # deterministic: a rerun gives the same bits
        assert torch.equal(dxp, cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh,
                                                         h_dims))
        torch.cuda.synchronize()


def test_each_multi_lstm_call_is_one_launch(cuda):
    xp, wh, h_dims, dh = _multi_operands(SMALL, "kl_ef", 3, cuda)
    before = (cuda_lstm.MULTI_LAUNCHES, cuda_lstm.MULTI_BWD_LAUNCHES)
    with torch.inference_mode():
        cuda_lstm.multi_lstm(xp, wh, h_dims)
        _, _, allc, gates = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims,
                                                     with_res=True)
        cuda_lstm.multi_lstm_plain(xp, wh, with_res=True)
        cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims)
        cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh)
    torch.cuda.synchronize()
    assert (cuda_lstm.MULTI_LAUNCHES, cuda_lstm.MULTI_BWD_LAUNCHES) == (
        before[0] + 2, before[1] + 1)


def _zf_masks(cfg, n, g):
    """Scaled keep-masks of the four z->f sites (zy's rate is 0: None)."""
    return [None] + [
        (torch.rand((n, f), generator=g) >= r).float() / (1.0 - r)
        for f, r in ((cfg.fl_size, cfg.zl_to_fl_dropout),
                     (cfg.fa_size, cfg.za_to_fa_dropout),
                     (cfg.fv_size, cfg.zv_to_fv_dropout))]


def _to(v, dev):
    """v moved to dev: a tensor, None, or a list or dict of them, nested."""
    if isinstance(v, dict):
        return {k: _to(u, dev) for k, u in v.items()}
    if isinstance(v, list):
        return [_to(u, dev) for u in v]
    return None if v is None else v.to(dev)


# each model's forward and the loss its trainer takes a step on
_STEPS = {"mfm": (mfm.mfm_apply, "joint", 0),
          "kl_ef": (mfm.mfm_kl_ef_apply, "beta_vae", 1),
          "missing": (mfm.mfm_missing_apply, "missing", 0)}


def _step_grads(model_type, devices):
    """One train step's gradients of ``model_type`` at SMALL on each of
    ``devices``: the same parameters, batch and injected draws."""
    cfg = SMALL.replace(batchsize=4)
    n, t = 4, cfg.seqlength
    params = mfm.MFM(cfg, seed=5, device="cpu", model_type=model_type).tree()
    g = torch.Generator().manual_seed(6)
    x = torch.randn(t, n, cfg.d_total, generator=g)
    y = torch.randn(n, generator=g)
    encode = {
        "encode_masks": cuda_mfn.make_dropout_masks(
            g, t, n, (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
                      cfg.gamma2_shape), mfn_drops(cfg)),
        "mmd_noise": torch.randn(mfm.mmd_noise_shape(cfg, n), generator=g),
    }
    draws = {"mfm": dict(encode, zf_masks=_zf_masks(cfg, n, g)),
             "kl_ef": {"zf_masks": _zf_masks(cfg, n, g)},
             "missing": dict(encode, zf_masks=[_zf_masks(cfg, n, g)
                                               for _ in range(4)])}
    apply_fn, variant, stage = _STEPS[model_type]
    loss_fn = make_loss_fn(apply_fn, cfg, variant, stage)
    grads = []
    for dev in devices:
        tree = {k: v.detach().to(dev).requires_grad_()
                for k, v in to_state_dict(params).items()}
        loss, _ = loss_fn(from_state_dict(tree), x.to(dev), y.to(dev),
                          draws=_to(draws[model_type], dev))
        loss.backward()
        # stage 1 of kl_ef does not reach the y head: no gradient there
        grads.append({k: (torch.zeros_like(v) if v.grad is None
                          else v.grad).cpu() for k, v in tree.items()})
    return grads


@pytest.mark.parametrize("model_type", list(_STEPS))
def test_train_step_grads_on_the_card_match_the_cpu(cuda, model_type):
    cpu, card = _step_grads(model_type, ("cpu", cuda))
    for k in cpu:
        torch.testing.assert_close(card[k], cpu[k], **GRAD)


def _train_small(cuda, monkeypatch, host, model_type):
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.utils.logging import RunLogger

    rng = np.random.default_rng(7)

    def split(k):
        X = rng.normal(size=(k, 6, SMALL.d_total)).astype(np.float32)
        return X, X[:, -1, :3].sum(1).astype(np.float32)

    data = (*split(40), *split(12), *split(10))
    with monkeypatch.context() as m:
        m.setenv("FACTORIZED_TPU_EPOCH_CHUNK", "2")
        if host:
            m.setenv("FACTORIZED_TPU_HOST_LOOP", "1")
        else:
            m.delenv("FACTORIZED_TPU_HOST_LOOP", raising=False)
        before = counts.snapshot()
        trainer = (trainers.train_beta_vae if model_type == "kl_ef"
                   else trainers.train_mfm)
        res = trainer(*data, SMALL.replace(batchsize=8, num_epochs=3,
                                           model_type=model_type),
                      seed=1, device=cuda, logger=RunLogger(echo=False))
    return res, counts.since(before)


@pytest.mark.parametrize("model_type", ["mfm", "kl_ef"])
def test_graph_loop_equals_the_host_loop(cuda, monkeypatch, model_type):
    """train_mfm, and train_beta_vae's two stages (one graph each), at
    small widths, 3 epochs in chunks of 2: each epoch after a program's
    first one graph replay, against the per-epoch host loop: the same
    history and returned parameters bit for bit, and the replays count
    each kernel's launches as the eager epochs do."""
    host, host_launches = _train_small(cuda, monkeypatch, True, model_type)
    graph, graph_launches = _train_small(cuda, monkeypatch, False,
                                         model_type)
    # the lr the host loop records is the host scheduler's float, the
    # graph loop's the float32 the step read (as the JAX package's loops)
    assert [dict(e, lr=np.float32(e["lr"])) for e in host["history"]] == \
        [dict(e, lr=np.float32(e["lr"])) for e in graph["history"]]
    for k, v in to_state_dict(host["params"]).items():
        assert torch.equal(v, to_state_dict(graph["params"])[k]), k
    assert graph_launches == host_launches
    assert graph_launches[(cuda_lstm, "LAUNCHES")] > 0


def test_graph_replays_draw_new_masks(cuda):
    from factorized_tpu_torch.train import Graphed

    def draw(gen):
        return cuda_mfn.make_dropout_masks(gen, 6, 5, (8, 8, 8, 8),
                                           (0.5, 0.5, 0.5, 0.5))

    eager_gen = torch.Generator(device=cuda).manual_seed(3)
    eager = [draw(eager_gen) for _ in range(3)]
    gen = torch.Generator(device=cuda).manual_seed(3)
    out = torch.empty_like(eager[0])
    graph = Graphed(lambda: out.copy_(draw(gen)), (gen,))
    got = []
    for _ in range(3):  # eager warm-up; capture and replay; replay
        graph()
        got.append(out.clone())
    assert not torch.equal(got[1], got[2])
    assert all(torch.equal(a, b) for a, b in zip(got, eager))


def test_the_epoch_graph_records_its_spans_and_nodes(cuda):
    """train_mfm at the flagship widths on 10 batches, 4 epochs: one eager
    epoch, one capture split into prepare, record and instantiate (the
    three within 2% of it), a replay an epoch after the first; the step
    phases only in the eager epoch and under the capture's record; the
    graph's node count in the capture's attributes, and ``Graphed``'s own
    ``nodes`` and ``capture_ms`` from the same span."""
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.train import Graphed
    from factorized_tpu_torch.utils import profiling
    from factorized_tpu_torch.utils.logging import RunLogger

    cfg = best_acc_mosi_config().replace(num_epochs=4)
    rng = np.random.default_rng(0)
    data = []
    for n in (10 * cfg.batchsize, 64, 64):
        data += [rng.normal(size=(n, cfg.seqlength, cfg.d_total))
                 .astype(np.float32), rng.normal(size=n).astype(np.float32)]
    profiling.clear()
    trainers.train_mfm(*data, cfg, device=cuda, logger=RunLogger(echo=False))
    recs = profiling.spans()
    by = {r.index: r for r in recs}

    def named(name):
        return [r for r in recs if r.name == name]

    (eager,), (cap,) = named("graph.eager"), named("graph.capture")
    assert len(named("graph.replay")) == cfg.num_epochs - 1
    assert cap.attrs["nodes"] > 0 and cap.attrs["pool_bytes"] > 0
    parts = [named(n) for n in ("capture.prepare", "capture.record",
                                "capture.instantiate")]
    assert all(len(p) == 1 and p[0].parent == cap.index for p in parts)
    assert sum(p[0].seconds for p in parts) == pytest.approx(cap.seconds,
                                                             rel=0.02)
    for phase in ("step.forward", "step.backward", "step.optimizer"):
        assert sorted(by[r.parent].name for r in named(phase)) == \
            ["capture.record"] * 10 + ["graph.eager"] * 10
    assert {by[r.parent].name for r in named("epoch.eval")} == {
        "graph.eager", "capture.record"}

    out = torch.zeros(4, device=cuda)
    graph = Graphed(lambda: out.add_(1.0))
    for _ in range(3):
        graph()
    (small,) = [r for r in profiling.spans()
                if r.name == "graph.capture" and r.index > cap.index]
    assert graph.nodes == small.attrs["nodes"] > 0
    assert graph.capture_ms == pytest.approx(small.seconds * 1e3)
    assert out.tolist() == [3.0] * 4


# ------------------------------------------------------------ ablations

@pytest.mark.parametrize("model_type", ["m_a", "m_b", "m_c", "m_d"])
def test_ablation_kernels_match_plain(cuda, model_type):
    """The kernels at the shapes the ablations give them, full width: the
    encode with one encoder cell over the whole input (m_a, z_tot 32) or
    none (m_c, z_tot 0), eval at n = 256 and train, backward and weight
    gradients at n = 32; the encoder trio [32, 8, 80] (m_b, m_d) and the
    decoder trios [104] * 3, [88, 8, 8] and [16] * 3, forward and
    backward at n = 32 (the trio's eval forward at n = 256)."""
    from factorized_tpu_torch.models import ablations

    cfg = best_acc_mosi_config(model_type=model_type)
    params = mfm.MFM(cfg, seed=5, device=cuda).tree()
    g = torch.Generator(device=cuda).manual_seed(6)
    t = cfg.seqlength
    with torch.inference_mode():
        for n in (256, 32):
            x = torch.randn((t, n, cfg.d_total), generator=g, device=cuda)
            ops = ablations.kernel_operands(params, x, cfg, model_type)
            if "encode" in ops:
                xp, weights, z_tot, h_dims = ops["encode"]
                assert z_tot == {"m_a": 32, "m_c": 0}[model_type]
                if n == 256:
                    for a, b in zip(
                            cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
                            cuda_mfn.mfm_encode_plain(xp, weights, z_tot)):
                        torch.testing.assert_close(a, b, **TOL)
                    continue
                masks = cuda_mfn.make_dropout_masks(
                    g, t, n, cuda_mfn.sizes(weights)[:4], mfn_drops(cfg))
                got = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot,
                                              h_dims)
                want = cuda_mfn.mfm_encode_res_plain(xp, masks, weights,
                                                     z_tot)
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, **TOL)
                res = want[2:]
                dh = torch.randn((n, sum(h_dims)), generator=g, device=cuda)
                dmem = torch.randn((n, cfg.memsize), generator=g,
                                   device=cuda)
                dxp, dw = cuda_mfn.mfm_encode_bwd(xp, weights, *res, dh,
                                                  dmem, z_tot, h_dims)
                want_dxp, want_dw = cuda_mfn.mfm_encode_bwd_plain(
                    xp, weights, *res, dh, dmem, z_tot)
                torch.testing.assert_close(dxp, want_dxp, **GRAD)
                for k in cuda_mfn.W_NAMES:
                    torch.testing.assert_close(dw[k], want_dw[k], **GRAD)
            else:
                xp, wh, h_dims = ops["multi_lstm"]
                assert h_dims == [32, 8, 80]
                torch.testing.assert_close(
                    cuda_lstm.multi_lstm_fwd(xp, wh, h_dims),
                    cuda_lstm.multi_lstm_plain(xp, wh), **TOL)
                if n == 256:
                    continue
                for a, b in zip(
                        cuda_lstm.multi_lstm_fwd(xp, wh, h_dims, True),
                        cuda_lstm.multi_lstm_plain(xp, wh, True)):
                    torch.testing.assert_close(a, b, **TOL)
                _, _, allc, gates = cuda_lstm.multi_lstm_plain(xp, wh, True)
                dh = torch.randn((n, sum(h_dims)), generator=g, device=cuda)
                torch.testing.assert_close(
                    cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims),
                    cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh),
                    **GRAD)
            if "decoder" not in ops or n == 256:
                continue
            h0, c0, wsum, b, dec_dims = ops["decoder"]
            assert dec_dims == {"m_a": [104] * 3, "m_b": [88, 8, 8],
                                "m_c": [16] * 3}[model_type]
            got = cuda_lstm.decoder_lstm_fwd(h0, c0, wsum, b, t, dec_dims)
            want = cuda_lstm.decoder_lstm_plain(h0, c0, wsum, b, t)
            for a, b_ in zip(got, want):
                torch.testing.assert_close(a, b_, **TOL)
            allh, allc, gates = want
            dallh = torch.randn(allh.shape, generator=g, device=cuda)
            for a, b_ in zip(
                    cuda_lstm.decoder_lstm_bwd(wsum, gates, allc, dallh,
                                               dec_dims),
                    cuda_lstm.decoder_lstm_bwd_plain(wsum, gates, allc,
                                                     dallh)):
                torch.testing.assert_close(a, b_, **GRAD)
        torch.cuda.synchronize()


@pytest.mark.parametrize("model_type", ["m_a", "m_b", "m_c", "m_d"])
def test_ablation_train_step_grads_match_the_cpu(cuda, model_type):
    """One joint train step of each ablation at full width, n = 32, with
    the same injected draws: the card's gradients against the CPU's."""
    cfg = best_acc_mosi_config(model_type=model_type)
    t, n = cfg.seqlength, 32
    params = mfm.MFM(cfg, seed=7, device="cpu").tree()
    g = torch.Generator().manual_seed(8)
    x = torch.randn((t, n, cfg.d_total), generator=g)
    y = torch.randn((n,), generator=g)

    def mask(f, rate):
        return (torch.rand((n, f), generator=g) >= rate).float() / (1 - rate)

    encode = cuda_mfn.make_dropout_masks(
        g, t, n, (cfg.att1_shape, cfg.att2_shape, cfg.gamma1_shape,
                  cfg.gamma2_shape), mfn_drops(cfg))
    fy = mask(cfg.fy_size, cfg.fy_to_y_dropout)
    draws = {
        "m_a": dict(encode_masks=encode,
                    mmd_noise=[torch.randn((n, cfg.zl_size), generator=g),
                               torch.randn((n, cfg.zy_size), generator=g)],
                    zf_masks=[mask(cfg.fy_size, cfg.zy_to_fy_dropout),
                              mask(cfg.fl_size, cfg.zl_to_fl_dropout)],
                    y_mask=fy),
        "m_b": dict(mmd_noise=[torch.randn((n, z), generator=g) for z in
                               (cfg.zl_size, cfg.za_size, cfg.zv_size)],
                    zf_masks=[mask(cfg.fl_size, cfg.zl_to_fl_dropout),
                              mask(cfg.fa_size, cfg.za_to_fa_dropout),
                              mask(cfg.fv_size, cfg.zv_to_fv_dropout)],
                    y_mask=fy),
        "m_c": dict(encode_masks=encode,
                    mmd_noise=[torch.randn((n, cfg.zy_size), generator=g)],
                    zf_masks=[mask(cfg.fy_size, cfg.zy_to_fy_dropout)],
                    y_mask=fy),
        "m_d": dict(zf_masks=[mask(cfg.fl_size, cfg.zl_to_fl_dropout),
                              mask(cfg.fa_size, cfg.za_to_fa_dropout),
                              mask(cfg.fv_size, cfg.zv_to_fv_dropout)]),
    }[model_type]
    loss_fn = make_loss_fn(get_model(model_type)[1], cfg)
    grads = []
    for dev in ("cpu", cuda):
        tree = {k: v.detach().to(dev).requires_grad_()
                for k, v in to_state_dict(params).items()}
        loss, _ = loss_fn(from_state_dict(tree), x.to(dev), y.to(dev),
                          draws=_to(draws, dev))
        loss.backward()
        grads.append({k: (torch.zeros_like(v) if v.grad is None
                          else v.grad).cpu() for k, v in tree.items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], **GRAD)


@pytest.mark.parametrize("name", ["mfn_mae", "mfn_acc"])
def test_released_checkpoints_on_the_card_match_the_cpu(cuda, name):
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "factorized_tpu_torch", "released",
        name)
    X = np.random.default_rng(9).normal(size=(300, 20, 325)).astype(
        np.float32)
    y = Predictor.from_checkpoint(path).predict(X)
    np.testing.assert_allclose(
        y, Predictor.from_checkpoint(path, device="cpu").predict(X), **TOL)


# ------------------------------------------------------------ baselines

@pytest.mark.parametrize("model_type", ["s2s", "bm"])
def test_baseline_forward_and_grads_match_the_cpu(cuda, model_type):
    """``s2s`` and ``bm`` at full width, n = 32, the same injected draws:
    the train forward on the card (its encoder trio through
    ``multi_lstm_fwd`` over inputs of 305, 320 and 25 floats, ``s2s``'s
    decoders [88, 8, 8] through ``decoder_lstm_fwd``) against the CPU's
    plain versions, and the loss's gradients (``multi_lstm_bwd``,
    ``decoder_lstm_bwd``), each kernel launched once a step."""
    # bm's three heads drop at zy_to_fy_dropout, 0 in the pinned config
    cfg = best_acc_mosi_config(model_type=model_type, missing=1,
                               zy_to_fy_dropout=0.5)
    t, n = cfg.seqlength, 32
    params = mfm.MFM(cfg, seed=11, device="cpu").tree()
    g = torch.Generator().manual_seed(12)
    x = torch.randn((t, n, cfg.d_total), generator=g)
    y = torch.randn((n,), generator=g)
    draws = baselines.train_draws(cfg, n, g)
    apply_fn = get_model(model_type)[1]
    loss_fn = make_loss_fn(apply_fn, cfg, model_type)
    outs, grads = [], []
    for dev in ("cpu", cuda):
        before = counts.snapshot()
        tree = {k: v.detach().to(dev).requires_grad_()
                for k, v in to_state_dict(params).items()}
        out = apply_fn(from_state_dict(tree), x.to(dev), cfg, train=True,
                       **_to(draws, dev))
        outs.append([(o[0] if isinstance(o, list) else o).detach().cpu()
                     for o in out])
        loss, _ = loss_fn(from_state_dict(tree), x.to(dev), y.to(dev),
                          draws=_to(draws, dev))
        loss.backward()
        grads.append({k: (torch.zeros_like(v) if v.grad is None
                          else v.grad).cpu() for k, v in tree.items()})
        launched = counts.since(before)
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, **TOL)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], **GRAD)
    # the forward and the loss's forward, then one backward
    want = {"MULTI_LAUNCHES": 2, "MULTI_BWD_LAUNCHES": 1,
            "LAUNCHES": 2 if model_type == "s2s" else 0,
            "BWD_LAUNCHES": 1 if model_type == "s2s" else 0}
    assert {k: launched[(cuda_lstm, k)] for k in want} == want


@pytest.mark.parametrize("kind,n_train", [("mae", 128), ("acc", 128)])
def test_mfn_predictor_encode_kernels_match_plain(cuda, kind, n_train):
    """The encode at ``best_mfn_mosi_config``'s widths, no encoder cell
    (``acc``: mem 400, att_in 304, gamma_in 704): the train forward with
    masks and residuals, the reverse pass and the weight gradients at the
    configs' batch of 128, against their plain versions; for ``mae`` the
    eval forward at the serving batch of 256 too."""
    from factorized_tpu_torch.config import best_mfn_mosi_config
    from factorized_tpu_torch.models.common import split_modalities
    from factorized_tpu_torch.ops.fused import encode_operands

    cfg = best_mfn_mosi_config(kind)
    t = cfg.seqlength
    mfn_params = mfm.MFM(cfg, seed=13, device=cuda,
                         model_type="mfn").tree()["mfn"]
    g = torch.Generator(device=cuda).manual_seed(14)

    def operands(n):
        x = torch.randn((t, n, cfg.d_total), generator=g, device=cuda)
        return encode_operands([], mfn_params,
                               *split_modalities(x, cfg.input_dims), ())

    with torch.inference_mode():
        if kind == "mae":
            xp, weights, z_tot, h_dims = operands(256)
            for a, b in zip(cuda_mfn.mfm_encode(xp, weights, z_tot, h_dims),
                            cuda_mfn.mfm_encode_plain(xp, weights, z_tot)):
                torch.testing.assert_close(a, b, **TOL)
        xp, weights, z_tot, h_dims = operands(n_train)
        masks = cuda_mfn.make_dropout_masks(
            g, t, n_train, cuda_mfn.sizes(weights)[:4], mfn_drops(cfg))
        fwd = cuda_mfn.mfm_encode_res(xp, masks, weights, z_tot, h_dims)
        ref = cuda_mfn.mfm_encode_res_plain(xp, masks, weights, z_tot)
        for a, b in zip(fwd, ref):
            torch.testing.assert_close(a, b, **TOL)
        res = ref[2:]
        dh = torch.randn((n_train, sum(h_dims)), generator=g, device=cuda)
        dmem = torch.randn((n_train, cfg.memsize), generator=g, device=cuda)
        dxp, deltas = cuda_mfn._launch_bwd(xp, weights, *res, dh, dmem,
                                           z_tot, h_dims)
        dxp_ref, deltas_ref = cuda_mfn.mfm_encode_bwd_steps_plain(
            xp, weights, *res, dh, dmem, z_tot)
        torch.testing.assert_close(dxp, dxp_ref, **GRAD)
        torch.testing.assert_close(deltas, deltas_ref, **GRAD)
        dw = cuda_mfn._launch_dw(weights, res[1], res[2], res[3], deltas_ref,
                                 z_tot)
        for k, v in cuda_mfn.mfm_encode_dw_plain(
                res[1], res[2], res[3], deltas_ref, weights, z_tot).items():
            torch.testing.assert_close(dw[k], v, **GRAD)


@pytest.mark.parametrize("n", [32, 128])
def test_one_cell_multi_lstm_matches_plain(cuda, n):
    """``eflstm``'s and ``self_attention``'s recurrence: one 128-unit cell
    over the 325-float MOSI input, train forward and backward."""
    from factorized_tpu_torch.ops.fused import lstm_operands

    cell = {k: v.to(cuda) for k, v in baselines.eflstm_init(
        torch.Generator().manual_seed(15), 325, 128, 1)["lstm"].items()}
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((20, n, 325), generator=g, device=cuda)
    with torch.inference_mode():
        xp, wh, h_dims = lstm_operands([cell], [x])
        res = cuda_lstm.multi_lstm_fwd(xp, wh, h_dims, with_res=True)
        ref = cuda_lstm.multi_lstm_plain(xp, wh, with_res=True)
        for a, b in zip(res, ref):
            torch.testing.assert_close(a, b, **TOL)
        _, _, allc, gates = ref
        dh = torch.randn((n, 128), generator=g, device=cuda)
        torch.testing.assert_close(
            cuda_lstm.multi_lstm_bwd(gates, wh, allc, dh, h_dims),
            cuda_lstm.multi_lstm_bwd_plain(gates, wh, allc, dh), **GRAD)


@pytest.mark.parametrize("kind", ["eflstm", "self_attention", "mfn"])
def test_predictor_grads_on_the_card_match_the_cpu(cuda, kind):
    """One ``train_predictor`` step's loss and gradients at full width
    (``mfn``: ``best_mfn_mosi_config("acc")`` at n = 128; the others a
    128-unit LSTM at n = 32) on the card against the CPU, the same
    injected draws."""
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.config import best_mfn_mosi_config
    from factorized_tpu_torch.ops.losses import l1_loss

    cfg = (best_mfn_mosi_config("acc") if kind == "mfn"
           else best_acc_mosi_config())
    t, n, d = cfg.seqlength, (128 if kind == "mfn" else 32), cfg.d_total
    params, forward = trainers._predictor(kind, cfg, d, 128, t, 0.5, 17)
    g = torch.Generator().manual_seed(18)
    x = torch.randn((t, n, d), generator=g)
    y = torch.randn((n,), generator=g)
    draws = baselines.predictor_draws(kind, cfg, n, g, h=128, drop=0.5)
    losses, grads = [], []
    for dev in ("cpu", cuda):
        tree = {k: v.detach().to(dev).requires_grad_()
                for k, v in to_state_dict(params).items()}
        loss = l1_loss(forward(from_state_dict(tree), x.to(dev), True, None,
                               _to(draws, dev)), y.to(dev))
        loss.backward()
        losses.append(loss.detach().cpu())
        grads.append({k: v.grad.cpu() for k, v in tree.items()})
    torch.testing.assert_close(losses[1], losses[0], **TOL)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], **GRAD)


# ------------------------------------------------------------------ lanes

def _lane_operands(cfg, K, n, dev):
    """K lanes of the training kernels' inputs, lane k a model of its own
    seed over one shared batch, each operand with the lane dimension in
    front; and m_b's encoder trio's."""
    t = cfg.seqlength
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((t, n, cfg.d_total), generator=g, device=dev)
    enc, dec, multi = [], [], []
    with torch.inference_mode():
        for k in range(K):
            p = mfm.MFM(cfg, seed=10 + k, device=dev).tree()
            e, d = mfm.kernel_operands(p, x, cfg)
            enc.append(e)
            dec.append(d)
            pb = mfm.MFM(cfg, seed=20 + k, device=dev,
                         model_type="m_b").tree()
            multi.append(ablations.kernel_operands(pb, x, cfg,
                                                   "m_b")["multi_lstm"])

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items).contiguous()

    xp, w = stack([e[0] for e in enc]), stack([e[1] for e in enc])
    z_tot, h_dims = enc[0][2], enc[0][3]
    h0, c0, wsum, b = (stack([d[i] for d in dec]) for i in range(4))
    mxp, mwh = stack([m[0] for m in multi]), stack([m[1] for m in multi])
    w0 = {k: v[0] for k, v in w.items()}
    masks = stack([cuda_mfn.make_dropout_masks(
        g, t, n, cuda_mfn.sizes(w0)[:4], mfn_drops(cfg)) for _ in range(K)])
    return ((xp, masks, w, z_tot, h_dims), (h0, c0, wsum, b, dec[0][4]),
            (mxp, mwh, multi[0][2]), g)


@pytest.mark.parametrize("K", [1, 4, 12])
@pytest.mark.parametrize("cfg,n", [(SMALL, 5), (best_acc_mosi_config(), 32)],
                         ids=["small", "train"])
def test_lane_kernels_match_plain(cuda, cfg, n, K):
    """Each of the seven kernel entry points over K lanes, one launch a
    call, against its plain version lane by lane."""
    (xp, masks, w, z_tot, h_dims), (h0, c0, wsum, b, dec_dims), \
        (mxp, mwh, m_dims), g = _lane_operands(cfg, K, n, cuda)
    t = cfg.seqlength
    before = counts.snapshot()
    with torch.inference_mode():
        for got, want in zip(
                cuda_mfn.mfm_encode_lanes(xp, w, z_tot, h_dims),
                cuda_mfn.mfm_encode_lanes_plain(xp, w, z_tot)):
            torch.testing.assert_close(got, want, **TOL)
        fwd = cuda_mfn.mfm_encode_res_lanes(xp, masks, w, z_tot, h_dims)
        ref = cuda_mfn.mfm_encode_res_lanes_plain(xp, masks, w, z_tot)
        for got, want in zip(fwd, ref):
            torch.testing.assert_close(got, want, **TOL)
        res = ref[2:]
        H, mem = sum(h_dims), w["a2w2"].shape[-1]
        dh = torch.randn((K, n, H), generator=g, device=cuda)
        dmem = torch.randn((K, n, mem), generator=g, device=cuda)
        dxp, deltas = cuda_mfn._launch_bwd(xp, w, *res, dh, dmem, z_tot,
                                           h_dims, lanes=K)
        dw = cuda_mfn._launch_dw(w, res[1], res[2], res[3], deltas, z_tot,
                                 K)
        for k in range(K):
            wk = {m: v[k] for m, v in w.items()}
            rk = [r[k] for r in res]
            want_dxp, want_deltas = cuda_mfn.mfm_encode_bwd_steps_plain(
                xp[k], wk, *rk, dh[k], dmem[k], z_tot)
            torch.testing.assert_close(dxp[k], want_dxp, **GRAD)
            torch.testing.assert_close(deltas[k], want_deltas, **GRAD)
            want_dw = cuda_mfn.mfm_encode_dw_plain(rk[1], rk[2], rk[3],
                                                   deltas[k], wk, z_tot)
            for m in cuda_mfn.DW_NAMES:
                torch.testing.assert_close(dw[m][k], want_dw[m], **GRAD)
        dfwd = cuda_lstm.decoder_lstm_fwd_lanes(h0, c0, wsum, b, t, dec_dims)
        dref = cuda_lstm.decoder_lstm_lanes_plain(h0, c0, wsum, b, t)
        for got, want in zip(dfwd, dref):
            torch.testing.assert_close(got, want, **TOL)
        allh, allc, gates = dref
        dallh = torch.randn(allh.shape, generator=g, device=cuda)
        for got, want in zip(
                cuda_lstm.decoder_lstm_bwd_lanes(wsum, gates, allc, dallh,
                                                 dec_dims),
                cuda_lstm.decoder_lstm_bwd_lanes_plain(wsum, gates, allc,
                                                       dallh)):
            torch.testing.assert_close(got, want, **GRAD)
        mf = cuda_lstm.multi_lstm_fwd_lanes(mxp, mwh, m_dims, True)
        mref = cuda_lstm.multi_lstm_lanes_plain(mxp, mwh, True)
        for got, want in zip(mf, mref):
            torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(
            cuda_lstm.multi_lstm_fwd_lanes(mxp, mwh, m_dims),
            cuda_lstm.multi_lstm_lanes_plain(mxp, mwh), **TOL)
        dhl = torch.randn(mref[0].shape, generator=g, device=cuda)
        torch.testing.assert_close(
            cuda_lstm.multi_lstm_bwd_lanes(mref[3], mwh, mref[2], dhl,
                                           m_dims),
            cuda_lstm.multi_lstm_bwd_lanes_plain(mref[3], mwh, mref[2],
                                                 dhl), **GRAD)
        torch.cuda.synchronize()
    # every kernel one launch a call for any count of lanes
    delta = counts.since(before)
    assert delta[(cuda_mfn, "LAUNCHES")] == 2
    assert delta[(cuda_mfn, "BWD_LAUNCHES")] == 1
    assert delta[(cuda_mfn, "DW_LAUNCHES")] == 1
    assert delta[(cuda_lstm, "LAUNCHES")] == 1
    assert delta[(cuda_lstm, "BWD_LAUNCHES")] == 1
    assert delta[(cuda_lstm, "MULTI_LAUNCHES")] == 2
    assert delta[(cuda_lstm, "MULTI_BWD_LAUNCHES")] == 1


@pytest.mark.parametrize("K", [8, 32])
def test_the_lane_plan_takes_the_cards_occupancy(cuda, K):
    """The reverse pass's lane plan at the main widths counts its waves in
    what the card's occupancy calculator says an SM holds of each chain's
    instantiation (registers counted): a whole number of blocks an SM, no
    more than its threads and shared memory allow; the rows the fewest of
    those waves take, the smallest such count."""
    cfg = best_acc_mosi_config()
    h_dims = [cfg.zl_size, cfg.za_size, cfg.zv_size, *cfg.h_dims]
    s3, s4, mem, n = (cfg.gamma1_shape, cfg.gamma2_shape, cfg.memsize,
                      cfg.batchsize)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    asked = []

    def wave(chain, R, plan, smem):
        held = cuda_mfn.chain_wave(chain, R, plan, smem)
        assert held % sms == 0 and held > 0
        assert held // sms <= min(2048 // cuda_mfn.BWD_THREADS,
                                  233472 // (smem + 1024))
        asked.append((chain, R, held))
        return held

    plan = cuda_mfn.bwd_plan(h_dims, s3, s4, mem, n, K, wave)
    assert plan == cuda_mfn.bwd_plan(h_dims, s3, s4, mem, n, K)
    for chain, p in plan.items():
        mine = [(R, -(-K * -(-n // R) * (1 if chain == "memory_chain"
                                         else len(h_dims))
                      * max(p["plan"], 1) // held))
                for c, R, held in asked if c == chain]
        fewest = min(w for _, w in mine)
        assert p["waves"] == fewest
        assert p["rows"] == min(R for R, w in mine if w == fewest)


@pytest.mark.parametrize("K", [8, 32])
def test_the_forward_and_chain_lane_plans_take_the_cards_occupancy(cuda,
                                                                   K):
    """The encode forward's lane plans (train at n = 32, eval at 256), the
    chains' backward's (the decoders at n = 32, m_b's encoder cells) and
    forward's (the decoders at n = 32, m_b's encoder cells train at 32 and
    eval at 256) count their waves in what the card's occupancy calculator says an SM
    holds: a whole number of blocks an SM, and the plan the same as with
    the default query."""
    cfg = best_acc_mosi_config()
    h_dims = [cfg.zl_size, cfg.za_size, cfg.zv_size, *cfg.h_dims]
    s3, s4, mem = cfg.gamma1_shape, cfg.gamma2_shape, cfg.memsize
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count

    def checked(query):
        def wave(chain, R, plan, smem):
            held = query(chain, R, plan, smem)
            assert held % sms == 0 and held > 0
            return held
        return wave

    for train, n in ((True, 32), (False, 256)):
        plan = cuda_mfn.fwd_plan(h_dims, s3, s4, mem, n, K, train,
                                 checked(cuda_mfn.fwd_chain_wave))
        assert plan == cuda_mfn.fwd_plan(h_dims, s3, s4, mem, n, K, train)
    for decoder, dims in ((True, [104, 24, 24]), (False, [32, 8, 80])):
        plan = cuda_lstm.chain_bwd_plan(dims, 32, K, decoder,
                                        checked(cuda_lstm.lstm_bwd_wave))
        assert plan == cuda_lstm.chain_bwd_plan(dims, 32, K, decoder)
    for decoder, train, dims, n in ((True, True, [104, 24, 24], 32),
                                    (False, True, [32, 8, 80], 32),
                                    (False, False, [32, 8, 80], 256)):
        plan = cuda_lstm.chain_fwd_plan(dims, n, K, decoder, train,
                                        checked(cuda_lstm.lstm_fwd_wave))
        assert plan == cuda_lstm.chain_fwd_plan(dims, n, K, decoder, train)


def test_lane_train_step_grads_on_the_card_match_the_cpu(cuda):
    """One vmapped train step of 3 ``mfm`` lanes on the card (the lane
    kernels) against the CPU's, every draw injected, each lane its own:
    the encode's dropout masks, the MMD sample and the z->f masks."""
    from factorized_tpu_torch.models.common import zf_drops
    from factorized_tpu_torch.ops.core import dropout_mask
    from factorized_tpu_torch.parallel.multiseed import _dims, stack_lanes
    from torch.utils import _pytree as pytree

    K, n, t = 3, 5, SMALL.seqlength
    g = torch.Generator().manual_seed(6)
    x = torch.randn((t, n, SMALL.d_total), generator=g)
    y = torch.randn((n,), generator=g)
    stacked = stack_lanes([mfm.MFM(SMALL, seed=30 + k, device="cpu").tree()
                           for k in range(K)], "cpu")
    sizes = (SMALL.att1_shape, SMALL.att2_shape, SMALL.gamma1_shape,
             SMALL.gamma2_shape)
    f_dims = (SMALL.fy_size, SMALL.fl_size, SMALL.fa_size, SMALL.fv_size)
    draws = {
        "encode_masks": torch.stack([cuda_mfn.make_dropout_masks(
            g, t, n, sizes, mfn_drops(SMALL)) for _ in range(K)]),
        "mmd_noise": torch.randn((K, *mfm.mmd_noise_shape(SMALL, n)),
                                 generator=g),
        "zf_masks": [dropout_mask(g, (K, n, f), r) if r > 0 else None
                     for f, r in zip(f_dims, zf_drops(SMALL))]}
    loss_fn = make_loss_fn(mfm.mfm_apply, SMALL, "joint")
    grads = []
    for where in ("cpu", cuda):
        p = pytree.tree_map(lambda a: a.detach().to(where).requires_grad_(),
                            stacked)
        d = pytree.tree_map(lambda v: None if v is None else v.to(where),
                            draws)
        loss, _ = torch.func.vmap(
            lambda pp, xx, yy, dd: loss_fn(pp, xx, yy, draws=dd),
            in_dims=(0, None, None, _dims(d)))(p, x.to(where), y.to(where), d)
        loss.sum().backward()
        grads.append({k: v.grad.cpu() for k, v in to_state_dict(p).items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], **GRAD)
