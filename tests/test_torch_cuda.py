"""The port's CUDA kernels on the card: each against its plain version,
the launch counts, and the card's Predictor against the CPU's. Every test
here is marked ``gpu`` and skips without a CUDA card. Run on the card:
``python -m pytest tests/test_torch_cuda.py -m gpu``.

Float32 with TF32 off; tolerance rtol 1e-4 / atol 1e-5, since the
kernels sum in another order than cuBLAS."""

import numpy as np
import pytest
import torch

from factorized_tpu_torch.config import MFMConfig, best_acc_mosi_config
from factorized_tpu_torch.models import mfm
from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn
from factorized_tpu_torch.serve import Predictor

TOL = dict(rtol=1e-4, atol=1e-5)

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
    # 300 rows = two padded chunks of 256: one launch of each per chunk
    assert (cuda_mfn.LAUNCHES - before[0],
            cuda_lstm.LAUNCHES - before[1]) == (2, 2)
    y_cpu = Predictor(cfg, params, device="cpu").predict(X)
    np.testing.assert_allclose(y, y_cpu, **TOL)
