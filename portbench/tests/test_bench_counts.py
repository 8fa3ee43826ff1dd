"""The frozen counts: the model FLOPs equal the port's closed form
(``utils/flops.py``) for both configurations at the cells' shapes; each
kernel family's FLOPs and bytes follow from the configuration and the
shapes alone. Of PERF.md section 6's bounds they reproduce the encode
forward's (train at n = 32, eval at n = 256) and the decoders' forward
(n = 32 and 256) to the digit; the reverse pass's and the weight gradients' figures there
count work beyond the products counted here (0.008814 and 0.005694 ms
against 0.007244 and 0.005673 ms)."""

import json

import pytest

from tiny import ROOT

from portbench.counts import kernels, model_flops

PEAKS = {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", ["mfm_mosi", "m_b_mosi"])
def test_model_flops_equal_the_ports(name):
    from factorized_tpu_torch.config import MFMConfig
    from factorized_tpu_torch.utils.flops import model_train_flops_per_step

    config = _config(name)
    cfg = MFMConfig.from_dict(config)
    assert model_flops.train_step_flops(config) == model_train_flops_per_step(
        cfg, config["model_type"], "joint", fused=False)


def test_the_bounds_of_perf_section_6():
    cfg = _config("mfm_mosi")

    def ms(work):
        return 1e3 * kernels.least_seconds(*work, PEAKS)

    assert ms(kernels.encode_fwd(cfg, 32, True)) == pytest.approx(
        0.007243684298507463, rel=1e-12)
    assert ms(kernels.decoder_fwd(cfg, 32)) == pytest.approx(
        0.0008688410746268656, rel=1e-12)
    assert ms(kernels.decoder_fwd(cfg, 256)) == pytest.approx(
        0.006950728597014925, rel=1e-12)
    assert ms(kernels.encode_fwd(cfg, 256, False)) == pytest.approx(
        0.0579494743880597, rel=1e-12)


@pytest.mark.parametrize("fn", ["encode_bwd", "encode_dw", "decoder_fwd",
                                "decoder_bwd", "multi_fwd", "multi_bwd"])
def test_a_family_count_follows_its_shapes(fn):
    cfg = _config("mfm_mosi")
    count = getattr(kernels, fn)
    f32, b32 = count(cfg, 32)
    f64, b64 = count(cfg, 64)
    assert f64 == 2 * f32 and f32 > 0
    assert b32 < b64 <= 2 * b32
    assert count(dict(cfg, seqlength=40), 32)[0] > f32
    # nothing but the shapes: the optimizer's settings change nothing
    assert count(dict(cfg, lr=1.0, num_epochs=1), 32) == (f32, b32)


def test_calls_scale_with_lanes_and_skip_absent_families():
    cfg, mb = _config("mfm_mosi"), _config("m_b_mosi")
    kw = dict(steps=40, epochs=1, trials=1, batch=32, n_valid=229,
              n_test=686)
    one = kernels.family_calls(cfg, "encode", lanes=1, **kw)
    many = kernels.family_calls(cfg, "encode", lanes=32, **kw)
    assert [(f * 32, b * 32) for (f, b), _ in one] == [w for w, _ in many]
    assert kernels.family_calls(mb, "encode", lanes=1, **kw) == []
    assert len(kernels.family_calls(mb, "chains", lanes=1, **kw)) == 7
