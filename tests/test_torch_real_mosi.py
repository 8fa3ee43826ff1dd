"""The port's real CMU-MOSI reader against the JAX package's, on a
fabricated data root in the real files' layout (the port's
``data.mosi.fabricate_root``, the JAX package's
``tests/test_real_mosi_pipeline.py`` fixture): the six arrays of
``get_data`` equal bit for bit for feature selection 1 and 0, with and
without the covarep normalisation, and on the synthetic set; the word
windows' average equals ``factorized_tpu.native.segment_average`` bit for
bit (empty, NaN and -inf windows included)."""

import numpy as np
import pytest

from factorized_tpu import native
from factorized_tpu.data import mosi as jax_mosi
from factorized_tpu.data import synthetic as jax_synthetic
from factorized_tpu_torch.data import mosi, synthetic
from factorized_tpu_torch.data.segavg import segment_average


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return mosi.fabricate_root(str(tmp_path_factory.mktemp("mosi_root")))


def _same(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("fs", [1, 0])
def test_get_data_on_the_real_files_is_the_jax_packages(root, fs,
                                                        normalize):
    got = mosi.get_data(20, bool(fs), root, normalize)
    _same(got, jax_mosi.get_data(20, bool(fs), root, normalize))
    assert got[0].shape == (52, 20, 325 if fs else 377)
    assert got[2].shape[0] == 10 and got[4].shape[0] == 8
    assert np.isfinite(got[0]).all()


def test_get_data_cuts_and_pads_as_the_jax_package(root):
    """A seqlength below the longest segment (truncation keeping the last
    words) and one above it (left padding)."""
    for t in (3, 7):
        _same(mosi.get_data(t, True, root), jax_mosi.get_data(t, True, root))


def test_get_data_without_a_root_is_the_synthetic_set():
    _same(mosi.get_data(20, True, "/nonexistent/mosi"),
          jax_mosi.get_data(20, True, "/nonexistent/mosi"))
    _same(mosi.get_data(20, False), jax_mosi.get_data(20, False))


def test_input_dims_are_the_jax_packages():
    for fs in (True, False):
        assert mosi.input_dims(fs) == jax_mosi.input_dims(fs)


def test_pad_segments_pads_either_side_as_the_jax_package():
    segs = synthetic.synthetic_segments(5, seed=3, max_len=9)
    for side in ("left", "right"):
        got = synthetic.pad_segments(segs, 6, side=side)
        want = jax_synthetic.pad_segments(segs, 6, side=side)
        for k in ("facet", "covarep", "text", "lengths", "label"):
            np.testing.assert_array_equal(got[k], want[k])


WINDOWS = {
    "plain": ([0, 3, 10], [3, 9, 30]),
    "empty": ([4, 7, 50, -5], [4, 2, 60, -1]),
    "clipped": ([-3, 35], [2, 80]),
    "nan_and_neginf": ([0, 1, 2, 5], [2, 3, 6, 8]),
    "long": ([0], [40]),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_segment_average_is_the_native_kernels(case):
    """Frames with a NaN, a -inf and a +inf: only the windows whose mean
    they reach are touched (NaN and -inf zeroed, +inf kept)."""
    rng = np.random.default_rng(len(case))
    feats = rng.normal(size=(40, 7)) * 10
    feats[1, 2] = np.nan
    feats[2, 4] = -np.inf
    feats[6, 5] = np.inf
    starts, ends = (np.array(v) for v in WINDOWS[case])
    got = segment_average(feats, starts, ends)
    want = native.segment_average(feats, starts, ends)
    assert got.dtype == np.float32 and got.shape == (len(starts), 7)
    np.testing.assert_array_equal(got, want)
    empty = np.minimum(ends, 40) <= np.maximum(starts, 0)
    assert (got[empty] == 0).all()
    assert not np.isnan(got).any() and not np.isneginf(got).any()


def _scores(printed):
    """The score lines of a ``test_mosi`` printout, ``name: value``."""
    out = {}
    for line in printed.splitlines():
        name, sep, value = line.partition(": ")
        if sep and name in ("mae", "corr", "mult_acc", "mult_f_score",
                            "binary_accuracy", "binary_f1"):
            out[name] = float(value)
    return out


@pytest.mark.parametrize("flags", [[], ["--normalize-covarep"],
                                   ["--feature-selection", "0"]],
                         ids=["fs", "norm", "raw"])
def test_test_mosi_scores_the_files_under_data_root_as_jax(root, flags,
                                                           tmp_path, capsys,
                                                           monkeypatch):
    """``test_mosi --data-root R`` scores a checkpoint on R's test set,
    read with ``--feature-selection`` and ``--normalize-covarep``: its
    printout is the JAX package's metrics of the checkpoint's predictions
    on the JAX reader's test set of R, line for line, and the JAX
    command's scores of the same parameters are within 1e-6. The
    correlation is held by the first check alone: the untrained head's
    predictions spread by about 1e-4 over the 8 test segments, so the two
    packages' correlations part by 1e-5 where the predictions part by
    1e-8."""
    import io

    import jax

    from factorized_tpu import cli as jax_cli
    from factorized_tpu import serve as jax_serve
    from factorized_tpu.config import MFMConfig as JaxConfig
    from factorized_tpu.models import get_model as jax_get_model
    from factorized_tpu.utils import metrics as jmetrics
    from factorized_tpu.utils.checkpoint import \
        save_checkpoint as jax_save
    from factorized_tpu_torch import cli
    from factorized_tpu_torch.convert import from_numpy
    from factorized_tpu_torch.serve import Predictor
    from factorized_tpu_torch.utils.checkpoint import save_checkpoint

    # the latency probes that follow the score time many batch sizes (JAX
    # compiles each); they weigh on no score
    for cls in (jax_serve.Predictor, Predictor):
        monkeypatch.setattr(cls, "probe", lambda self, X: {})
        monkeypatch.setattr(cls, "device_latency", lambda self, X: {})
    fs = "--feature-selection" not in flags
    cfg = JaxConfig(input_dims=list(mosi.input_dims(fs)), h_dims=[6, 5, 4],
                    memsize=6, zy_size=5, zl_size=6, za_size=4, zv_size=5,
                    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
                    att1_shape=8, att2_shape=8, gamma1_shape=8,
                    gamma2_shape=8)
    params = jax.tree.map(np.asarray, jax_get_model("mfm")[0](
        jax.random.PRNGKey(3), cfg))
    jax_save(str(tmp_path / "jax"), params, config=cfg.to_dict())
    ckpt = str(tmp_path / "port")
    save_checkpoint(ckpt, from_numpy(params), config=cfg.to_dict())
    args = ["--data-root", root, *flags]
    assert cli.main(["test_mosi", "--checkpoint", ckpt, "--device", "cpu",
                     *args]) == 0
    printed = capsys.readouterr().out
    _, _, _, _, X_test, y_test = jax_mosi.get_data(
        20, fs, root, "--normalize-covarep" in flags)
    want = io.StringIO()
    jmetrics.score_regression(Predictor.from_checkpoint(
        ckpt, device="cpu").predict(X_test), y_test, out=want)
    assert want.getvalue() in printed
    got = _scores(printed)
    assert jax_cli.main(["test_mosi", "--checkpoint", str(tmp_path / "jax"),
                         *args]) == 0
    jax_scores = _scores(capsys.readouterr().out)
    assert set(got) == set(jax_scores) and "mae" in got
    for k, v in jax_scores.items():
        if k != "corr":
            np.testing.assert_allclose(got[k], v, err_msg=k, rtol=0.0,
                                       atol=1e-6)
    # the synthetic set (no --data-root) scores apart
    assert cli.main(["test_mosi", "--checkpoint", ckpt, "--device", "cpu",
                     *flags]) == 0
    assert _scores(capsys.readouterr().out) != got


def test_test_mosi_parses_the_data_flags():
    from factorized_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["test_mosi", "--checkpoint", "ck", "--data-root", "/data/mosi",
         "--feature-selection", "0", "--normalize-covarep", "--device",
         "cpu"])
    assert (args.data_root, args.feature_selection, args.normalize_covarep,
            args.device) == ("/data/mosi", 0, True, "cpu")
    args = cli.build_parser().parse_args(["test_mosi", "--checkpoint", "ck"])
    assert (args.data_root, args.feature_selection,
            args.normalize_covarep) == (None, 1, False)
