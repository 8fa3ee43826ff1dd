"""The port's CMU-MultimodalSDK reader (``factorized_tpu_torch/data/
mmsdk.py``) against the JAX package's on the same fabricated ``.csd``
files (written with h5py as ``tests/test_mmsdk.py`` writes them), and the
commands that read it through the port's CLI.

- The six arrays equal the JAX reader's bit for bit and ``input_dims``
  are the same, for MOSI, MOSEI (scalar and vector labels) and POM; the
  default (proportional), MOSI-sized (52/10/31) and explicit splits;
  ``normalize_covarep``; a segment missing a modality, zeros.
- The cache: a hit reads no file, a changed file rebuilds it, ``cache=
  False`` writes none, and the JAX reader reads the port's entry.
- The errors, with the JAX reader's words where it has them, and a
  missing h5py (the module hidden) named as such.
- ``mosi_sdk``, ``mosei_sdk``, ``multitrait --style mosei_sdk|pom_sdk``
  (then ``check --multitrait``), ``predictor --dataset mosi_sdk`` and
  ``--split`` end to end on the CPU: one epoch at a tiny config.

The arrays are compared exactly: both readers are the same numpy."""

import json
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from factorized_tpu.data import mmsdk as jax_mmsdk  # noqa: E402
from factorized_tpu_torch import cli  # noqa: E402
from factorized_tpu_torch.data import mmsdk  # noqa: E402
from factorized_tpu_torch.data.multitrait import POM_TRAITS  # noqa: E402

TINY = {"seqlength": 5, "h_dims": [4, 4, 4], "memsize": 4, "zy_size": 4,
        "zl_size": 4, "za_size": 4, "zv_size": 4, "fy_size": 4,
        "fl_size": 4, "fa_size": 4, "fv_size": 4, "att1_shape": 4,
        "att2_shape": 4, "gamma1_shape": 4, "gamma2_shape": 4,
        "batchsize": 2, "num_epochs": 1}


def write_csd(path, root, segments):
    """segments: {seg_id: (features, intervals)}"""
    with h5py.File(path, "w") as f:
        data = f.create_group(root).create_group("data")
        for seg_id, (feats, ivs) in segments.items():
            g = data.create_group(seg_id)
            g.create_dataset("features", data=np.asarray(feats, np.float32))
            g.create_dataset("intervals", data=np.asarray(ivs, np.float64))


def make_root(tmp_path, files=mmsdk.DEFAULT_FILES, n_videos=4, segs=2,
              words=3, dims=(6, 4, 3), traits=1, long_segment=None, seed=0):
    """A .csd quartet under ``tmp_path/<text file's stem>``: audio at 10
    rows a second, visual at 5 with NaN and inf among them, word i over
    [i, i + 1) seconds, ``traits`` label columns."""
    rng = np.random.default_rng(seed)
    text, audio, visual, labels = {}, {}, {}, {}
    for v in range(n_videos):
        for s in range(segs):
            seg_id = f"vid{v:02d}[{s}]"
            n = long_segment if (long_segment and v == s == 0) else words
            w_iv = np.stack([np.arange(n), np.arange(n) + 1.0], axis=1)
            text[seg_id] = (rng.normal(size=(n, dims[0])), w_iv)
            a_iv = np.arange(10 * n)[:, None] / 10.0 + [0.0, 0.1]
            audio[seg_id] = (rng.normal(size=(10 * n, dims[1])), a_iv)
            vis = rng.normal(size=(5 * n, dims[2]))
            vis[0, 0], vis[-1, -1] = np.nan, np.inf
            visual[seg_id] = (vis, np.arange(5 * n)[:, None] / 5.0
                              + [0.0, 0.2])
            labels[seg_id] = (rng.normal(size=(1, traits)) * 2.0,
                              np.array([[0.0, n * 1.0]]))
    root = tmp_path / files["text"].split(".")[0]
    root.mkdir(exist_ok=True)
    for kind, segs_of in (("text", text), ("audio", audio),
                          ("visual", visual), ("labels", labels)):
        write_csd(root / files[kind], kind, segs_of)
    return str(root)


def assert_same(port, jax):
    assert port.input_dims == jax.input_dims
    assert len(port) == len(jax) == 6
    for got, want in zip(port, jax):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# name -> (fixture keywords, get_data keywords)
SETS = {
    "mosi": (dict(long_segment=9), dict(split=(2, 1))),
    "mosei_scalar": (dict(files=mmsdk.MOSEI_FILES, traits=7, words=4),
                     dict(files=mmsdk.MOSEI_FILES)),
    "mosei_vector": (dict(files=mmsdk.MOSEI_FILES, traits=7, words=4),
                     dict(files=mmsdk.MOSEI_FILES, label_mode="vector")),
    "pom": (dict(files=mmsdk.POM_FILES, traits=17, n_videos=5, segs=1),
            dict(files=mmsdk.POM_FILES, label_mode="vector", split=(2, 1))),
}


@pytest.mark.parametrize("name", list(SETS))
def test_arrays_equal_the_jax_reader(name, tmp_path):
    fixture, kw = SETS[name]
    root = make_root(tmp_path, **fixture)
    port = mmsdk.get_data(seqlength=5, data_root=root, cache=False, **kw)
    assert_same(port, jax_mmsdk.get_data(seqlength=5, data_root=root,
                                         cache=False, **kw))
    traits = fixture.get("traits", 1)
    if kw.get("label_mode") == "vector":
        assert port[1].shape[1:] == (traits,)
    else:
        assert port[1].ndim == 1
    assert port[0].shape[1:] == (5, 13) and port.input_dims == [6, 4, 3]
    assert np.isfinite(port[0]).all() and np.abs(port[0][..., 10:]).max() <= 1


# fixture keywords, split, the rows of each part
SPLITS = {"default": (dict(n_videos=4, segs=1), None, (2, 1, 1)),
          "mosi_sized": (dict(n_videos=93, segs=1, words=2), None,
                         (52, 10, 31)),
          "explicit": (dict(n_videos=6, segs=2), (3, 2), (6, 4, 2))}


@pytest.mark.parametrize("name", list(SPLITS))
def test_splits(name, tmp_path):
    fixture, split, rows = SPLITS[name]
    root = make_root(tmp_path, **fixture)
    port = mmsdk.get_data(seqlength=3, data_root=root, split=split,
                          cache=False)
    assert tuple(port[i].shape[0] for i in (0, 2, 4)) == rows
    assert_same(port, jax_mmsdk.get_data(seqlength=3, data_root=root,
                                         split=split, cache=False))


def test_normalize_covarep(tmp_path):
    root = make_root(tmp_path)
    port = mmsdk.get_data(seqlength=5, data_root=root, split=(2, 1),
                          normalize_covarep=True, cache=False)
    assert np.abs(port[0][..., 6:10]).max() <= 1.0
    assert_same(port, jax_mmsdk.get_data(seqlength=5, data_root=root,
                                         split=(2, 1), normalize_covarep=True,
                                         cache=False))


def test_missing_modality_is_zeros(tmp_path):
    root = make_root(tmp_path)
    with h5py.File(f"{root}/{mmsdk.DEFAULT_FILES['audio']}", "a") as f:
        del f["audio"]["data"]["vid00[0]"]
    port = mmsdk.get_data(seqlength=5, data_root=root, split=(2, 1),
                          cache=False)
    np.testing.assert_array_equal(port[0][0, :, 6:10], 0.0)
    assert_same(port, jax_mmsdk.get_data(seqlength=5, data_root=root,
                                         split=(2, 1), cache=False))


def test_cache_hit_rebuild_and_bypass(tmp_path, monkeypatch):
    root = make_root(tmp_path)
    cache = tmp_path / root.split("/")[-1] / ".factorized_cache"
    mmsdk.get_data(seqlength=5, data_root=root, split=(2, 1), cache=False)
    assert not cache.exists()
    first = mmsdk.get_data(seqlength=5, data_root=root, split=(2, 1))
    assert len(list(cache.iterdir())) == 1
    read = mmsdk.read_csd

    def no_read(path):
        raise AssertionError("a cache hit read a file")

    # a hit; the JAX reader finds the port's entry under the same key
    for reader in (mmsdk, jax_mmsdk):
        monkeypatch.setattr(reader, "read_csd", no_read)
        assert_same(reader.get_data(seqlength=5, data_root=root,
                                    split=(2, 1)), first)
    monkeypatch.setattr(mmsdk, "read_csd", read)
    labels = f"{root}/{mmsdk.DEFAULT_FILES['labels']}"
    with h5py.File(labels, "a") as f:
        for seg in f["labels"]["data"].values():
            seg["features"][...] += 1.0
    import os

    os.utime(labels, ns=(1, 10**18))
    rebuilt = mmsdk.get_data(seqlength=5, data_root=root, split=(2, 1))
    np.testing.assert_allclose(rebuilt[1], first[1] + 1.0, atol=1e-6)
    assert len(list(cache.iterdir())) == 2


def _two_roots(root):
    with h5py.File(f"{root}/{mmsdk.DEFAULT_FILES['text']}", "a") as f:
        f.create_group("extraneous_root").create_group("data")


def _empty(root):
    with h5py.File(f"{root}/{mmsdk.DEFAULT_FILES['audio']}", "w"):
        pass


def _no_h5py(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)


# how the fixture is broken, the error, its words (the JAX reader's but
# for h5py's)
ERRORS = {
    "no_root": (None, FileNotFoundError, "needs --data-root"),
    "missing_file": ("audio", FileNotFoundError, "missing audio csd"),
    "two_roots": (_two_roots, ValueError, "root groups"),
    "empty_csd": (_empty, ValueError, "empty csd"),
    "split_too_large": ((52, 10), ValueError, "split"),
    "no_h5py": (_no_h5py, ImportError,
                r"reads \.csd \(HDF5\) files through h5py, which is not "
                "installed"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors(name, tmp_path, monkeypatch):
    how, error, words = ERRORS[name]
    root = make_root(tmp_path)
    split = (2, 1)
    if how is None:
        root = str(tmp_path / "absent")
    elif how == "audio":
        (tmp_path / root.split("/")[-1]
         / mmsdk.DEFAULT_FILES["audio"]).unlink()
    elif isinstance(how, tuple):
        split = how
    elif how is _no_h5py:
        how(root, monkeypatch)
    else:
        how(root)
    for reader in (mmsdk, jax_mmsdk) if name != "no_h5py" else (mmsdk,):
        with pytest.raises(error, match=words):
            reader.get_data(seqlength=5, data_root=root, split=split,
                            cache=False)


# ------------------------------------------------------------ the commands

def _config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def _records(out):
    return [json.loads(line) for p in sorted(out.glob("*.jsonl"))
            for line in p.read_text().splitlines()]


# argv (after the data root and the config), fixture keywords, what the
# run's config records must hold
COMMANDS = {
    "mosi_sdk": (["mosi_sdk", "--mode", "single"], dict(n_videos=5), {}),
    "mosei_sdk": (["mosei_sdk"], dict(files=mmsdk.MOSEI_FILES, traits=7),
                  {}),
    "multitrait_mosei_sdk": (["multitrait", "--style", "mosei_sdk"],
                             dict(files=mmsdk.MOSEI_FILES, traits=7),
                             {"traits": mmsdk.MOSEI_TRAITS}),
    "multitrait_pom_sdk": (["multitrait", "--style", "pom_sdk"],
                           dict(files=mmsdk.POM_FILES, traits=17, segs=1,
                                n_videos=6),
                           {"traits": POM_TRAITS}),
    "predictor_mosi_sdk": (["predictor", "--dataset", "mosi_sdk", "--kind",
                            "eflstm", "--hidden", "8"], dict(n_videos=5),
                           {"predictor_kind": "eflstm"}),
    "split": (["mosi_sdk", "--split", "3,1"], dict(n_videos=5), {}),
}


@pytest.mark.parametrize("name", list(COMMANDS))
def test_command_trains_one_epoch(name, tmp_path, capsys):
    argv, fixture, record = COMMANDS[name]
    root = make_root(tmp_path, **fixture)
    out = tmp_path / "runs"
    assert cli.main(argv + ["--data-root", root, "--config",
                            _config(tmp_path), "--epochs", "1",
                            "--batchsize", "2", "--device", "cpu", "--out",
                            str(out)]) == 0
    records = _records(out)
    config = next(r for r in records if r["kind"] == "config")
    assert config["input_dims"] == [6, 4, 3]
    for key, value in record.items():
        assert config[key] == value
    epochs = [r for r in records if r["kind"] == "epoch"]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train_loss"])
    if name == "split":
        # the command read the files with --split's video counts
        paths = {k: f"{root}/{v}" for k, v in mmsdk.DEFAULT_FILES.items()}
        for split, made in (((3, 1), True), (None, False)):
            entry = mmsdk._cache_path(root, paths, 5, "scalar", split, False)
            assert (tmp_path / entry).exists() == made
    if name == "multitrait_mosei_sdk":
        capsys.readouterr()
        assert cli.main(["check", "--dir", str(out), "--multitrait"]) == 0
        from factorized_tpu_torch.check import best_multitrait

        assert len(best_multitrait(str(out), out=lambda *a: None)["mae"]) == 7
