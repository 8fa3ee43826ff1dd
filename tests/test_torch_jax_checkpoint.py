"""The JAX package's checkpoints read by the port, on the CPU.

``factorized_tpu_torch.utils.checkpoint.restore_checkpoint`` reads the
directories the JAX package's ``save_checkpoint`` writes, with its own
readers (``utils/zstd.py``, ``ocdbt.py``, ``zarr.py``, ``orbax.py``,
``msgpack.py``) and no Orbax, tensorstore, zstd or msgpack package.
Held here against those packages:

- a small ``mfm`` tree saved by the JAX package as Orbax and as msgpack,
  with and without a flatten-Adam state, and with a flatten-trace (SGD)
  state: every leaf bit for bit the JAX restore's, under the same keys;
  the moments laid out again in the port's order by a ``FlatAdam`` /
  ``FlatSGD`` over the port's tree (``laid_out``) equal JAX's unravelled
  moments leaf by leaf;
- both released stores ``best/mfn_mae`` and ``best/mfn_acc``, each read
  once for the module: equal to ``factorized_tpu_torch/released/`` (the
  committed conversion) and to the JAX restore;
- the OCDBT reader against tensorstore's key-value store (a B+tree of
  three levels, many versions), the zarr reader against tensorstore's
  zarr driver (big-endian, F order, edge chunks, a missing chunk, 0-d),
  the msgpack reader against flax's (chunked arrays, every leaf type);
- a bad crc32c, an unknown format, ``use_zarr3``, ``use_ocdbt`` false and
  a dictionary id each raise ``ValueError`` naming what;
- ``test_mosi --checkpoint best/mfn_mae --device cpu`` scores as the
  release (MAE 0.6101879, binary accuracy 0.8250729).
"""

import json
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.models import get_model as jax_get_model
from factorized_tpu.utils.checkpoint import (
    restore_checkpoint as jax_restore, save_checkpoint as jax_save)
from factorized_tpu_torch import train
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import to_state_dict
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.utils import msgpack, ocdbt, zarr
from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("mfn_mae", "mfn_acc")
CFG = JaxConfig(
    seqlength=5, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _flat(tree):
    """Nested dicts (and lists) of arrays as ``{path: numpy array}``."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else str(k): v for k, sub in tree.items()
                for p, v in _flat(sub).items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return _flat({str(i): v for i, v in enumerate(tree)})
    if hasattr(tree, "_fields"):
        return _flat(tree._asdict())
    return {"": np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                           else tree)}


def _same_leaves(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _params(seed=0):
    return jax.tree.map(np.asarray, jax_get_model("mfm")[0](
        jax.random.PRNGKey(seed), CFG))


def _moved(opt_state, params, seed):
    """An optimizer state with values in every slot: one update of a
    random gradient."""
    grads = jax.tree.map(lambda p: np.random.default_rng(seed).normal(
        size=p.shape).astype(np.float32), params)
    opt = optax.flatten(optax.scale_by_adam(eps=1e-8)) if hasattr(
        opt_state, "mu") else optax.flatten(optax.trace(decay=0.9))
    _, state = opt.update(grads, opt_state, params)
    _, state = opt.update(grads, state, params)
    return state


@pytest.mark.parametrize("opt", ["none", "adam", "sgd"])
@pytest.mark.parametrize("use_orbax", [True, False], ids=["orbax", "msgpack"])
def test_a_jax_checkpoint_restores_as_the_jax_restore(tmp_path, use_orbax,
                                                      opt):
    params = _params()
    meta_cfg = dict(CFG.to_dict(), _resume_lr=0.00125)
    opt_state = None
    if opt != "none":
        init = (optax.flatten(optax.scale_by_adam(eps=1e-8)) if opt == "adam"
                else optax.flatten(optax.trace(decay=0.9))).init(params)
        opt_state = jax.tree.map(np.asarray, _moved(init, params, 1))
    path = str(tmp_path / "ck")
    jax_save(path, params, opt_state=opt_state, step=7, config=meta_cfg,
             use_orbax=use_orbax)
    target = {"params": params}
    if opt_state is not None:
        target["opt_state"] = opt_state
    want, want_meta = jax_restore(path, target=target)
    got, meta = restore_checkpoint(path)
    assert meta == want_meta
    assert meta["format"] == ("orbax" if use_orbax else "msgpack")
    _same_leaves(got["params"], want["params"])
    # the JAX tree's keys, sorted at every level as ravel_pytree takes them
    keys = list(to_state_dict(got["params"]))
    assert keys == sorted(keys, key=lambda k: k.split("."))
    if opt_state is None:
        assert "opt_state" not in got
        return
    assert got["opt_state"]["lr"] == 0.00125
    _same_leaves(got["opt_state"]["state"], want["opt_state"])
    # laid out again over the port's tree, each slot's leaves are JAX's
    # unravelled slot's
    tree = get_model("mfm")[0](torch.Generator().manual_seed(0),
                               MFMConfig.from_dict(CFG.to_dict()))
    port_opt = (train.FlatAdam(tree, 1e-3) if opt == "adam"
                else train.FlatSGD(tree, 1e-3))
    port_opt.load_state_dict(got["opt_state"], params=got["params"])
    unravel = ravel_pytree(params)[1]
    for name in port_opt.slots:
        _same_leaves(port_opt.tree_of(getattr(port_opt, name)),
                     unravel(getattr(opt_state, name)))
    _same_leaves(port_opt.tree_of(port_opt.flat), params)
    assert float(port_opt.lr) == np.float32(0.00125)
    if opt == "adam":
        assert int(port_opt.count) == int(opt_state.count) == 2


@pytest.fixture(scope="module")
def released_reads():
    """Each ``best/`` store read once: (the port's state and meta, the
    committed conversion's, the JAX restore's)."""
    out = {}
    for name in NAMES:
        out[name] = (restore_checkpoint(os.path.join(ROOT, "best", name)),
                     restore_checkpoint(os.path.join(
                         ROOT, "factorized_tpu_torch", "released", name)),
                     jax_restore(os.path.join(ROOT, "best", name)))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_the_released_stores_are_the_committed_conversion(name,
                                                          released_reads):
    (got, meta), (kept, kept_meta), (want, want_meta) = released_reads[name]
    assert meta == want_meta and meta["format"] == "orbax"
    assert (meta["step"], meta["config"]) == (kept_meta["step"],
                                              kept_meta["config"])
    assert len(to_state_dict(got["params"])) == 77
    assert sorted(got) == ["params"]
    _same_leaves(got["params"], kept["params"])
    _same_leaves(got["params"], jax.tree.map(np.asarray, want["params"]))


def _copy_store(tmp_path):
    dst = tmp_path / "mfn_mae"
    shutil.copytree(os.path.join(ROOT, "best", "mfn_mae"), dst)
    return dst


def test_a_bad_crc32c_raises(tmp_path):
    dst = _copy_store(tmp_path)
    manifest = dst / "state" / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 0x01
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c mismatch"):
        restore_checkpoint(str(dst))


def test_an_unknown_format_raises(tmp_path):
    dst = _copy_store(tmp_path)
    meta = json.loads((dst / "meta.json").read_text())
    (dst / "meta.json").write_text(json.dumps(dict(meta, format="pickle")))
    with pytest.raises(ValueError, match="format 'pickle'"):
        restore_checkpoint(str(dst))


@pytest.mark.parametrize("setting", ["use_zarr3", "use_ocdbt"])
def test_another_orbax_layout_raises_naming_the_setting(tmp_path, setting):
    dst = _copy_store(tmp_path)
    path = dst / "state" / "_METADATA"
    meta = json.loads(path.read_text())
    meta[setting] = not meta[setting]
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=setting):
        restore_checkpoint(str(dst))


def test_an_unknown_optimizer_state_raises(tmp_path):
    params = _params()
    path = str(tmp_path / "ck")
    jax_save(path, params, opt_state={"velocity": np.zeros(3, np.float32)},
             config=CFG.to_dict(), use_orbax=False)
    with pytest.raises(ValueError, match="velocity"):
        restore_checkpoint(path)


def test_a_chunk_compressed_with_a_dictionary_raises():
    zstandard = pytest.importorskip("zstandard")
    frame = bytearray(zstandard.ZstdCompressor().compress(bytes(16)))
    single = frame[4] & 0x20
    frame[4] |= 1
    frame[6 - bool(single):6 - bool(single)] = b"\x05"
    store = {"a/.zarray": json.dumps({
        "zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<f4",
        "compressor": {"id": "zstd", "level": 1}, "fill_value": None,
        "order": "C", "filters": None}).encode(), "a/0": bytes(frame)}
    with pytest.raises(ValueError, match="dictionary 5"):
        zarr.read_array(store, "a")


def test_the_ocdbt_reader_is_tensorstores(tmp_path):
    """A B+tree of three levels (small nodes), values inline and in data
    files, written in many commits (older versions in the version tree's
    interior nodes)."""
    ts = pytest.importorskip("tensorstore")
    base = f"file://{tmp_path}/kv/"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base, "config": {
        "max_decoded_node_bytes": 600, "max_inline_value_bytes": 8,
        "version_tree_arity_log2": 1}}).result()
    rng = np.random.default_rng(0)
    values = {f"key/{i:05d}/x": rng.bytes(int(rng.integers(0, 40)))
              for i in range(300)}
    items = list(values.items())
    for start in range(0, len(items), 60):
        with ts.Transaction() as txn:
            for k, v in items[start:start + 60]:
                kv.with_transaction(txn)[k] = v
    assert ts.ocdbt.dump(ts.KvStore.open(base).result()).result()[
        "version_tree_nodes"]
    store = ocdbt.read(str(tmp_path / "kv"))
    assert sorted(store) == sorted(values)
    for k, v in values.items():
        assert store[k] == v, k


@pytest.mark.parametrize("dtype,order,shape,chunks", [
    (">i4", "C", (7, 5), (3, 2)),
    ("<f8", "F", (6, 9), (4, 4)),
    ("<f4", "C", (), ()),
    ("|b1", "C", (10,), (3,)),
    ("<u2", "F", (2, 3, 4), (2, 2, 3)),
])
def test_the_zarr_reader_is_tensorstores(tmp_path, dtype, order, shape,
                                         chunks):
    """Arrays written by tensorstore's zarr driver into an OCDBT store:
    either byte order, C and F order, edge chunks, 0-d; one chunk left
    unwritten reads as the fill value."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(1)
    data = (rng.integers(0, 2, shape).astype(dtype) if dtype == "|b1"
            else (100 * rng.normal(size=shape)).astype(dtype))
    fill = None if dtype == "|b1" else 3
    spec = {"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{tmp_path}/z/"}, "path": "arr",
        "metadata": {"dtype": dtype, "order": order, "shape": list(shape),
                     "chunks": list(chunks), "fill_value": fill,
                     "compressor": {"id": "zstd", "level": 3}},
        "create": True}
    arr = ts.open(spec).result()
    want = data.copy()
    if shape:
        # leave the last chunk unwritten: it reads as the fill value
        head = tuple(slice(0, max(s - c, 0) or s) for s, c in
                     zip(shape, chunks))
        arr[head] = data[head]
        want = np.full(shape, fill or 0, data.dtype)
        want[head] = data[head]
    else:
        arr[...] = data
    store = ocdbt.read(str(tmp_path / "z"))
    got = zarr.read_array(store, "arr")
    assert got.dtype == np.dtype(dtype).newbyteorder("=")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(arr.read().result(), want)


def test_the_msgpack_reader_is_flaxs(monkeypatch):
    """Every leaf type flax writes, arrays chunked past a small chunk
    size, and the plain msgpack types."""
    serialization = pytest.importorskip("flax.serialization")
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    state = {"a": np.arange(50, dtype=np.float32).reshape(5, 10),
             "b": np.float64(2.5), "c": 1 + 2j,
             "d": (np.ones(3, np.int16), [np.int8(-3), None]),
             "e": {"x": 7, "y": -2 ** 40, "z": "text", "w": b"raw",
                   "v": True, "u": 0.25, "t": np.zeros((2, 0))}}
    raw = serialization.to_bytes(state)
    got = msgpack.restore(raw)
    want = serialization.msgpack_restore(raw)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["a"].shape == (5, 10)
    assert got["b"] == want["b"] and type(got["b"]) is type(want["b"])
    assert got["c"] == 1 + 2j
    assert got["d"]["1"] == want["d"]["1"]
    assert got["e"]["y"] == -2 ** 40 and got["e"]["w"] == b"raw"
    assert {k: v for k, v in got["e"].items() if k != "t"} == {
        k: v for k, v in want["e"].items() if k != "t"}
    assert got["e"]["t"].shape == (2, 0)


def test_test_mosi_scores_the_jax_store_as_the_release(capsys,
                                                       monkeypatch):
    from factorized_tpu_torch import cli
    from factorized_tpu_torch.serve import Predictor

    # the latency probes after the score weigh on no score
    monkeypatch.setattr(Predictor, "probe", lambda self, X: {})
    monkeypatch.setattr(Predictor, "device_latency", lambda self, X: {})
    assert cli.main(["test_mosi", "--checkpoint",
                     os.path.join(ROOT, "best", "mfn_mae"),
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    lines = dict(line.split(None, 1) for line in printed.splitlines()
                 if line.startswith(("mae:", "Accuracy ")))
    assert abs(float(lines["mae:"]) - 0.6101879) <= 1e-6
    assert abs(float(lines["Accuracy"]) - 0.8250729) <= 1e-6
