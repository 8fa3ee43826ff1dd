"""An Orbax PyTree checkpoint read as a nested dict of numpy arrays,
without Orbax.

The JAX package saves its training state with Orbax's
``PyTreeCheckpointer`` into ``<checkpoint>/state``: ``_METADATA`` (JSON)
describes the tree, and an OCDBT store (``utils/ocdbt.py``) at the same
directory holds one zarr v2 array a leaf (``utils/zarr.py``), keyed by
the leaf's path joined by ``.``. ``_METADATA``'s ``tree_metadata`` maps
each leaf to its path, a list of ``{"key", "key_type"}`` (key type 2 a
dict key, NamedTuple fields included; 1 a sequence index), and its
``value_metadata.value_type`` (``np.ndarray`` or ``jax.Array``: an array;
``scalar``: a Python number, as Orbax restores it). Only the layout the
JAX package writes is read: ``use_ocdbt`` true and ``use_zarr3`` false;
anything else raises naming the setting.

    from factorized_tpu_torch.utils.orbax import read_pytree
    state = read_pytree("run/ckpt_mosi_0/state")   # {"params": {...}, ...}
"""

from __future__ import annotations

import json
import os

from factorized_tpu_torch.utils import ocdbt, zarr

_ARRAY_TYPES = ("np.ndarray", "jax.Array")
_DICT_KEY, _SEQUENCE_INDEX = 2, 1


def _set(tree, path, value, where):
    node = tree
    for i, (key, kind) in enumerate(path):
        slot = key if kind == _DICT_KEY else int(key)
        if i == len(path) - 1:
            node[slot] = value
            return
        if slot not in node:
            node[slot] = {} if path[i + 1][1] == _DICT_KEY else _Seq()
        node = node[slot]
        if not isinstance(node, dict):
            raise ValueError(f"{where}: leaf {path} runs through a leaf")


class _Seq(dict):
    """A sequence while the tree is built: its items by index."""


def _finish(node, where):
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"{where}: sequence indices {sorted(node)}")
        return [_finish(node[i], where) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _finish(v, where) for k, v in node.items()}
    return node


def read_pytree(directory: str):
    """The PyTree Orbax saved at ``directory`` (the one holding
    ``_METADATA`` and ``manifest.ocdbt``): nested dicts (and lists for
    sequences) with numpy arrays and Python scalars at the leaves."""
    where = os.fspath(directory)
    with open(os.path.join(where, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3", False):
        raise ValueError(f"{where}: use_zarr3 is true; only zarr v2 arrays "
                         f"(use_zarr3: false) are read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{where}: use_ocdbt is false; only the OCDBT "
                         f"layout (use_ocdbt: true) is read")
    store = ocdbt.read(where)
    tree = {}
    for name, leaf in meta["tree_metadata"].items():
        path = [(k["key"], k["key_type"]) for k in leaf["key_metadata"]]
        for key, kind in path:
            if kind not in (_DICT_KEY, _SEQUENCE_INDEX):
                raise ValueError(f"{where}: leaf {name} has key type {kind} "
                                 f"(2 a dict key, 1 a sequence index)")
        value_meta = leaf["value_metadata"]
        kind = value_meta.get("value_type")
        if value_meta.get("skip_deserialize"):
            raise ValueError(f"{where}: leaf {name} is marked "
                             f"skip_deserialize")
        if kind not in _ARRAY_TYPES + ("scalar",):
            raise ValueError(f"{where}: leaf {name} has value type {kind!r}; "
                             f"arrays and scalars are read")
        value = zarr.read_array(store, ".".join(str(k) for k, _ in path))
        if kind == "scalar":
            value = value.item()
        _set(tree, path, value, where)
    return _finish(tree, where)
