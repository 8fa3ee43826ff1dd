"""zarr v2 arrays read from a mapping of keys to bytes (an OCDBT store,
``utils/ocdbt.py``), as numpy arrays.

An array at ``name`` is its metadata ``name/.zarray`` (JSON: ``shape``,
``chunks``, ``dtype``, ``order``, ``fill_value``, ``compressor``,
``filters``, ``dimension_separator``) and one value a chunk, keyed by the
chunk's grid indices joined by the separator (``name/0.0``; ``name/0``
for a 0-d array). Each chunk holds a whole chunk's elements, edge chunks
too, in C or F order, compressed by zstd (``utils.zstd``) or not at all.
A missing chunk reads as the fill value (zeros where it is null), as an
Orbax save with ``store_array_data_equal_to_fill_value`` may leave it
out. Dtypes are numpy's type strings, either byte order; the array comes
back in the host's byte order.

    from factorized_tpu_torch.utils import ocdbt, zarr
    w = zarr.read_array(ocdbt.read("ckpt/state"), "params.w")
"""

from __future__ import annotations

import itertools
import json
from collections.abc import Mapping

import numpy as np

from factorized_tpu_torch.utils import zstd


def _fill(value, dtype):
    if value is None:
        return np.zeros((), dtype)
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special:
            raise ValueError(f"zarr: fill value {value!r} is not read")
        value = special[value]
    return np.asarray(value, dtype)


def read_array(store: Mapping, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``, a numpy array in the host's
    byte order."""
    meta_key = f"{name}/.zarray"
    if meta_key not in store:
        raise KeyError(f"zarr: no array {name!r} ({meta_key} missing)")
    meta = json.loads(store[meta_key])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr: {name} has zarr_format "
                         f"{meta.get('zarr_format')!r}, only 2 is read")
    if meta.get("filters"):
        raise ValueError(f"zarr: {name} has filters {meta['filters']}, "
                         f"which are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr: {name} has compressor {comp.get('id')!r}; "
                         f"only zstd and null are read")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"zarr: {name} has order {order!r}")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"zarr: {name} has dtype {meta['dtype']!r}, which "
                         f"numpy does not read") from e
    if dtype.hasobject or dtype.fields:
        raise ValueError(f"zarr: {name} has dtype {meta['dtype']!r}")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr: {name} has chunks {chunks} for shape "
                         f"{shape}")
    sep = meta.get("dimension_separator", ".")
    native = dtype.newbyteorder("=")
    out = np.empty(shape, native)
    out[...] = _fill(meta.get("fill_value"), native)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    count = int(np.prod(chunks))
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = store[key]
        if comp is not None:
            raw = zstd.decompress(raw)
        if len(raw) != count * dtype.itemsize:
            raise ValueError(f"zarr: chunk {key} holds {len(raw)} bytes, a "
                             f"chunk of {chunks} {dtype} needs "
                             f"{count * dtype.itemsize}")
        block = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        at = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[at] = block[tuple(slice(0, a.stop - a.start) for a in at)]
    return out
