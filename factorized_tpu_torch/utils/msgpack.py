"""A MessagePack decoder, and flax's msgpack restore without a target.

The JAX package writes a checkpoint without Orbax as
``flax.serialization.to_bytes(state)`` in ``state.msgpack``: the state
dict of ``serialization.to_state_dict`` (dicts with string keys; a tuple
or list as a dict keyed ``"0"``, ``"1"``, ...; a NamedTuple as a dict of
its fields) packed by msgpack, with flax's extension types for its
leaves:

- 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
- 2, a Python complex: the msgpack of ``(real, imag)``;
- 3, a numpy scalar: an ndarray of shape ``()``, unpacked to its scalar;

and an array larger than flax's chunk size as a dict ``{"__msgpack_
chunked_array__": True, "shape": {...}, "chunks": {...}}`` of flat
pieces. ``restore`` returns that state dict with every array whole, as
``serialization.msgpack_restore`` does. ``unpackb`` decodes every msgpack
type (nil, booleans, integers, floats, str, bin, arrays, maps and ext,
in all their widths); an ext type it does not know comes back as
``ExtType``.

    from factorized_tpu_torch.utils.msgpack import restore
    with open("ckpt/state.msgpack", "rb") as f:
        state = restore(f.read())
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    code: int
    data: bytes


def _ndarray(data):
    shape, name, buffer = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"msgpack: ndarray of dtype {name!r}, which numpy "
                         f"does not read") from e
    return np.frombuffer(buffer, dtype).reshape(shape).copy()


def flax_ext(code, data):
    """flax's extension types: 1 an ndarray, 2 a complex, 3 a numpy
    scalar; any other code an ``ExtType``."""
    if code == 1:
        return _ndarray(data)
    if code == 2:
        re, im = unpackb(data)
        return complex(re, im)
    if code == 3:
        return _ndarray(data)[()]
    return ExtType(code, data)


class _Unpacker:
    def __init__(self, data, ext_hook):
        self.data, self.i, self.ext_hook = data, 0, ext_hook

    def take(self, n):
        if self.i + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.i}")
        self.i += n
        return self.data[self.i - n:self.i]

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        at = self.i
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i",
                                ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: byte {b:#04x} (never used) at byte {at}")

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            if isinstance(k, list):
                k = tuple(k)
            out[k] = self.value()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))


def unpackb(data, ext_hook=ExtType):
    """The one msgpack object in ``data``; ``ext_hook(code, bytes)`` makes
    each extension value."""
    u = _Unpacker(memoryview(bytes(data)), ext_hook)
    out = u.value()
    if u.i != len(u.data):
        raise ValueError(f"msgpack: {len(u.data) - u.i} bytes after the "
                         f"object")
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data):
    """The state dict in flax msgpack bytes ``data``, chunked arrays made
    whole (``flax.serialization.msgpack_restore`` without flax)."""
    return _unchunk(unpackb(data, ext_hook=flax_ext))
