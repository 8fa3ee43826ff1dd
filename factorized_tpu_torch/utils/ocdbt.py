"""A read-only OCDBT key-value store (tensorstore's "Optionally-Cooperative
Distributed B+Tree" storage format), in Python.

Orbax writes a checkpoint's arrays into an OCDBT store: ``manifest.ocdbt``
at the store's root, and B+tree nodes and values in data files under it
(``d/<hash>``; a multi-process save keeps each process's store in
``ocdbt.process_<i>/`` and merges them under the top-level manifest,
whose nodes name those files as ``ocdbt.process_0/d/...``). This module
reads the latest version of such a store:

- the manifest: magic ``0x0cdb3a2a``, its length (little-endian uint64),
  format version 0, compression (0 none, 1 zstd, through ``utils.zstd``),
  the body and a crc32c of all bytes before it;
- the body: the config (uuid, manifest kind, inline and node size limits,
  version tree arity, compression) and, for the single-file manifest
  kind, the data file table and the version tree leaf, whose last entry
  is the latest version's root node;
- B+tree nodes (magic ``0x0cdb20de``, the same framing): height, data
  file table, keys with prefix compression (an interior entry also
  carries its subtree's common key prefix, which its child's keys leave
  out), and per leaf entry a value inline or as (file, offset, length).

A data file table holds (base path, relative path) pairs; a node's paths
are relative to the base path of the file it was read from, and the
manifest's to the store's root. Integers are LEB128 varints; each field
of a node is stored as one column over its entries.

    from factorized_tpu_torch.utils import ocdbt
    store = ocdbt.read("run/ckpt/state")      # a Mapping[str, bytes]
    raw = store["params.w/.zarray"]           # read when asked

Every malformed input raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

from factorized_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1          # the offset and length of an empty tree


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """The CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Varints, bytes and little-endian integers read in turn from
    ``data``; ``what`` names the source in errors."""

    def __init__(self, data, what):
        self.data, self.i, self.what = data, 0, what

    def _need(self, n):
        if self.i + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.i}")

    def varint(self):
        out = shift = 0
        while True:
            self._need(1)
            b = self.data[self.i]
            self.i += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long at byte "
                                 f"{self.i}")

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def byte(self):
        self._need(1)
        self.i += 1
        return self.data[self.i - 1]

    def take(self, n):
        self._need(n)
        self.i += n
        return bytes(self.data[self.i - n:self.i])

    def uint(self, n):
        return int.from_bytes(self.take(n), "little")


def _unframe(raw, magic, what):
    """The body of a manifest or node file: magic, length, version 0,
    compression, the body, crc32c; each checked."""
    if len(raw) < 18:
        raise ValueError(f"{what}: {len(raw)} bytes, too short for an OCDBT "
                         f"file")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: header says {length} bytes, found "
                         f"{len(raw)}")
    want = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != want:
        raise ValueError(f"{what}: crc32c mismatch")
    r = _Reader(raw[:-4], what)
    r.i = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, only 0 is read")
    compression = r.varint()
    body = raw[r.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: compression {compression} (0 none, 1 zstd)")


def _file_table(r, base):
    """A data file table: per file (its base path, its path), both relative
    to the store's root, the stored ones taken relative to ``base``."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    bases = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: data file path prefix past the "
                             f"previous path")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if bases[i] > len(full):
            raise ValueError(f"{r.what}: data file base path past its path")
        full_path = base + full.decode()
        paths.append((full_path[:len(base) + bases[i]], full_path))
        prev = full
    return paths


def _keys(r, n, interior):
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: key prefix past the previous key")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


class Store(Mapping):
    """The latest version of the OCDBT store at ``root`` as a read-only
    mapping of keys (str) to values (bytes). The B+tree is read when the
    store opens; a value stored out of line is read from its data file
    when it is asked for."""

    def __init__(self, root: str):
        self.root = os.fspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(_unframe(f.read(), MANIFEST_MAGIC, path), path)
        r.take(16)                     # the store's uuid
        kind = r.varint()
        r.varint()                     # the largest value kept inline
        self.max_decoded_node_bytes = r.varint()
        r.byte()                       # version tree arity (log2)
        method = r.varint()
        if method == 1:
            r.uint(4)                  # zstd level
        elif method != 0:
            raise ValueError(f"{path}: node compression {method} (0 none, "
                             f"1 zstd)")
        if kind != 0:
            raise ValueError(f"{path}: manifest kind {kind} (numbered "
                             f"manifests) is not read; only the single-file "
                             f"manifest (kind 0)")
        files = _file_table(r, "")
        n = r.varint()
        r.varints(n)                   # generation numbers
        heights = [r.byte() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self._entries = {}
        if not n:
            raise ValueError(f"{path}: no version")
        if offsets[-1] == _MISSING:
            return                     # the latest version is empty
        if ids[-1] >= len(files):
            raise ValueError(f"{path}: root in data file {ids[-1]} of "
                             f"{len(files)}")
        self._node(*files[ids[-1]], offsets[-1], lengths[-1], heights[-1],
                   b"")

    def _read(self, rel, offset, length):
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(length)
        if len(raw) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} run past "
                             f"the file")
        return raw

    def _node(self, base, rel, offset, length, height, prefix):
        """The entries of the node at ``rel`` (``offset``, ``length``),
        whose keys follow ``prefix``; its data file table's paths are
        relative to ``base``."""
        what = f"{os.path.join(self.root, rel)}@{offset}"
        body = _unframe(self._read(rel, offset, length), NODE_MAGIC, what)
        if len(body) > self.max_decoded_node_bytes:
            raise ValueError(f"{what}: node of {len(body)} bytes past the "
                             f"store's {self.max_decoded_node_bytes}")
        r = _Reader(body, what)
        got = r.byte()
        if got != height:
            raise ValueError(f"{what}: node height {got}, its parent says "
                             f"{height}")
        files = _file_table(r, base)
        n = r.varint()
        if not n:
            raise ValueError(f"{what}: node without entries")
        keys, common = _keys(r, n, height > 0)
        if height:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                if ids[i] >= len(files):
                    raise ValueError(f"{what}: child in data file {ids[i]} "
                                     f"of {len(files)}")
                self._node(*files[ids[i]], offsets[i], lengths[i],
                           height - 1, prefix + keys[i][:common[i]])
            return
        sizes = r.varints(n)
        kinds = r.varints(n)
        out_of_line = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)} (0 inline, 1 "
                             f"in a data file)")
        ids = r.varints(len(out_of_line))
        offsets = r.varints(len(out_of_line))
        for i, f, o in zip(out_of_line, ids, offsets):
            if f >= len(files):
                raise ValueError(f"{what}: value in data file {f} of "
                                 f"{len(files)}")
            self._entries[(prefix + keys[i]).decode()] = (files[f][1], o,
                                                          sizes[i])
        for i in range(n):
            if kinds[i] == 0:
                self._entries[(prefix + keys[i]).decode()] = r.take(sizes[i])
        if r.i != len(body):
            raise ValueError(f"{what}: {len(body) - r.i} bytes after the "
                             f"last value")

    def __getitem__(self, key):
        v = self._entries[key]
        if isinstance(v, bytes):
            return v
        return self._read(*v)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)


def read(root: str) -> Store:
    """The OCDBT store at ``root`` (the directory holding
    ``manifest.ocdbt``) as a mapping of keys to bytes, read lazily."""
    return Store(root)
