"""The OCDBT key-value store (tensorstore's "optionally-cooperative
distributed B+tree") as tensorstore writes it under orbax.

Files, each ``magic (uint32be) | length (uint64le, the whole file) | version
(varint, 0) | compression (varint: 0 none, 1 zstd) | body | CRC-32C
(uint32le, of every byte before it)``:

* ``manifest.ocdbt`` (magic ``0x0cdb3a2a``): the configuration (uuid, manifest
  kind, inline-value limit, node-size limit, version-tree arity, node
  compression) and the versions, newest last, each with its B-tree root:
  ``(data file, offset, length)``, its height and its statistics.
* B-tree nodes (magic ``0x0cdb20de``), at an offset inside a data file
  ``d/<hex>`` (or ``ocdbt.process_<k>/d/<hex>``, where a per-process store
  wrote them): height, a table of the data files the node refers to, then
  its entries column by column.  A leaf's entries are keys and values, each
  value inline or a ``(data file, offset)`` reference; an interior node's are
  keys, the length of the key prefix its subtree shares, and child
  references.  Keys below an interior entry are stored without that prefix.

:func:`read_store` follows the newest version from the manifest through every
node and returns every key's value, checking each CRC; it refuses other magic
numbers, versions, compressions and the numbered-manifest layout.
:func:`write_store` writes one manifest, one data file holding the values
over the inline limit, and the root leaf node after them, in zstd frames of
raw blocks (:func:`.zstd.compress_raw`).
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from typing import Dict, List, Tuple

from . import zstd
from .crc32c import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024  # orbax's configuration
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_NO_ROOT = (1 << 64) - 1


class OcdbtError(ValueError):
    """A directory that is not an OCDBT store this reader reads."""


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.p, self.what = data, 0, what

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.p >= len(self.data):
                raise OcdbtError(f"{self.what}: truncated varint")
            b = self.data[self.p]
            self.p += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.data[self.p:self.p + n]
        self.p += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its header and CRC checked."""
    if len(blob) < 18:
        raise OcdbtError(f"{what}: {len(blob)} bytes, too short")
    found = struct.unpack_from(">I", blob)[0]
    if found != magic:
        raise OcdbtError(f"{what}: magic {found:#010x}, expected {magic:#010x}")
    length = struct.unpack_from("<Q", blob, 4)[0]
    if length != len(blob):
        raise OcdbtError(f"{what}: header says {length} bytes, the file has {len(blob)}")
    want = struct.unpack_from("<I", blob, len(blob) - 4)[0]
    if crc32c(blob[:-4]) != want:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(blob[:-4], what)
    cur.p = 12
    version = cur.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}, only 0 is read")
    compression = cur.varint()
    body = blob[cur.p:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: compression format {compression} (0 none, 1 zstd)")


def _frame(magic: int, body: bytes) -> bytes:
    head = struct.pack(">I", magic) + b"\0" * 8 + _varint(0) + _varint(1)
    blob = bytearray(head + zstd.compress_raw(body) + b"\0" * 4)
    struct.pack_into("<Q", blob, 4, len(blob))
    struct.pack_into("<I", blob, len(blob) - 4, crc32c(bytes(blob[:-4])))
    return bytes(blob)


def _read_file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    cur.varints(n)  # base path lengths: the path is read whole
    paths: List[bytes] = []
    for i in range(n):
        paths.append((paths[-1][:prefix[i]] if i else b"") + cur.take(suffix[i]))
    return [p.decode() for p in paths]


def _write_file_table(paths: List[str]) -> bytes:
    enc = [p.encode() for p in paths]
    out = [_varint(len(enc))]
    out += [_varint(0)] * max(len(enc) - 1, 0)
    out += [_varint(len(p)) for p in enc] + [_varint(0)] * len(enc)
    return b"".join(out + enc)


def _read_keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else [0] * n
    keys: List[bytes] = []
    for i in range(n):
        keys.append((keys[-1][:prefix[i]] if i else b"") + cur.take(suffix[i]))
    return keys, common


class _Store:
    def __init__(self, root: str):
        self.root = root
        self.files: Dict[str, bytes] = {}

    def file(self, path: str) -> bytes:
        if path not in self.files:
            full = os.path.join(self.root, path)
            if not os.path.isfile(full):
                raise OcdbtError(f"{self.root}: data file {path} is missing")
            with open(full, "rb") as f:
                self.files[path] = f.read()
        return self.files[path]

    def slice(self, path: str, offset: int, length: int) -> bytes:
        data = self.file(path)
        if offset + length > len(data):
            raise OcdbtError(f"{path}: [{offset}, {offset + length}) past its {len(data)} bytes")
        return data[offset:offset + length]

    def walk(self, ref, height: int, prefix: bytes, out: Dict[bytes, bytes]) -> None:
        path, offset, length = ref
        what = f"B-tree node {path}@{offset}"
        cur = _Cursor(_unframe(self.slice(path, offset, length), NODE_MAGIC, what), what)
        found = cur.byte()
        if found != height:
            raise OcdbtError(f"{what}: height {found}, its parent says {height}")
        files = _read_file_table(cur)
        n = cur.varint()
        keys, common = _read_keys(cur, n, interior=height > 0)

        def data_file(i: int) -> str:
            if i >= len(files):
                raise OcdbtError(f"{what}: data file {i} of {len(files)}")
            return files[i]

        if height > 0:
            ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
            for i in range(n):
                child = (data_file(ids[i]), offsets[i], lengths[i])
                self.walk(child, height - 1, prefix + keys[i][:common[i]], out)
            return
        sizes = cur.varints(n)
        kinds = cur.varints(n)
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"{what}: value kind {max(kinds)} (0 inline, 1 by reference)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids = cur.varints(len(indirect))
        offsets = cur.varints(len(indirect))
        refs = {i: (data_file(f), o) for i, f, o in zip(indirect, ids, offsets)}
        for i in range(n):
            if kinds[i] == 0:
                out[prefix + keys[i]] = cur.take(sizes[i])
            else:
                path_i, off = refs[i]
                out[prefix + keys[i]] = self.slice(path_i, off, sizes[i])
        if cur.p != len(cur.data):
            raise OcdbtError(f"{what}: {len(cur.data) - cur.p} bytes after its entries")


def read_store(root: str) -> Dict[bytes, bytes]:
    """Every key of the newest version of the store at ``root``, with its
    value."""
    path = os.path.join(root, "manifest.ocdbt")
    if not os.path.isfile(path):
        raise OcdbtError(f"{root}: no manifest.ocdbt (not an OCDBT store)")
    with open(path, "rb") as f:
        cur = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, path), path)
    cur.take(16)  # uuid
    kind = cur.varint()
    if kind != 0:
        raise OcdbtError(f"{path}: manifest kind {kind} (numbered); only the single-file "
                         "manifest that orbax writes is read")
    cur.varints(2)  # inline-value and node-size limits
    cur.byte()  # version tree arity
    if cur.varint() == 1:
        cur.take(4)  # zstd level
    files = _read_file_table(cur)
    n = cur.varint()
    if n == 0:
        return {}
    cols = [cur.varints(n)]  # generation
    cols.append(list(cur.take(n)))  # root height
    cols += [cur.varints(n) for _ in range(6)]  # file, offset, length, keys, bytes, indirect
    _, height, fid, offset, length = (c[-1] for c in cols[:5])
    out: Dict[bytes, bytes] = {}
    if offset == _NO_ROOT:
        return out
    if fid >= len(files):
        raise OcdbtError(f"{path}: root in data file {fid} of {len(files)}")
    _Store(root).walk((files[fid], offset, length), height, b"", out)
    return out


def write_store(root: str, items: Dict[bytes, bytes]) -> int:
    """A new store at ``root`` holding ``items``: one version, one root leaf.
    Returns the bytes written."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_name = f"d/{uuid.uuid4().hex}"
    keys = sorted(items)
    values = bytearray()
    kinds, ids, offsets = [], [], []
    inline = []
    for k in keys:
        v = items[k]
        if len(v) > MAX_INLINE_VALUE_BYTES:
            kinds.append(1)
            ids.append(0)
            offsets.append(len(values))
            values += v
        else:
            kinds.append(0)
            inline.append(v)
    body = [bytes([0]), _write_file_table([data_name] if offsets else []), _varint(len(keys))]
    prefix = [os.path.commonprefix([a, b]) for a, b in zip(keys, keys[1:])]
    body += [_varint(len(p)) for p in prefix]
    suffixes = [keys[0]] + [k[len(p):] for k, p in zip(keys[1:], prefix)] if keys else []
    body += [_varint(len(s)) for s in suffixes] + suffixes
    body += [_varint(len(items[k])) for k in keys] + [_varint(k) for k in kinds]
    body += [_varint(i) for i in ids] + [_varint(o) for o in offsets] + inline
    node = _frame(NODE_MAGIC, b"".join(body))
    node_offset = len(values)
    with open(os.path.join(root, data_name), "wb") as f:
        f.write(bytes(values) + node)
    config = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(1) + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(node_offset)
               + _varint(len(node)) + _varint(len(keys)) + _varint(len(node))
               + _varint(len(values)) + struct.pack("<Q", time.time_ns()) + _varint(0))
    manifest = _frame(MANIFEST_MAGIC, config + _write_file_table([data_name]) + version)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(manifest)
    return len(values) + len(node) + len(manifest)
