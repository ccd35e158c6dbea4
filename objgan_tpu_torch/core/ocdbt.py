"""A reader of tensorstore's OCDBT key-value store, the store an Orbax
checkpoint keeps its arrays in (``<step>/default/``), without tensorstore.

Layout, as tensorstore's OCDBT driver documents it (read only here):

* ``manifest.ocdbt``: a header (magic ``0x0cdb3a2a`` big-endian, the file's
  length as u64, a varint version, a varint compression: 0 none, 1 zstd),
  the body, and a crc32c of everything before it. The body holds the
  config (uuid, manifest kind, inline and node size limits, the version
  tree's arity, the node compression) and the newest versions inline: each
  a generation number, the root B-tree node's height and location, its
  statistics and its commit time.
* B-tree nodes (magic ``0x0cdb20de``), several to a data file, each found
  by (data file, offset, length). A node's body is its height, a table of
  the data files it names, and its entries. Keys are prefix-compressed
  within a node; an interior entry also says how many leading bytes of its
  key every key under it shares, and those bytes are left out below.
* A leaf value is inline or a (data file, offset) reference with the
  entry's value length.
* Arrays within a node are stored column by column: all key lengths, then
  all value lengths, and so on; integers are LEB128 varints.

A data file's path is relative to the directory of the manifest that names
it (Orbax's top-level manifest names nodes in its own ``d/`` and values in
``ocdbt.process_<i>/d/``); no directory is listed. A truncated or corrupt
file (length, magic or checksum wrong) raises ``OcdbtError``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

from objgan_tpu_torch.core import zstd

MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # the offset of an empty tree's root


class OcdbtError(ValueError):
    """A malformed, truncated or unsupported OCDBT file."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Varints and fixed-width integers from a bytes object."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"truncated {self.what}")

    def varint(self) -> int:
        value, shift = 0, 0
        data = self.data
        while True:
            if self.pos >= len(data):
                raise OcdbtError(f"truncated {self.what}")
            b = data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"varint too long in {self.what}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def uint(self, n: int) -> int:
        self.need(n)
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def take(self, n: int) -> bytes:
        self.need(n)
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node, its header and checksum checked and
    its compression undone."""
    if len(raw) < 12 + 4:
        raise OcdbtError(f"truncated {what}")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: bad magic {got:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise OcdbtError(f"truncated {what}: {len(raw)} of {length} bytes")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OcdbtError(f"{what}: checksum mismatch")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = raw[r.pos:-4]
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from e
    if compression:
        raise OcdbtError(f"{what}: compression {compression}")
    return body


def _data_files(r: _Reader, base: str) -> List[str]:
    """A data file table: each file's path, joined onto ``base``."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the split does not change the path
    paths: List[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError("bad data file table")
        path = prev[:prefix[i]] + r.take(suffix[i])
        paths.append(path.decode())
        prev = path
    return [os.path.join(base, p) for p in paths]


class _Store:
    """An open store: the root of its newest version and a cache of the
    data files read so far."""

    def __init__(self, directory: str):
        self.directory = directory
        self._files: Dict[str, bytes] = {}
        self.root = self._manifest(os.path.join(directory, MANIFEST))

    def read_file(self, path: str) -> bytes:
        data = self._files.get(path)
        if data is None:
            with open(path, "rb") as f:
                data = self._files[path] = f.read()
        return data

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        data = self.read_file(path)
        if offset + length > len(data):
            raise OcdbtError(f"truncated data file {path}: needs "
                             f"{offset + length} bytes, has {len(data)}")
        return data[offset:offset + length]

    def _manifest(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        r = _Reader(_unframe(raw, _MANIFEST_MAGIC, f"manifest {path}"),
                    f"manifest {path}")
        r.take(16)  # uuid
        kind = r.varint()
        r.varint(), r.varint()  # max inline value bytes, max node bytes
        r.uint(1)  # version tree arity log2
        if r.varint() == 1:
            r.uint(4)  # zstd level
        if kind != 0:
            raise OcdbtError(f"manifest {path}: numbered manifests are not "
                             "supported")
        files = _data_files(r, os.path.dirname(path))
        n = r.varint()
        gens = r.varints(n)
        heights = [r.uint(1) for _ in range(n)]
        fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect bytes
        for _ in range(n):
            r.uint(8)  # commit time
        if not n:
            return None
        i = max(range(n), key=gens.__getitem__)
        if offs[i] == _NO_ROOT:
            return None
        if fids[i] >= len(files):
            raise OcdbtError(f"manifest {path}: bad data file id")
        return files[fids[i]], offs[i], lens[i], heights[i]

    def node(self, path: str, offset: int, length: int):
        what = f"B-tree node {path}@{offset}"
        r = _Reader(_unframe(self.read_range(path, offset, length),
                             _NODE_MAGIC, what), what)
        height = r.uint(1)
        files = _data_files(r, self.directory)
        n = r.varint()
        prefix = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys: List[bytes] = []
        prev = b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise OcdbtError(f"{what}: bad key prefix")
            key = prev[:prefix[i]] + r.take(suffix[i])
            keys.append(key)
            prev = key

        def file(i):
            if i >= len(files):
                raise OcdbtError(f"{what}: bad data file id")
            return files[i]

        if height:
            fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics
            return height, [(keys[i], common[i], file(fids[i]), offs[i],
                             lens[i]) for i in range(n)]
        vlens = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        fids = r.varints(len(indirect))
        offs = r.varints(len(indirect))
        where = dict(zip(indirect, zip(fids, offs)))
        values = []
        for i in range(n):
            if kinds[i] == 0:
                values.append(r.take(vlens[i]))
            elif kinds[i] == 1:
                fid, off = where[i]
                values.append((file(fid), off, vlens[i]))
            else:
                raise OcdbtError(f"{what}: value kind {kinds[i]}")
        if r.pos != len(r.data):
            raise OcdbtError(f"{what}: {len(r.data) - r.pos} trailing bytes")
        return 0, list(zip(keys, values))


class OcdbtStore:
    """The newest version of the OCDBT store in ``directory`` (the directory
    of its ``manifest.ocdbt``), read only. ``keys()`` lists every key in
    order; ``items()`` yields (key, value) and ``read(key)`` one value."""

    def __init__(self, directory: str):
        self._store = _Store(directory)
        self._entries: Optional[Dict[bytes, object]] = None

    def _walk(self) -> Iterator[Tuple[bytes, object]]:
        root = self._store.root
        if root is None:
            return
        path, off, length, height = root
        yield from self._subtree(b"", path, off, length, height)

    def _subtree(self, prefix: bytes, path: str, off: int, length: int,
                 height: int):
        got, entries = self._store.node(path, off, length)
        if got != height:
            raise OcdbtError(f"B-tree node {path}@{off}: height {got}, its "
                             f"parent says {height}")
        if height == 0:
            for key, value in entries:
                yield prefix + key, value
            return
        for key, common, cpath, coff, clen in entries:
            yield from self._subtree(prefix + key[:common], cpath, coff, clen,
                                     height - 1)

    def entries(self) -> Dict[bytes, object]:
        if self._entries is None:
            self._entries = dict(self._walk())
        return self._entries

    def keys(self) -> List[bytes]:
        return sorted(self.entries())

    def _value(self, value) -> bytes:
        if isinstance(value, bytes):
            return value
        return self._store.read_range(*value)

    def read(self, key) -> Optional[bytes]:
        """The value of ``key`` (bytes or str), or None when absent."""
        if isinstance(key, str):
            key = key.encode()
        value = self.entries().get(key)
        return None if value is None else self._value(value)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        for key in self.keys():
            yield key, self._value(self.entries()[key])
