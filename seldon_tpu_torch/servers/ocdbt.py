"""A read-only OCDBT key-value store, and a writer of the simplest one.

OCDBT (tensorstore's "optionally-cooperative distributed B+tree") is the
on-disk key-value store under every orbax checkpoint the JAX package
saves: ``params/manifest.ocdbt`` names the newest B-tree, whose leaves hold
small values in the node and large ones as (data file, offset, length).
Orbax writes each process's arrays under ``ocdbt.process_<i>/`` and then a
top-level tree at ``params/`` whose data-file table points into those
directories; every path in a table is resolved against the store's root,
after the base path of the data file that held the node.

Every file OCDBT writes is a container:

    magic u32 big-endian | length u64 LE (the whole file) | version varint (0)
    | compression varint (0 none, 1 zstd) | body | CRC-32C u32 LE

with the checksum over everything before it. Manifests (magic
``0x0cdb3a2a``) hold the config, a data-file table, the newest versions
and references to version-tree nodes (``0x0cdb1234``) that hold the older
ones; B-tree nodes (``0x0cdb20de``) hold a height, a data-file table and
their entries in columns of varints. The byte layout below was read off
stores that tensorstore wrote (the format is tensorstore's "OCDBT" on-disk
documentation); ``tests/test_torch_ocdbt.py`` holds it to tensorstore on
trees with interior nodes, many generations and both kinds of value.

:class:`OcdbtReader` reads the newest generation: ``list(prefix)`` and
``read(key)`` (``view(key)`` without a copy). :class:`StoreWriter` writes
a store tensorstore and orbax read back: one uncompressed leaf node, each
value larger than ``MAX_INLINE`` bytes in a data file of its own.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from seldon_tpu_torch.servers import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # offset and length of an empty tree's root
MANIFEST_SINGLE = 0
MAX_INLINE = 1024  # StoreWriter: larger values go to a data file (orbax's)


class OcdbtError(ValueError):
    """A store the reader refuses: a bad magic number, length or checksum,
    an unknown version or compression, or a malformed table."""


class _Cursor:
    """Reads varints, fixed-width integers and byte runs from a body."""

    def __init__(self, data: bytes, what: str):
        self.d = data
        self.pos = 0
        self.what = what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.d):
            raise OcdbtError(f"{self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        out = shift = 0
        while True:
            self._need(1)
            b = self.d[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.d[self.pos - 1]

    def u64s(self, n: int) -> List[int]:
        self._need(8 * n)
        out = list(struct.unpack_from(f"<{n}Q", self.d, self.pos))
        self.pos += 8 * n
        return out

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return bytes(self.d[self.pos - n:self.pos])

    def done(self) -> None:
        if self.pos != len(self.d):
            raise OcdbtError(f"{self.what}: {len(self.d) - self.pos} bytes "
                             "after the last field")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        if v < 0x80:
            out.append(v)
            return bytes(out)
        out.append((v & 0x7F) | 0x80)
        v >>= 7


def _open_container(raw: bytes, magic: int, what: str) -> bytes:
    """The body of one container, its magic, length and CRC-32C checked."""
    if len(raw) < 16:
        raise OcdbtError(f"{what}: {len(raw)} bytes is too short")
    got_magic, length = struct.unpack_from(">I", raw)[0], \
        struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(raw):
        raise OcdbtError(f"{what}: states {length} bytes, holds {len(raw)}")
    want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    if zstd.crc32c(raw[:-4]) != want:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(raw[:-4], what)
    cur.pos = 12
    version = cur.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (reads 0)")
    compression = cur.varint()
    body = raw[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: unknown compression {compression}")


def _container(magic: int, body: bytes) -> bytes:
    """``body`` as an uncompressed container with its CRC-32C."""
    head = _varint(0) + _varint(0)
    length = 4 + 8 + len(head) + len(body) + 4
    raw = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return raw + struct.pack("<I", zstd.crc32c(raw))


@dataclass(frozen=True)
class DataFile:
    base: str  # the base path (its nodes' table entries resolve after it)
    rel: str

    @property
    def path(self) -> str:
        return self.base + self.rel


def _read_file_table(cur: _Cursor, base: str) -> List[DataFile]:
    """A data-file table: the count, each path's prefix length shared with
    the previous path, each suffix length, each base-path length, then
    the suffixes. Entries resolve after ``base`` (the base path of the
    data file that held this node)."""
    n = cur.varint()
    prefix = cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    out: List[DataFile] = []
    prev = b""
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            raise OcdbtError(f"{cur.what}: data-file prefix {keep} longer "
                             f"than the previous path")
        path = prev[:keep] + cur.take(suffix[i])
        if base_len[i] > len(path):
            raise OcdbtError(f"{cur.what}: base path longer than its path")
        s = path.decode()
        out.append(DataFile(base + s[:base_len[i]], s[base_len[i]:]))
        prev = path
    return out


def _file_of(table: Sequence[DataFile], i: int, what: str) -> DataFile:
    if i >= len(table):
        raise OcdbtError(f"{what}: data file {i} of a table of {len(table)}")
    return table[i]


def _read_keys(cur: _Cursor, n: int, interior: bool
               ) -> Tuple[List[bytes], List[int]]:
    """The n keys of a node (prefix-compressed against the previous key)
    and, for an interior node, each entry's subtree common prefix
    length."""
    prefix = cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys: List[bytes] = []
    prev = b""
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            raise OcdbtError(f"{cur.what}: key prefix longer than its "
                             "predecessor")
        prev = prev[:keep] + cur.take(suffix[i])
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class _Value:
    inline: Optional[bytes]
    file: Optional[DataFile] = None
    offset: int = 0
    length: int = 0


class OcdbtReader:
    """The newest generation of the OCDBT store at directory ``root``.

    The whole key index is read at open (an orbax checkpoint holds a few
    keys per leaf); each data file is mapped once and values are read as
    slices of it."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._maps: Dict[str, np.memmap] = {}
        raw = self._file("manifest.ocdbt")
        body = _open_container(bytes(raw), MANIFEST_MAGIC, "manifest.ocdbt")
        cur = _Cursor(body, "manifest.ocdbt")
        self.config = self._read_config(cur)
        if self.config["manifest_kind"] != MANIFEST_SINGLE:
            raise OcdbtError("manifest.ocdbt: numbered manifests are not "
                             "supported (orbax writes a single manifest)")
        table = _read_file_table(cur, "")
        inline = self._version_entries(cur, table, "manifest.ocdbt")
        refs = self._node_refs(cur, table, with_height=True)
        cur.done()
        self.generation, height, root_ref = self._newest(inline, refs)
        self._index: Dict[bytes, _Value] = {}
        if root_ref is not None:
            self._walk(root_ref, height, b"")

    # -- files -----------------------------------------------------------

    def _file(self, rel: str) -> np.ndarray:
        m = self._maps.get(rel)
        if m is None:
            # The tables' paths are the checkpoint's own bytes: one that is
            # absolute or climbs out of the store is refused, not mapped.
            path = os.path.normpath(os.path.join(self.root, rel))
            if os.path.isabs(rel) or not path.startswith(self.root + os.sep):
                raise OcdbtError(f"data file {rel!r} lies outside the "
                                 f"store {self.root}")
            if os.path.getsize(path) == 0:
                m = np.zeros(0, np.uint8)
            else:
                m = np.memmap(path, np.uint8, mode="r")
            self._maps[rel] = m
        return m

    def _slice(self, f: DataFile, offset: int, length: int,
               what: str) -> np.ndarray:
        m = self._file(f.path)
        if offset + length > m.size:
            raise OcdbtError(f"{what}: bytes [{offset}, {offset + length}) "
                             f"past the end of {f.path} ({m.size} bytes)")
        return m[offset:offset + length]

    # -- manifest and version tree --------------------------------------

    @staticmethod
    def _read_config(cur: _Cursor) -> dict:
        cfg = {"uuid": cur.take(16).hex(),
               "manifest_kind": cur.varint(),
               "max_inline_value_bytes": cur.varint(),
               "max_decoded_node_bytes": cur.varint(),
               "version_tree_arity_log2": cur.byte()}
        method = cur.varint()
        if method == 0:
            cfg["compression"] = None
        elif method == 1:
            level = struct.unpack("<i", cur.take(4))[0]
            cfg["compression"] = {"id": "zstd", "level": level}
        else:
            raise OcdbtError(f"{cur.what}: unknown compression method "
                             f"{method}")
        return cfg

    @staticmethod
    def _version_entries(cur: _Cursor, table, what) -> List[tuple]:
        """(generation, root height, (file, offset, length)) of each
        version a manifest or a version-tree leaf holds."""
        n = cur.varint()
        gens = cur.varints(n)
        heights = [cur.byte() for _ in range(n)]
        files = cur.varints(n)
        offsets = cur.varints(n)
        lengths = cur.varints(n)
        cur.varints(3 * n)  # num_keys, num_tree_bytes, indirect bytes
        cur.u64s(n)  # commit times
        out = []
        for g, h, f, o, ln in zip(gens, heights, files, offsets, lengths):
            ref = None if ln == MISSING else (_file_of(table, f, what), o, ln)
            out.append((g, h, ref))
        return out

    @staticmethod
    def _node_refs(cur: _Cursor, table, with_height: bool) -> List[tuple]:
        """(generation, height or None, (file, offset, length)) of each
        version-tree node a manifest or interior version node refers to."""
        n = cur.varint()
        gens = cur.varints(n)
        files = cur.varints(n)
        offsets = cur.varints(n)
        lengths = cur.varints(n)
        cur.varints(n)  # num_generations
        cur.u64s(n)  # commit times
        heights = [cur.byte() for _ in range(n)] if with_height else [None] * n
        return [(g, h, (_file_of(table, f, cur.what), o, ln))
                for g, h, f, o, ln in zip(gens, heights, files, offsets,
                                          lengths)]

    def _newest(self, inline, refs):
        """(generation, root height, root ref) of the newest version."""
        best = max(inline, key=lambda e: e[0], default=None)
        ref = max(refs, key=lambda e: e[0], default=None)
        while best is None or (ref is not None and ref[0] > best[0]):
            if ref is None:
                raise OcdbtError("manifest.ocdbt: no version")
            f, off, ln = ref[2]
            what = f"version node {f.path}@{off}"
            cur = _Cursor(_open_container(bytes(self._slice(f, off, ln, what)),
                                          VERSION_NODE_MAGIC, what), what)
            cur.byte()  # arity log2
            height = cur.byte()
            table = _read_file_table(cur, f.base)
            if height == 0:
                entries = self._version_entries(cur, table, what)
                cand = max(entries, key=lambda e: e[0], default=None)
                if cand is not None and (best is None or cand[0] > best[0]):
                    best = cand
                ref = None
            else:
                ref = max(self._node_refs(cur, table, with_height=False),
                          key=lambda e: e[0], default=None)
            cur.done()
        return best

    # -- B-tree ----------------------------------------------------------

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        f, off, ln = ref
        what = f"b-tree node {f.path}@{off}"
        body = _open_container(bytes(self._slice(f, off, ln, what)),
                               BTREE_NODE_MAGIC, what)
        cur = _Cursor(body, what)
        h = cur.byte()
        if h != height:
            raise OcdbtError(f"{what}: height {h}, its parent says {height}")
        table = _read_file_table(cur, f.base)
        n = cur.varint()
        keys, common = _read_keys(cur, n, interior=h > 0)
        if h > 0:
            files = cur.varints(n)
            offsets = cur.varints(n)
            lengths = cur.varints(n)
            cur.varints(3 * n)  # statistics
            cur.done()
            for k, c, fi, o, ln in zip(keys, common, files, offsets, lengths):
                if c > len(k):
                    raise OcdbtError(f"{what}: common prefix longer than "
                                     "its key")
                self._walk((_file_of(table, fi, what), o, ln), h - 1,
                           prefix + k[:c])
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"{what}: unknown value kind")
        n_out = sum(kinds)
        files = cur.varints(n_out)
        offsets = cur.varints(n_out)
        j = 0
        for k, kind, ln in zip(keys, kinds, lengths):
            if kind == 0:
                self._index[prefix + k] = _Value(cur.take(ln))
            else:
                self._index[prefix + k] = _Value(
                    None, _file_of(table, files[j], what), offsets[j], ln)
                j += 1
        cur.done()

    # -- API -------------------------------------------------------------

    def list(self, prefix: Union[str, bytes] = "") -> List[str]:
        """The keys that start with ``prefix``, sorted."""
        p = prefix.encode() if isinstance(prefix, str) else prefix
        return sorted(k.decode() for k in self._index if k.startswith(p))

    def view(self, key: Union[str, bytes]) -> np.ndarray:
        """The value of ``key`` as a uint8 array: a slice of the mapped
        data file (no copy) for a value stored outside its node."""
        k = key.encode() if isinstance(key, str) else key
        v = self._index.get(k)
        if v is None:
            raise KeyError(key)
        if v.inline is not None:
            return np.frombuffer(v.inline, np.uint8)
        return self._slice(v.file, v.offset, v.length, f"value {key!r}")

    def read(self, key: Union[str, bytes]) -> bytes:
        """The value of ``key``; KeyError when the store has none."""
        return self.view(key).tobytes()

    def close(self) -> None:
        self._maps.clear()


# -- writer ------------------------------------------------------------------


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _file_table(paths: Sequence[str]) -> bytes:
    enc = [p.encode() for p in paths]
    prefix = [_common(enc[i - 1], enc[i]) for i in range(1, len(enc))]
    out = [_varint(len(enc))]
    out += [_varint(p) for p in prefix]
    out += [_varint(len(e) - (prefix[i - 1] if i else 0))
            for i, e in enumerate(enc)]
    out += [_varint(0) for _ in enc]  # base paths: none
    out += [e[prefix[i - 1] if i else 0:] for i, e in enumerate(enc)]
    return b"".join(out)


Value = Union[bytes, Tuple[int, Iterable]]


class StoreWriter:
    """Writes a new OCDBT store at directory ``root``: :meth:`put` each
    key once (a value larger than ``MAX_INLINE`` bytes goes at once to a
    data file of its own under ``d/``), then :meth:`commit` writes one
    uncompressed leaf node holding every key and the small values, and
    the manifest naming it as generation 1. The config is what orbax
    writes (zstd level 0 for nodes a later writer adds, 1024 inline
    bytes, 100 MB nodes)."""

    def __init__(self, root: str):
        self.root = root
        self._entries: Dict[bytes, tuple] = {}  # key -> (length, bytes|rel)
        os.makedirs(os.path.join(root, "d"), exist_ok=True)

    def put(self, key: str, value: Value) -> None:
        """``value``: bytes, or (length, iterable of bytes-like parts),
        streamed to its file without being joined in memory."""
        k = key.encode()
        if k in self._entries:
            raise ValueError(f"key {key!r} written twice")
        length, parts = ((len(value), [value])
                         if isinstance(value, (bytes, bytearray, memoryview))
                         else value)
        if length <= MAX_INLINE:
            data = b"".join(bytes(p) for p in parts)
            if len(data) != length:
                raise ValueError(f"{key!r}: {len(data)} bytes, said {length}")
            self._entries[k] = (length, data)
            return
        rel = f"d/{uuid.uuid4().hex}"
        written = 0
        with open(os.path.join(self.root, rel), "wb") as fh:
            for p in parts:
                written += fh.write(p)
        if written != length:
            raise ValueError(f"{key!r}: wrote {written} bytes, said {length}")
        self._entries[k] = (length, rel)

    def commit(self) -> None:
        keys = sorted(self._entries)
        entries = [self._entries[k] for k in keys]
        outs = [e for e in entries if isinstance(e[1], str)]
        paths = sorted({e[1] for e in outs})
        file_id = {p: i for i, p in enumerate(paths)}
        n = len(keys)
        prefix = [_common(keys[i - 1], keys[i]) for i in range(1, n)]
        body = b"".join([
            bytes([0]),  # height: a leaf
            _file_table(paths),
            _varint(n),
            *[_varint(p) for p in prefix],
            *[_varint(len(k) - (prefix[i - 1] if i else 0))
              for i, k in enumerate(keys)],
            *[k[prefix[i - 1] if i else 0:] for i, k in enumerate(keys)],
            *[_varint(e[0]) for e in entries],
            *[_varint(0 if isinstance(e[1], bytes) else 1) for e in entries],
            *[_varint(file_id[e[1]]) for e in outs],
            *[_varint(0) for _ in outs],  # each value starts its file
            *[e[1] for e in entries if isinstance(e[1], bytes)],
        ])
        node = _container(BTREE_NODE_MAGIC, body)
        node_rel = f"d/{uuid.uuid4().hex}"
        with open(os.path.join(self.root, node_rel), "wb") as fh:
            fh.write(node)
        config = b"".join([
            uuid.uuid4().bytes, _varint(MANIFEST_SINGLE), _varint(MAX_INLINE),
            _varint(100_000_000), bytes([4]), _varint(1),
            struct.pack("<i", 0)])
        manifest = b"".join([
            config,
            _file_table([node_rel]),
            _varint(1),  # one version
            _varint(1),  # generation 1
            bytes([0]),  # root height
            _varint(0), _varint(0), _varint(len(node)),  # file 0, 0, len
            _varint(n), _varint(len(node)),
            _varint(sum(e[0] for e in outs)),
            struct.pack("<Q", time.time_ns()),
            _varint(0),  # no version-tree nodes
        ])
        tmp = os.path.join(self.root, f"manifest.ocdbt.{os.getpid()}.tmp")
        with open(tmp, "wb") as fh:
            fh.write(_container(MANIFEST_MAGIC, manifest))
        os.replace(tmp, os.path.join(self.root, "manifest.ocdbt"))
