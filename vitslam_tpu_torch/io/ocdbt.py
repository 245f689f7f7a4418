"""Read-only reader of tensorstore's OCDBT key-value store ("Optionally-
Cooperative Distributed B+Tree", tensorstore's "OCDBT storage format"),
the store under an orbax checkpoint directory (``io/orbax_format.py``).

A database directory holds ``manifest.ocdbt`` and data files under ``d/``.
The manifest carries the configuration and the version tree; the newest
version names the root B+tree node by data file, offset and length. Nodes
and the manifest each have a header (magic, length, format version,
compression), a body (zstd-compressed when the header says so) and a
trailing CRC-32C, which is checked. Interior nodes list their children
with the key each child starts at and the length of the prefix every key
of that child shares (which the child leaves out); leaf nodes list keys,
each with its value inline or as a reference (data file, offset, length).
Keys are prefix-compressed against the key before them within a node.

A database that several processes wrote (a multi-process JAX save) has
``ocdbt.process_<i>/`` sub-databases beside the root; the root's nodes
reference their data files by paths relative to the root directory, so the
reader follows the root and never lists the process directories.

zstd bodies go through the native decoder (``native.zstd_decompress``),
which has no Python fallback.
"""
from __future__ import annotations

import os.path as osp
import struct
from typing import Iterator, Optional

from ..native import crc32c, zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# the offset and length of the root of an empty tree
EMPTY_REF = (1 << 64) - 1
MANIFEST_KINDS = ("single", "numbered")


class OcdbtError(ValueError):
    """A file of the database does not parse, or fails its checksum."""


class _Cursor:
    """Sequential reads over a body (little-endian, LEB128 varints)."""

    def __init__(self, buf: bytes, what: str):
        self.b = buf
        self.p = 0
        self.what = what

    def fail(self, msg: str):
        raise OcdbtError(f"{self.what}: {msg} (at byte {self.p} of {len(self.b)})")

    def take(self, n: int) -> bytes:
        if n < 0 or self.p + n > len(self.b):
            self.fail(f"truncated ({n} bytes wanted)")
        out = self.b[self.p:self.p + n]
        self.p += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _body(buf: bytes, magic: int, what: str, limit: int) -> bytes:
    """The body of a manifest or node file: header checked, checksum
    checked, decompressed."""
    if len(buf) < 18:
        raise OcdbtError(f"{what}: {len(buf)} bytes is too short")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic 0x{got_magic:08x}, expected 0x{magic:08x}")
    if length != len(buf):
        raise OcdbtError(f"{what}: header says {length} bytes, the file has {len(buf)}")
    want = struct.unpack("<I", buf[-4:])[0]
    if crc32c(buf[:-4]) != want:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    c = _Cursor(buf[:-4], what)
    c.p = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (this reader knows 0)")
    rest = buf[c.p:-4]
    if compression == 0:
        return rest
    if compression == 1:
        return zstd_decompress(rest, limit)
    raise OcdbtError(f"{what}: compression format {compression} (0 none, 1 zstd known)")


def _data_files(c: _Cursor) -> list:
    """A data file table: each file's path relative to the database root,
    prefix-compressed against the path before it."""
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
            c.fail("inconsistent data file table")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        path = prev.decode()
        if osp.isabs(path) or ".." in path.split("/"):
            c.fail(f"data file path {path!r} leaves the database")
        paths.append(path)
    return paths


def _keys(c: _Cursor, n: int) -> tuple:
    """The prefix and suffix lengths of ``n`` keys; the suffix bytes follow
    later in the node."""
    return [0] + c.varints(max(n - 1, 0)), c.varints(n)


def _key_bytes(c: _Cursor, prefix: list, suffix: list) -> list:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            c.fail("key prefix longer than the key before it")
        prev = prev[:p] + c.take(s)
        keys.append(prev)
    return keys


class OcdbtReader:
    """The newest version of the OCDBT database at ``root`` (a single
    manifest, as orbax writes): ``keys()``, ``read(key)``, ``get(key)`` and
    ``items()`` (in key order). Keys are str (or bytes); values bytes. The
    tree is walked once, at the first use; values are read when asked
    for."""

    def __init__(self, root: str):
        self.root = osp.abspath(root)
        self.config, self.generation, self._root_ref = self._manifest()
        self._index: Optional[dict] = None

    # --- manifest -------------------------------------------------------------
    def _manifest(self):
        path = osp.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            buf = f.read()
        c = _Cursor(_body(buf, MANIFEST_MAGIC, path, 1 << 30), path)
        config = self._config(c)
        if config["manifest_kind"] != "single":  # orbax writes single manifests
            c.fail(f"manifest kind {config['manifest_kind']!r} (single is read)")
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            c.fail("no version")
        gens = c.varints(n)
        heights = [c.u8() for _ in range(n)]
        file_ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        [c.u64() for _ in range(n)]  # commit times
        # the older versions (version tree nodes) follow; the newest is inline
        i = max(range(n), key=gens.__getitem__)
        if offsets[i] == EMPTY_REF:
            return config, gens[i], None
        if file_ids[i] >= len(files):
            c.fail(f"root in data file {file_ids[i]} of {len(files)}")
        return config, gens[i], (files[file_ids[i]], offsets[i], lengths[i], heights[i])

    @staticmethod
    def _config(c: _Cursor) -> dict:
        uuid = c.take(16).hex()
        kind = c.varint()
        if kind >= len(MANIFEST_KINDS):
            c.fail(f"manifest kind {kind}")
        cfg = dict(uuid=uuid, manifest_kind=MANIFEST_KINDS[kind],
                   max_inline_value_bytes=c.varint(), max_decoded_node_bytes=c.varint(),
                   version_tree_arity_log2=c.u8())
        method = c.varint()
        if method == 1:
            cfg["compression"] = {"id": "zstd", "level": c.i32()}
        elif method == 0:
            cfg["compression"] = None
        else:
            c.fail(f"compression method {method}")
        return cfg

    # --- tree -------------------------------------------------------------------
    def _read_file(self, path: str, offset: int, length: int) -> bytes:
        full = osp.join(self.root, path)
        with open(full, "rb") as f:
            f.seek(offset)
            buf = f.read(length)
        if len(buf) != length:
            raise OcdbtError(f"{full}: {length} bytes at {offset} wanted, {len(buf)} there")
        return buf

    def _node(self, ref, height: int, prefix: bytes, index: dict) -> None:
        path, offset, length, _ = ref
        what = f"{osp.join(self.root, path)}@{offset}"
        body = _body(self._read_file(path, offset, length), NODE_MAGIC, what,
                     self.config["max_decoded_node_bytes"] or (1 << 30))
        c = _Cursor(body, what)
        if c.u8() != height:
            c.fail(f"node height is not the {height} its parent gives")
        files = _data_files(c)
        n = c.varint()
        kp, ks = _keys(c, n)

        def file(i):
            if i >= len(files):
                c.fail(f"data file {i} of {len(files)}")
            return files[i]

        if height > 0:
            common = c.varints(n)
            keys = _key_bytes(c, kp, ks)
            ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # statistics
            if c.p != len(body):
                c.fail("bytes after the last entry")
            for key, k, i, o, ln in zip(keys, common, ids, offs, lens):
                if k > len(key):
                    c.fail("subtree prefix longer than its key")
                self._node((file(i), o, ln, height - 1), height - 1, prefix + key[:k], index)
            return
        keys = _key_bytes(c, kp, ks)
        lens = c.varints(n)
        kinds = [c.u8() for _ in range(n)]
        if any(k > 1 for k in kinds):
            c.fail(f"value kinds {sorted(set(kinds))} (0 inline, 1 indirect known)")
        n_ref = sum(kinds)
        ids, offs = c.varints(n_ref), c.varints(n_ref)
        refs = iter(zip(ids, offs))
        for key, ln, kind in zip(keys, lens, kinds):
            if kind:
                i, o = next(refs)
                index[prefix + key] = (file(i), o, ln)
            else:
                index[prefix + key] = c.take(ln)
        if c.p != len(body):
            c.fail("bytes after the last value")

    def _entries(self) -> dict:
        if self._index is None:
            index: dict = {}
            if self._root_ref is not None:
                self._node(self._root_ref, self._root_ref[3], b"", index)
            self._index = dict(sorted(index.items()))
        return self._index

    # --- interface -----------------------------------------------------------------
    @staticmethod
    def _key(key) -> bytes:
        return key.encode() if isinstance(key, str) else bytes(key)

    def keys(self) -> list:
        """Every key, in order, as str."""
        return [k.decode() for k in self._entries()]

    def get(self, key) -> Optional[bytes]:
        """The value of ``key``, or None when the database lacks it."""
        value = self._entries().get(self._key(key))
        if value is None or isinstance(value, bytes):
            return value
        return self._read_file(*value)

    def read(self, key) -> bytes:
        """The value of ``key``; KeyError when the database lacks it."""
        value = self.get(key)
        if value is None:
            raise KeyError(f"{self.root}: no key {key!r}")
        return value

    def items(self) -> Iterator[tuple]:
        """(key as str, value) in key order."""
        for k in self._entries():
            yield k.decode(), self.get(k)
