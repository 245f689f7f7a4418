"""Reader of the JAX package's checkpoint files (``flax.serialization.
to_bytes``, written by vitslam_tpu/io/checkpoint.py::save_checkpoint) in
Python and numpy alone: neither flax nor the ``msgpack`` package is needed.

It decodes the subset of msgpack that flax writes: maps (fixmap, map16,
map32), arrays, str, bin, the int, float, nil and bool types, and flax's
ext types (``flax/serialization.py::_MsgpackExtType``):

* 1, ndarray: a msgpack triple (shape, dtype name, C-order bytes);
* 2, native complex: a msgpack pair (real, imag);
* 3, numpy scalar: an ndarray of shape () handed back as its scalar.

Arrays are ``np.frombuffer`` views of the file's bytes (read into one
writable buffer), with no copy. numpy has no bfloat16: such a leaf is read
as uint16 and handed back as a ``torch.bfloat16`` tensor viewing the same
bytes. flax splits a leaf above ``MAX_CHUNK_SIZE`` (2**30) bytes into a
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` map;
those are joined back into one array. Anything outside the subset raises
ValueError naming the byte offset.
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# fixed-width scalars: first byte -> struct format
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed: first byte -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    """msgpack values from ``buf[pos:end]``; bin values are bytes, or with
    ``raw_bin`` memoryview slices of ``buf`` (an ndarray's data)."""

    def __init__(self, buf: memoryview, pos: int = 0, end: int | None = None,
                 raw_bin: bool = False):
        self.buf, self.pos, self.raw_bin = buf, pos, raw_bin
        self.end = len(buf) if end is None else end

    def _take(self, n: int, at: int) -> memoryview:
        if self.pos + n > self.end:
            raise ValueError(f"truncated msgpack value at byte offset {at}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str, at: int):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt), at))[0]

    def value(self) -> Any:
        at = self.pos
        b = self._take(1, at)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self._take(b & 0x1f, at), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self._unpack(_SCALARS[b], at)
        if b in _FIXEXT:
            code = self._unpack(">b", at)
            return self._ext(code, _FIXEXT[b], at)
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self._unpack(fmt, at)
            if kind == "bin":
                data = self._take(n, at)
                return data if self.raw_bin else bytes(data)
            if kind == "str":
                return str(self._take(n, at), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(self._unpack(">b", at), n, at)
        raise ValueError(f"msgpack type byte 0x{b:02x} at byte offset {at} is not one that "
                         "flax writes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, code: int, n: int, at: int):
        start = self.pos
        self._take(n, at)
        inner = _Decoder(self.buf, start, start + n, raw_bin=True)
        if code == _EXT_NDARRAY:
            out = inner._ndarray(at)
        elif code == _EXT_NPSCALAR:
            arr = inner._ndarray(at)
            out = arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        elif code == _EXT_COMPLEX:
            real, imag = inner.value()
            out = complex(real, imag)
        else:
            raise ValueError(f"msgpack ext type {code} at byte offset {at} is not one of "
                             "flax's (1 ndarray, 2 complex, 3 numpy scalar)")
        if inner.pos != inner.end:
            raise ValueError(f"ext value at byte offset {at} has {inner.end - inner.pos} "
                             "trailing bytes")
        return out

    def _ndarray(self, at: int):
        """flax's (shape, dtype name, bytes) triple."""
        triple = self.value()
        if not (isinstance(triple, list) and len(triple) == 3
                and isinstance(triple[2], memoryview)):
            raise ValueError(f"ndarray ext at byte offset {at} is not a (shape, dtype, bytes) "
                             "triple")
        shape, name, data = triple
        name = name if isinstance(name, str) else bytes(name).decode("ascii")
        bf16 = name == "bfloat16"
        try:
            dtype = np.dtype(np.uint16 if bf16 else name)
        except TypeError as e:
            raise ValueError(f"ndarray ext at byte offset {at}: unknown dtype {name!r}") from e
        if dtype.hasobject or len(data) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"ndarray ext at byte offset {at}: {len(data)} bytes do not hold "
                             f"{name} of shape {tuple(shape)}")
        arr = np.frombuffer(data, dtype=dtype).reshape(shape)
        return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr


def _unchunk(tree):
    """Join flax's chunked leaves back into arrays (in every nested map)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """The tree a flax msgpack byte string holds (``msgpack_restore``'s
    result; arrays view ``data``, which should be writable)."""
    dec = _Decoder(memoryview(data))
    tree = dec.value()
    if dec.pos != len(dec.buf):
        raise ValueError(f"trailing bytes after the msgpack value at byte offset {dec.pos}")
    return _unchunk(tree)


def read_flax_msgpack(path: str) -> Any:
    """The tree a flax msgpack checkpoint file holds; its arrays view one
    buffer holding the whole file."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view, got = memoryview(buf), 0
        while got < len(buf):
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: file ended at byte {got} of {len(buf)}")
            got += n
    return loads(buf)
