"""A reader of the safetensors format, without the safetensors package.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of a
JSON object, then the data: raw little-endian, C order. The object maps
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets``
(``[begin, end)`` relative to the data's start) and may hold
``__metadata__``, a map of strings. The tensors fill the data section
exactly: no two overlap, none leaves a gap, none runs past its end.

``read_safetensors`` maps the file into memory (copy on write: the pages
are the file's until a tensor is written to) and returns CPU tensors over
that mapping, so a 5 GB checkpoint is not read into host memory whole
before it is converted. A malformed file raises ValueError naming what is
wrong. Nothing here writes the format.
"""
from __future__ import annotations

import json
import math
import mmap
import os
import struct
import sys

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
# the safetensors package refuses a larger header
MAX_HEADER_BYTES = 100 * 2 ** 20


def _header(path: str, size: int, head: bytes) -> tuple[dict, dict, int]:
    """(entries, metadata, the data section's offset in the file) of a
    file of ``size`` bytes whose first bytes are ``head``; every entry
    checked against the data section."""
    if size < 8:
        raise ValueError(f"{path}: {size} bytes, shorter than the 8-byte header length")
    (n,) = struct.unpack("<Q", head[:8])
    if n > MAX_HEADER_BYTES:
        raise ValueError(f"{path}: header of {n} bytes, more than {MAX_HEADER_BYTES}")
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes runs past the end of a "
                         f"{size}-byte file")
    try:
        header = json.loads(head[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is a {type(header).__name__}, not an object")
    metadata = header.pop("__metadata__", None) or {}
    if not isinstance(metadata, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
        raise ValueError(f"{path}: __metadata__ is not a map of strings")
    data_bytes = size - 8 - n
    spans = []
    for name, entry in header.items():
        if not isinstance(entry, dict) or set(entry) != {"dtype", "shape", "data_offsets"}:
            raise ValueError(f"{path}: {name}: an entry holds dtype, shape and data_offsets "
                             f"alone, not {entry!r}")
        dtype = DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name}: unknown dtype {entry['dtype']!r}")
        shape, offsets = entry["shape"], entry["data_offsets"]
        if not (isinstance(shape, list) and all(type(d) is int and d >= 0 for d in shape)):
            raise ValueError(f"{path}: {name}: shape {shape!r} is not a list of sizes")
        if not (isinstance(offsets, list) and len(offsets) == 2
                and all(type(o) is int for o in offsets) and 0 <= offsets[0] <= offsets[1]):
            raise ValueError(f"{path}: {name}: data_offsets {offsets!r} is not [begin, end]")
        nbytes = math.prod(shape) * dtype.itemsize
        if offsets[1] - offsets[0] != nbytes:
            raise ValueError(f"{path}: {name}: {offsets[1] - offsets[0]} bytes for shape "
                             f"{shape} of {entry['dtype']} ({nbytes} bytes)")
        spans.append((offsets[0], offsets[1], name))
    end = 0
    for begin, stop, name in sorted(spans):
        if begin != end:
            what = "overlaps the tensor before it" if begin < end else "leaves a gap before it"
            raise ValueError(f"{path}: {name} at byte {begin} {what} (which ends at {end})")
        end = stop
    if end != data_bytes:
        raise ValueError(f"{path}: the tensors end at byte {end} of a {data_bytes}-byte "
                         "data section" + (" (past its end)" if end > data_bytes else ""))
    return header, metadata, 8 + n


def _read_header(path: str) -> tuple[dict, dict, int]:
    """``_header`` of the file at ``path``, read from its first bytes."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) == 8:
            head += f.read(min(struct.unpack("<Q", head)[0], MAX_HEADER_BYTES))
    return _header(path, size, head)


def read_metadata(path: str) -> dict:
    """The file's ``__metadata__`` (an empty dict when it has none)."""
    return _read_header(path)[1]


def read_safetensors(path: str) -> dict:
    """name -> CPU tensor of a safetensors file, in the header's order,
    each over the file's memory map (no copy)."""
    if sys.byteorder != "little":
        raise ValueError("safetensors data is little-endian; this host is not")
    entries, _, start = _read_header(path)
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, entry in entries.items():
        dtype, shape = DTYPES[entry["dtype"]], entry["shape"]
        begin, stop = entry["data_offsets"]
        if stop == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(mapped, dtype=dtype, count=(stop - begin) // dtype.itemsize,
                                     offset=start + begin).reshape(shape)
    return out
