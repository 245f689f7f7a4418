"""Reader of the checkpoint directories the JAX package writes with
``checkpoint.backend: orbax`` (vitslam_tpu/io/orbax_ckpt.py, orbax's
``PyTreeCheckpointer``), for a process that holds no template and imports
neither orbax nor tensorstore: ``read_orbax(path)`` gives the tree as
nested dicts, the counterpart of the JAX package's ``load_sharded``.

Layout of such a directory:

* ``_METADATA`` (JSON): the tree as key paths, each key a dict key
  (``key_type`` 2) or a sequence index (1), with the leaf's ``value_type``;
* ``manifest.ocdbt`` and ``d/``: an OCDBT key-value store (``io/ocdbt.py``),
  whose sub-databases ``ocdbt.process_<i>/`` hold what each process wrote;
* in the store, each array as zarr v2 under the leaf's path joined by ".":
  ``<name>/.zarray`` (JSON: shape, chunks, dtype, compressor, fill value,
  order) and one value per chunk, ``<name>/<i>.<j>...`` (``0`` for a 0-d
  array), each chunk's bytes a zstd frame holding the whole chunk in C
  order, edge chunks padded.

The tree comes back as the flax msgpack reader gives it
(``io/flax_msgpack.py``), so ``from_jax.train_state_from_jax`` reads both:
every key a string (sequence indices too), arrays as numpy arrays (bf16 as
``torch.bfloat16`` tensors, numpy having no bf16), a saved scalar as the
Python scalar orbax restores, and the leaves orbax skips (``None``, optax's
empty states, an empty tuple) as ``{}``. A chunk
the store lacks takes the fill value (zero when it is null). A compressor
other than zstd or none, a filter, Fortran order or an unknown dtype raise,
naming the array.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import os.path as osp
from typing import Any

import numpy as np
import torch

from ..native import zstd_decompress_into
from .ocdbt import OcdbtReader

# zarr v2 dtype strings the reader takes (bfloat16 comes back as torch's)
DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
          "|u1": np.uint8, "|b1": np.bool_, "bfloat16": np.uint16}
# array leaves; every other value type is one orbax skips (None, an empty
# optax state, an empty tuple)
ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")


def is_orbax_dir(path: str) -> bool:
    """An orbax PyTree checkpoint on OCDBT: a directory holding
    ``manifest.ocdbt`` and ``_METADATA``."""
    return osp.isdir(path) and all(osp.isfile(osp.join(path, f))
                                   for f in ("manifest.ocdbt", "_METADATA"))


def _zarray(kv: OcdbtReader, name: str) -> dict:
    meta = json.loads(kv.read(f"{name}/.zarray"))
    where = f"array {name!r}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr format {meta.get('zarr_format')} (2 is read)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp!r} (zstd or none is read)")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']!r} (none is read)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: order {meta['order']!r} (C is read)")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{where}: dtype {meta.get('dtype')!r} (read: {sorted(DTYPES)})")
    return meta


def read_array(kv: OcdbtReader, name: str):
    """The zarr v2 array ``name`` of the store: a numpy array (a
    ``torch.bfloat16`` tensor for bf16), every chunk placed."""
    meta = _zarray(kv, name)
    dtype = np.dtype(DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"]) or ()
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    buf = np.empty(math.prod(chunks), dtype)
    for idx in itertools.product(*map(range, grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        data = kv.get(key)
        if data is None:
            out[region] = 0 if fill is None else fill
            continue
        if meta.get("compressor") is None:
            if len(data) != buf.nbytes:
                raise ValueError(f"array {name!r}: chunk {key} holds {len(data)} bytes, "
                                 f"{buf.nbytes} expected")
            buf.view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        else:
            try:
                zstd_decompress_into(data, buf.view(np.uint8))
            except ValueError as e:
                raise ValueError(f"array {name!r}, chunk {key}: {e}") from None
        chunk = buf.reshape(chunks)
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def read_orbax(path: str) -> dict:
    """The tree of the orbax checkpoint directory ``path`` as nested dicts
    (see the module's docstring)."""
    path = osp.realpath(path)
    if not is_orbax_dir(path):
        raise ValueError(f"{path}: not an orbax checkpoint (manifest.ocdbt and _METADATA)")
    with open(osp.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                         f"{meta.get('use_zarr3')} (OCDBT with zarr v2 is read)")
    kv = OcdbtReader(path)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if any(k["key_type"] not in (1, 2) for k in entry["key_metadata"]):
            raise ValueError(f"{path}: leaf {keys}: key types "
                             f"{[k['key_type'] for k in entry['key_metadata']]} (1, 2 read)")
        value = entry["value_metadata"]
        if value["value_type"] in ARRAY_TYPES:
            leaf: Any = read_array(kv, ".".join(keys))
            if value["value_type"] == "scalar":  # a Python or numpy scalar, as orbax restores it
                leaf = leaf.item()
        elif value.get("skip_deserialize"):
            leaf = {}
        else:
            raise ValueError(f"{path}: leaf {keys} of value type {value['value_type']!r}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def orbax_nbytes(path: str) -> int:
    """Bytes of the files under an orbax checkpoint directory."""
    return sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(osp.realpath(path))
               for f in fs)
