"""Load weights exported from the JAX package into the port.

``load_jax_params`` takes the flat dict that
``vitslam_tpu.io.torch_convert.export_torch_style(params)`` returns: scanned
layers are already split into ``<prefix>.<i>.`` entries and Linear/Conv
kernels are already in torch layout, but the leaf names are flax's. The
loader maps them onto the port's parameter names:

* a leading ``params.`` (the flax variable collection) is dropped;
* ``kernel`` -> ``weight``; LayerNorm ``scale`` -> ``weight``;
* the patch embedding's scanned ``blocks.<i>.block.`` -> ``blocks.<i>.``
  (the port's ModuleList index; the aggregator's ``layers.<i>.`` maps as is).
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight"}


def port_name(jax_key: str) -> str:
    """The port's parameter name for an exported flax key."""
    key = jax_key[len("params."):] if jax_key.startswith("params.") else jax_key
    key = re.sub(r"\.blocks\.(\d+)\.block\.", r".blocks.\1.", key)
    head, _, leaf = key.rpartition(".")
    leaf = _LEAF.get(leaf, leaf)
    return f"{head}.{leaf}" if head else leaf


def load_jax_params(module: nn.Module, flat: dict, strict: bool = True) -> list[str]:
    """Copy exported JAX weights into ``module``'s parameters (converted to
    each parameter's dtype and device). In strict mode every key must be used
    and every parameter filled; otherwise returns the unfilled names."""
    params = dict(module.named_parameters())
    unused, filled = [], set()
    with torch.no_grad():
        for key, value in flat.items():
            name = port_name(key)
            p = params.get(name)
            if p is None:
                unused.append(key)
                continue
            arr = np.asarray(value)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key} -> {name}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=p.dtype))
            filled.add(name)
    missing = sorted(set(params) - filled)
    if strict and (unused or missing):
        raise KeyError(f"unused keys {unused[:5]} ({len(unused)}), "
                       f"unfilled params {missing[:5]} ({len(missing)})")
    return missing
