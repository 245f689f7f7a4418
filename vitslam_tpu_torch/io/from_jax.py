"""Load weights exported from the JAX package into the port.

``export_torch_style`` (the port's copy of the layout half of
vitslam_tpu/io/torch_convert.py) flattens a flax variable tree, nested
dicts of arrays as the reference's checkpoint files hold them
(``io/flax_msgpack.py``): scanned layers (a leading depth axis under a
``layers`` or ``blocks`` key) are split into ``<prefix>.<i>.`` entries and
Dense (in, out) / Conv (kh, kw, in, out) kernels are transposed into
torch's (out, in) / (out, in, kh, kw) layout, under '.'-joined flax names.
``load_jax_params`` takes that flat dict (or the JAX package's own
``export_torch_style`` output) and maps the flax names onto the port's
parameter names:

* a leading ``params.`` (the flax variable collection) is dropped;
* ``kernel`` -> ``weight``; LayerNorm ``scale`` -> ``weight``;
* the patch embedding's scanned ``blocks.<i>.block.`` -> ``blocks.<i>.``
  (the port's ModuleList index; the aggregator's ``layers.<i>.`` maps as is);
* the track head's numbered flax modules ``time_blocks_<i>``,
  ``space_{point2virtual,virtual,virtual2point}_blocks_<i>``,
  ``ffeat_updater_0``, ``vis_predictor_0`` and ``conf_predictor_0`` ->
  ``<name>.<i>`` (ModuleList / Sequential indices, the VGGT-1B checkpoint's
  names); its GroupNorm ``scale`` -> ``weight`` like a LayerNorm's.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight"}
_SCANNED = ("layers", "blocks")
_NUMBERED = re.compile(r"(^|\.)(time_blocks|space_point2virtual_blocks|space_virtual_blocks|"
                       r"space_virtual2point_blocks|ffeat_updater|vis_predictor|"
                       r"conf_predictor)_(\d+)\.")


def flatten_tree(tree: dict, prefix: tuple = ()) -> dict:
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            out.update(flatten_tree(value, path))
        else:
            out[path] = value
    return out


def _to_torch_layout(path: tuple, x):
    if path[-1] == "kernel":
        if x.ndim == 2:
            return x.T
        if x.ndim == 4:  # (kh, kw, in, out) -> (out, in, kh, kw)
            return x.permute(3, 2, 0, 1) if isinstance(x, torch.Tensor) else \
                np.transpose(x, (3, 2, 0, 1))
    return x


def export_flat(flat: dict) -> dict:
    """``export_torch_style`` of an already flattened tree ({path: leaf})."""
    out = {}
    for path, leaf in flat.items():
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        if any(p in _SCANNED for p in path) and leaf.ndim >= 1:
            pos = max(i for i, p in enumerate(path) if p in _SCANNED)
            for i in range(leaf.shape[0]):
                key = path[:pos + 1] + (str(i),) + path[pos + 1:]
                out[".".join(key)] = _to_torch_layout(path, leaf[i])
        else:
            out[".".join(path)] = _to_torch_layout(path, leaf)
    return out


def export_torch_style(tree: dict) -> dict:
    """A flax variable tree (nested dicts of numpy arrays or bf16 tensors)
    as a flat torch-style dict: scanned layers split per layer, kernels in
    torch layout, '.'-joined flax names (views, no copies)."""
    return export_flat(flatten_tree(tree))


def as_tensor(value) -> torch.Tensor:
    """A CPU tensor of a leaf: a tensor as is, a writable numpy array as a
    view, any other array as a copy."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    return torch.from_numpy(arr) if arr.flags.writeable else torch.tensor(arr)


def port_name(jax_key: str) -> str:
    """The port's parameter name for an exported flax key."""
    key = jax_key[len("params."):] if jax_key.startswith("params.") else jax_key
    key = re.sub(r"\.blocks\.(\d+)\.block\.", r".blocks.\1.", key)
    key = _NUMBERED.sub(r"\1\2.\3.", key)
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
            t = as_tensor(value)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key} -> {name}: shape {tuple(t.shape)} != {tuple(p.shape)}")
            p.copy_(t)
            filled.add(name)
    missing = sorted(set(params) - filled)
    if strict and (unused or missing):
        raise KeyError(f"unused keys {unused[:5]} ({len(unused)}), "
                       f"unfilled params {missing[:5]} ({len(missing)})")
    return missing
