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
parameter names (``train_state_from_jax`` does the same for a whole JAX
train state, optimizer moments included):

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


# the leaves of a JAX package TrainState (vitslam_tpu/train/train_step.py),
# as flax serialises the dataclass
TRAIN_STATE_KEYS = frozenset({"trainable", "frozen", "opt_state", "step"})


def _port_tree(tree: dict) -> dict:
    """port name -> CPU tensor of a flax parameter tree (or of a tree of
    its shape: an optax moment, the accumulated gradients)."""
    return {port_name(k): as_tensor(v) for k, v in export_torch_style(tree).items()}


def _expect(node, keys: set, where: str) -> dict:
    if not isinstance(node, dict) or set(node) != keys:
        found = sorted(node) if isinstance(node, dict) else type(node).__name__
        raise KeyError(f"{where}: expected the keys {sorted(keys)}, found {found}")
    return node


def _adamw_state(chain: dict, where: str) -> dict:
    """count, mu, nu of the optax state of vitslam_tpu/train/optim.py's
    chain(clip_by_global_norm, adamw): (EmptyState, (ScaleByAdamState(count,
    mu, nu), EmptyState, ScaleByScheduleState(count)))."""
    _expect(chain, {"0", "1"}, where)
    _expect(chain["0"], set(), f"{where}/0")
    inner = _expect(chain["1"], {"0", "1", "2"}, f"{where}/1")
    adam = _expect(inner["0"], {"count", "mu", "nu"}, f"{where}/1/0")
    _expect(inner["1"], set(), f"{where}/1/1")
    schedule = _expect(inner["2"], {"count"}, f"{where}/1/2")
    if int(schedule["count"]) != int(adam["count"]):
        raise ValueError(f"{where}: the schedule's count {int(schedule['count'])} is not "
                         f"Adam's {int(adam['count'])}")
    return {"count": int(adam["count"]), "mu": _port_tree(adam["mu"]),
            "nu": _port_tree(adam["nu"])}


def train_state_from_jax(tree: dict) -> dict:
    """The port's train state (``train.Trainer.restore``'s layout) of a JAX
    package TrainState read from its checkpoint file: ``trainable`` and
    ``frozen`` by port name (kernels transposed, scanned layers split, as
    ``export_torch_style``), the optimizer's ``count``, ``mu`` and ``nu``
    (and, under ``optax.MultiSteps``, ``mini_step`` and the accumulated
    gradients ``acc``) in the same layout as their parameters, and
    ``step``. A leaf outside that structure raises KeyError naming it."""
    _expect(tree, set(TRAIN_STATE_KEYS), "train state")
    opt = tree["opt_state"]
    if isinstance(opt, dict) and "inner_opt_state" in opt:
        _expect(opt, {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                      "skip_state"}, "opt_state")
        _expect(opt["skip_state"], set(), "opt_state/skip_state")
        optimizer = _adamw_state(opt["inner_opt_state"], "opt_state/inner_opt_state")
        if int(opt["gradient_step"]) != optimizer["count"]:
            raise ValueError(f"opt_state: gradient_step {int(opt['gradient_step'])} is not "
                             f"Adam's count {optimizer['count']}")
        optimizer.update(mini_step=int(opt["mini_step"]), acc=_port_tree(opt["acc_grads"]))
    else:
        optimizer = dict(_adamw_state(opt, "opt_state"), mini_step=0, acc=None)
    return {"trainable": _port_tree(tree["trainable"]), "frozen": _port_tree(tree["frozen"]),
            "optimizer": optimizer, "step": int(tree["step"])}
