"""Checkpoints with the reference's crash-resume semantics (port of
vitslam_tpu/io/checkpoint.py), in the port's own format: ``torch.save`` of
a dict of CPU tensors, ints and nested dicts (a train state holds the
trainable tensors by name, the optimizer state and the step).

* step checkpoints named ``<exp>_step<k>.ckpt`` (the last ``keep`` kept);
* a stable ``_latest_checkpoints/<exp>.ckpt`` link updated at every save,
  resumed from on restart (a dangling link is removed, not followed), and
  deleted on a clean finish;
* ``load_model_params``: an explicit checkpoint with a ``model.`` prefix
  stripped, a fallback checkpoint filling the names it lacks, then a strict
  check that every parameter was filled.

Both readers also take the JAX package's files (flax msgpack, written by
vitslam_tpu/io/checkpoint.py::save_checkpoint), told apart by their first
bytes: a ``torch.save`` file is a zip archive, a flax file starts with a
msgpack map. For ``load_model_params`` a flax file's variable tree, with a
leading ``model`` key stripped as the reference strips ``model/``, goes
through ``from_jax.export_torch_style`` and ``port_name``; either tier may
be in either format (e.g. a head the reference trained over a backbone
saved by the port). ``load_checkpoint`` also reads the reference's whole
train state (trainable and frozen tensors, optax's AdamW moments, the
accumulated gradients, the step) into the port's layout, for a resume.

In a gang of ranks only rank 0 writes (the step checkpoints, the link and
its removal); every rank may read.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Optional

import torch

from ..parallel.mesh import rank
from .flax_msgpack import read_flax_msgpack
from .from_jax import (
    TRAIN_STATE_KEYS,
    as_tensor,
    export_flat,
    flatten_tree,
    port_name,
    train_state_from_jax,
)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, tree: Any) -> str:
    """Write ``tree`` (tensors moved to the host) to ``path`` atomically."""
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, path)
    return path


def checkpoint_format(path: str) -> str:
    """"torch" (a ``torch.save`` zip archive) or "flax" (msgpack, whose
    top-level value is a map), from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "flax"
    raise ValueError(f"{path}: neither a torch.save archive nor a flax msgpack file "
                     f"(first bytes {head!r})")


def load_checkpoint(path: str) -> Any:
    """The saved tree on the CPU: a ``torch.save`` file's as saved; a flax
    file's as nested dicts of numpy arrays (bf16 leaves as tensors), except
    that a JAX package train state comes in the port's train-state layout
    (``from_jax.train_state_from_jax``), for a Trainer to resume from."""
    if checkpoint_format(path) == "flax":
        tree = read_flax_msgpack(path)
        if isinstance(tree, dict) and set(tree) == TRAIN_STATE_KEYS:
            return train_state_from_jax(tree)
        return tree
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Step checkpoints + the stable ``_latest_checkpoints/<exp>.ckpt``
    resume link."""

    def __init__(self, save_dir: str, exp_name: str, save_freq: int = 500, keep: int = 3):
        self.save_dir = save_dir
        self.exp_name = exp_name
        self.save_freq = save_freq
        self.keep = keep
        self.latest_dir = osp.join(save_dir, "_latest_checkpoints")
        self._saved: list[str] = []

    @property
    def latest_link(self) -> str:
        return osp.join(self.latest_dir, f"{self.exp_name}.ckpt")

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        """``save`` at a multiple of save_freq; ``tree`` may be a function
        returning the tree, called only then (on every rank: under tensor
        parallelism it gathers)."""
        if step == 0 or step % self.save_freq != 0:
            return None
        return self.save(step, tree() if callable(tree) else tree)

    def save(self, step: int, tree: Any) -> str:
        if rank() != 0:
            return ""
        path = osp.join(self.save_dir, f"{self.exp_name}_step{step}.ckpt")
        save_checkpoint(path, tree)
        os.makedirs(self.latest_dir, exist_ok=True)
        if osp.islink(self.latest_link) or osp.exists(self.latest_link):
            os.remove(self.latest_link)
        os.symlink(osp.abspath(path), self.latest_link)
        self._saved.append(path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            if osp.exists(old):
                os.remove(old)
        return path

    def resume_path(self) -> Optional[str]:
        """The resume target, or None; a dangling link is removed."""
        link = self.latest_link
        if osp.islink(link):
            if osp.exists(link):
                return link
            os.remove(link)
            return None
        return link if osp.exists(link) else None

    def finish(self):
        """Delete the resume link on a clean finish."""
        if rank() == 0 and (osp.islink(self.latest_link) or osp.exists(self.latest_link)):
            os.remove(self.latest_link)


def _flat_params(path: str) -> dict:
    """The port's parameter name -> tensor of a checkpoint: a port train
    state's 'trainable' dict or a port state dict with a leading ``model.``
    stripped, or a flax variable tree with a leading ``model`` stripped."""
    raw = load_checkpoint(path)
    if checkpoint_format(path) == "flax":
        flat = {(p[1:] if p[0] == "model" and len(p) > 1 else p): v
                for p, v in flatten_tree(raw).items()}
        return {port_name(k): as_tensor(v) for k, v in export_flat(flat).items()}
    flat = raw["trainable"] if isinstance(raw, dict) and "trainable" in raw else raw
    return {(k[len("model."):] if k.startswith("model.") else k): v for k, v in flat.items()}


def load_model_params(path: str, model: torch.nn.Module, fallback_path: Optional[str] = None,
                      strict: Optional[bool] = None) -> list[str]:
    """Three-tier load into ``model``'s parameters: the names found in
    ``path`` (``model.`` / ``model/`` prefix stripped), then those still
    missing from ``fallback_path``; either file a port or a flax
    checkpoint. Strict (the default when there is no fallback) raises
    KeyError if any parameter is left unfilled, otherwise those keep their
    current values. Returns the unfilled names."""
    if strict is None:
        strict = fallback_path is None
    params = dict(model.named_parameters())
    missing = list(params)
    for source in (path, fallback_path):
        if source is None or not missing:
            continue
        flat = _flat_params(source)
        with torch.no_grad():
            for name in [n for n in missing if n in flat]:
                p, t = params[name], flat[name]
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(p.shape)}")
                p.copy_(t)
        missing = [n for n in missing if n not in flat]
        del flat
    if missing and strict:
        raise KeyError(f"missing {len(missing)} params, e.g. {missing[:5]}")
    return missing
