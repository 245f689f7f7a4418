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

In a gang of ranks only rank 0 writes (the step checkpoints, the link and
its removal); every rank may read. JAX weights still come across through
``io/from_jax.py``.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Optional

import torch

from ..parallel.mesh import rank


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


def load_checkpoint(path: str) -> Any:
    """The saved tree, tensors on the CPU."""
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
        if step == 0 or step % self.save_freq != 0:
            return None
        return self.save(step, tree)

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


def _flat_params(raw: Any, prefix: str = "model.") -> dict:
    """name -> tensor from a train-state checkpoint (its 'trainable' dict)
    or a plain state dict, with a leading ``prefix`` stripped."""
    flat = raw["trainable"] if isinstance(raw, dict) and "trainable" in raw else raw
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in flat.items()}


def load_model_params(path: str, model: torch.nn.Module, fallback_path: Optional[str] = None,
                      strict: Optional[bool] = None) -> list[str]:
    """Three-tier load into ``model``'s parameters: the names found in
    ``path`` (``model.`` prefix stripped), then those still missing from
    ``fallback_path``; strict (the default when there is no fallback)
    raises KeyError if any parameter is left unfilled, otherwise those keep
    their current values. Returns the unfilled names."""
    if strict is None:
        strict = fallback_path is None
    params = dict(model.named_parameters())
    sources = [_flat_params(load_checkpoint(path))]
    if fallback_path is not None:
        sources.append(_flat_params(load_checkpoint(fallback_path)))
    missing = []
    with torch.no_grad():
        for name, p in params.items():
            src = next((s for s in sources if name in s), None)
            if src is None:
                missing.append(name)
                continue
            if tuple(src[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src[name].shape)} != {tuple(p.shape)}")
            p.copy_(src[name].to(dtype=p.dtype))
    if missing and strict:
        raise KeyError(f"missing {len(missing)} params, e.g. {missing[:5]}")
    return missing
