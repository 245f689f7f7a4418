"""Sharded (multi-rank) checkpoints on ``torch.distributed.checkpoint``
(DCP), with the reference's crash-resume semantics on top (port of
vitslam_tpu/io/orbax_ckpt.py, the ``checkpoint.backend: orbax`` choice).

The msgpack path (``io/checkpoint.py``) gathers the whole train state and
writes it on rank 0. Here every rank writes what it holds: a tensor split
over the mesh's ``model`` axis (``parallel.shard_params_model``) is handed
to DCP as a ``DTensor`` of this rank's slice over a ``DeviceMesh`` of the
same ranks and axes, so each slice is written once, and a load reshards to
the mesh of the loading process (saved at model = 2, loaded at model = 1,
or at data = 2, bit-equal). A plain tensor under the same key on every rank
is one replicated tensor to DCP (written once): that is right for a
replicated tensor and wrong for a slice, which is why slices go as
``DTensor``. Ints and floats are saved as they are.

Kept from the reference's contract (orbax_ckpt.py):
  * step checkpoints ``<exp>_step<k>.orbax`` (directories, not files);
  * a stable ``_latest_checkpoints/<exp>.orbax`` link updated on every save
    (on rank 0), resumed from on restart (a dangling link is removed),
    deleted on a clean ``finish()``;
  * the ``keep`` most recent kept.

Every rank calls save and load (DCP plans them together); outside a gang
they run in this process alone.

The resume target may also be a directory the JAX package wrote under the
same names (orbax on OCDBT: ``manifest.ocdbt`` and ``_METADATA``, where a
DCP directory has ``.metadata``). ``restore`` refuses it: such a state is
read whole by ``io.checkpoint.load_checkpoint`` and loaded by
``Trainer.restore`` (``Trainer.init_state`` tells the two apart).
"""
from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import ModelShards, rank, sync_global_devices
from .orbax_format import is_orbax_dir


def _device_mesh(mesh, device_type: str):
    """The DeviceMesh over the (data, model) rank grid of ``mesh``, on its
    axis groups (no new process group)."""
    from torch.distributed.device_mesh import DeviceMesh

    n_data, n_model = mesh.size("data"), mesh.size("model")
    return DeviceMesh.from_group([mesh.group("data"), mesh.group("model")], device_type,
                                 mesh=torch.arange(n_data * n_model).view(n_data, n_model),
                                 mesh_dim_names=("data", "model"))


def as_dtensors(tensors: dict, shards: Optional[ModelShards]) -> dict:
    """name -> tensor with each tensor of a sharded name (this rank's slice
    of a parameter, or of a tensor of its shape) as a DTensor split along
    its dim over the model axis and replicated over the data axis; the
    other tensors as they are. The DTensors view the given tensors, so a
    load into them fills those in place."""
    if shards is None or not shards.dims:
        return dict(tensors)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    device_mesh = None
    out = {}
    for name, t in tensors.items():
        if name in shards.dims:
            if device_mesh is None:
                device_mesh = _device_mesh(shards.mesh, t.device.type)
            t = DTensor.from_local(t, device_mesh, [Replicate(), Shard(shards.dims[name])],
                                   run_check=False)
        out[name] = t
    return out


def _no_dist() -> bool:
    return not (dist.is_available() and dist.is_initialized())


def save_sharded(path: str, tree: dict) -> str:
    """Collectively write ``tree`` (nested dicts of tensors, DTensors from
    ``as_dtensors``, ints and floats) to the directory ``path``, replacing
    one that is there."""
    path = osp.abspath(path)
    if rank() == 0 and osp.exists(path):
        shutil.rmtree(path)
    sync_global_devices("sharded-save-start")
    import torch.distributed.checkpoint as dcp

    dcp.save(tree, checkpoint_id=path, no_dist=_no_dist())
    return path


def load_sharded(path: str, template: dict) -> dict:
    """Collectively read the directory ``path`` into ``template``: each
    tensor (or DTensor: this rank's slice) is filled in place from the
    saved tensor of its key, whatever the mesh it was saved from; each int
    or float is replaced by the saved value. Returns ``template``. A key
    the checkpoint lacks raises."""
    import torch.distributed.checkpoint as dcp

    dcp.load(template, checkpoint_id=osp.abspath(path), no_dist=_no_dist())
    return template


class ShardedCheckpointManager:
    """Sibling of ``io.checkpoint.CheckpointManager`` backed by sharded
    saves (the same save_freq / keep / ``_latest`` link / resume / finish
    contract; paths are directories)."""

    def __init__(self, save_dir: str, exp_name: str, save_freq: int = 500, keep: int = 3):
        self.save_dir = save_dir
        self.exp_name = exp_name
        self.save_freq = save_freq
        self.keep = keep
        self.latest_dir = osp.join(save_dir, "_latest_checkpoints")
        self._saved: list[str] = []

    @property
    def latest_link(self) -> str:
        return osp.join(self.latest_dir, f"{self.exp_name}.orbax")

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        """``save`` at a multiple of save_freq; ``tree`` may be a function
        returning the tree, called only then."""
        if step == 0 or step % self.save_freq != 0:
            return None
        return self.save(step, tree() if callable(tree) else tree)

    def save(self, step: int, tree: dict) -> str:
        """Every rank writes its part; rank 0 moves the link and prunes."""
        path = osp.join(self.save_dir, f"{self.exp_name}_step{step}.orbax")
        if rank() == 0:
            os.makedirs(self.save_dir, exist_ok=True)
        path = save_sharded(path, tree)
        if rank() == 0:
            os.makedirs(self.latest_dir, exist_ok=True)
            if osp.islink(self.latest_link) or osp.exists(self.latest_link):
                os.remove(self.latest_link)
            os.symlink(path, self.latest_link)
            self._saved.append(path)
            while len(self._saved) > self.keep:
                old = self._saved.pop(0)
                if osp.isdir(old):
                    shutil.rmtree(old, ignore_errors=True)
        sync_global_devices("sharded-save-done")
        return path

    def resume_path(self) -> Optional[str]:
        """The resume target, or None; rank 0 removes a dangling link."""
        link = self.latest_link
        if osp.islink(link):
            if osp.exists(link):
                return link
            if rank() == 0:
                os.remove(link)
            return None
        return link if osp.isdir(link) else None

    def restore(self, template: dict) -> Optional[dict]:
        """``load_sharded`` of the resume target (a DCP directory) into
        ``template``; None without a target. A JAX package's orbax
        directory raises: it is a whole train state for ``Trainer.restore``
        (through ``io.checkpoint.load_checkpoint``), not a template's load."""
        path = self.resume_path()
        if path is None:
            return None
        path = osp.realpath(path)
        if is_orbax_dir(path):
            raise ValueError(f"{path}: a JAX package orbax checkpoint; load it with "
                             "Trainer.restore(io.checkpoint.load_checkpoint(path))")
        return load_sharded(path, template)

    def finish(self):
        """Delete the resume link on a clean finish."""
        if rank() == 0 and (osp.islink(self.latest_link) or osp.exists(self.latest_link)):
            os.remove(self.latest_link)
