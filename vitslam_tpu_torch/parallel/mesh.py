"""Rank grid and collectives on ``torch.distributed`` (port of
vitslam_tpu/parallel/mesh.py).

The JAX package lays its devices out as a (data, model) mesh and lets XLA
insert the collectives. Here one process runs per GPU (or per CPU rank with
the gloo backend), and a ``Mesh`` is the same (data, model) grid over the
ranks of the default process group, with one process group per axis for
this rank: rank r sits at (r // n_model, r % n_model), as the JAX package
reshapes its device list. Batches are split over ``data`` by
``shard_batch``. Parameters are replicated, or under tensor parallelism
(``shard_params_model``) split over ``model`` by ``model_partition_spec``:
each rank holds its slice, and every read of the parameter all-gathers it.

A JAX process is a host, and its local devices form its part of the mesh.
Here the ranks of one node stand for the devices of one JAX process:
``node_index()`` is the counterpart of ``jax.process_index()``, read from
``LOCAL_WORLD_SIZE`` (the ranks per node, torchrun's name), which the CLI's
launcher sets.

Collectives: ``all_gather`` concatenates a tensor over a group in rank order
(differentiable), ``allgather_rows`` does the same for host numpy arrays of
any length (the metric-state gather). Every collective here runs on the
group's own backend: NCCL for CUDA tensors, gloo for CPU tensors (gloo also
takes CUDA tensors, staging them through host memory itself). Nothing
switches backends on its own.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(backend: str, coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join the gang: the default process group over ``num_processes``
    ranks, rendezvous at ``coordinator`` ("host:port", served by rank 0).
    ``backend`` is "nccl" (CUDA) or "gloo" (CPU, or several ranks sharing a
    card); an NCCL rank must have selected its card
    (``torch.cuda.set_device``) first."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def is_distributed() -> bool:
    """True inside an initialised gang of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    """This process's global rank (0 outside a gang)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def node_index() -> int:
    """The index of this rank's node (0 outside a gang): the counterpart of
    ``jax.process_index()``, with ``LOCAL_WORLD_SIZE`` ranks per node."""
    return rank() // int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) grid of ranks, with the process
    group of each axis it belongs to."""
    shape: dict
    coords: dict
    groups: dict

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """A (data, model) grid over the first n_data * n_model ranks of the
    default group (n_data defaults to world_size // n_model). Every rank of
    the default group must call it (it creates the axis groups), in the same
    order as every other ``new_group``; a rank outside the grid gets
    ``None`` groups."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than the {world} ranks")
    me = dist.get_rank()
    groups: dict = {"data": None, "model": None}
    # rank r = d * n_model + m: the data axis varies d at fixed m, the model
    # axis m at fixed d
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks)
        if me in ranks:
            groups["data"] = g
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks)
        if me in ranks:
            groups["model"] = g
    coords = ({"data": me // n_model, "model": me % n_model} if me < n_data * n_model
              else {"data": None, "model": None})
    return Mesh(shape={"data": n_data, "model": n_model}, coords=coords, groups=groups)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's rows of the leading axis of every array or tensor in
    ``batch``: the mesh's ``axis`` splits B into equal parts in rank order.
    Raises if B does not divide (the trainer replicates such a batch)."""
    n, i = mesh.size(axis), mesh.index(axis)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % n:
            raise ValueError(f"shard_batch: {k} has {B} rows, not a multiple of the "
                             f"{axis!r} axis size {n}")
        b = B // n
        out[k] = v[i * b:(i + 1) * b]
    return out


@torch.no_grad()
def replicate(tensors: dict, mesh: Mesh, axis: str = "data") -> dict:
    """Make every rank of the mesh's ``axis`` hold the values of its first
    rank: broadcast each tensor of ``tensors`` (name -> tensor) in place;
    returns ``tensors``."""
    group = mesh.group(axis)
    src = dist.get_global_rank(group, 0)
    for t in tensors.values():
        dist.broadcast(t.data, src, group=group)
    return tensors


def model_partition_spec(shape, n_model: int, kernel: bool = True) -> tuple:
    """The layout of one parameter under tensor parallelism over ``model``,
    as the JAX package's rule on the same leaf: a 2-D or 3-D JAX leaf splits
    its last dim when that dim is a multiple of n_model and at least
    2 * n_model; everything else is replicated (the empty spec). A dense
    weight (``kernel``: the JAX (in, out) kernel, transposed) splits dim 0
    of the port's (out, in) weight; any other 2-D or 3-D parameter (a token,
    a memory, a raw einsum weight) has the JAX leaf's layout and splits its
    last dim. Returns one entry per dim, "model" on the split dim."""
    ndim = len(shape)
    dim = {2: 0 if kernel else 1, 3: 2}.get(ndim)
    if dim is not None and shape[dim] % n_model == 0 and shape[dim] >= 2 * n_model:
        return tuple("model" if d == dim else None for d in range(ndim))
    return ()


@dataclass(frozen=True)
class ModelShards:
    """The parameters of a model that ``shard_params_model`` split over the
    mesh's ``model`` axis: parameter name -> the dim it is split along."""
    mesh: Mesh
    dims: dict

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` (or of a tensor of its
        shape, e.g. an optimizer moment) from this rank's slice: a
        collective over the model group, a no-op for a replicated name."""
        if name not in self.dims:
            return local
        return _gather(local.detach(), self.mesh.group("model"), self.dims[name])

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor of parameter ``name``."""
        if name not in self.dims:
            return full
        dim, n = self.dims[name], self.mesh.size("model")
        size = full.shape[dim] // n
        return full.narrow(dim, self.mesh.index("model") * size, size)


def gather_param(p: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The whole tensor of a sharded parameter from this rank's slice ``p``,
    gathered over the model ``group`` along ``dim``: differentiable (this
    rank's slice of the incoming gradient) while autograd records. Counts
    its calls and the bytes this rank receives in ``gather_param.calls`` /
    ``gather_param.bytes``."""
    gather_param.calls += 1
    gather_param.bytes += p.numel() * p.element_size() * (dist.get_world_size(group) - 1)
    if torch.is_grad_enabled():
        return all_gather(p, group, dim=dim, replicated=True)
    # autograd off (no_grad, inference_mode): a plain tensor flagged as the
    # parameter is, since torch's matmul picks its path (and so its
    # summation order) by the operands' requires_grad, which an inference
    # tensor does not carry
    with torch.inference_mode(False), torch.no_grad():
        whole = _gather(p.detach(), group, dim)
    return whole.requires_grad_(p.requires_grad)


gather_param.calls = 0
gather_param.bytes = 0
_GATHERING_CLASSES: dict = {}


def _gathering_class(cls: type) -> type:
    """``cls`` with an attribute read of a sharded parameter returning the
    whole tensor, gathered over the model group (as a torch parametrization
    does, but the parameter keeps its name)."""
    if cls not in _GATHERING_CLASSES:
        def __getattr__(self, name):
            shards = self.__dict__.get("_model_shards")
            if shards is not None and name in shards[0]:
                return gather_param(self._parameters[name], shards[1], shards[0][name])
            return cls.__getattr__(self, name)

        _GATHERING_CLASSES[cls] = type(cls.__name__, (cls,), {
            "__getattr__": __getattr__, "__module__": cls.__module__,
            "__qualname__": cls.__qualname__})
    return _GATHERING_CLASSES[cls]


@torch.no_grad()
def shard_params_model(model: torch.nn.Module, mesh: Mesh) -> ModelShards:
    """Tensor parallelism (port of vitslam_tpu/parallel/mesh.py::
    shard_params_model): every parameter of ``model`` that
    ``model_partition_spec`` splits becomes this rank's contiguous slice
    along its split dim (index ``mesh.index("model")`` of
    ``mesh.size("model")``), under the same name, so the optimizer, the
    freeze patterns and the checkpoints see the plain names and the local
    slices. Every read of such a parameter (``module.weight``, by the
    module's forward or by any other reader, as ``nn.layers.dense_tail``
    reads a Dense's weight for K5) all-gathers the whole tensor over the
    model group, and the result is freed after its use, as GSPMD gathers in
    front of a Pallas call: every kernel sees the tensors it sees unsharded.
    The gather's backward hands this rank its slice of the incoming
    gradient without communication (every rank of a model group computes
    the same replicated loss). The model must hold its weights already.

    One layout difference from the JAX package: it stacks the per-layer
    vectors of its scanned layers (biases, LayerNorm scales, LayerScale
    gammas) into (L, C) leaves and splits them; the port keeps them per
    layer, 1-D, and replicated. Only the layout differs, never a value."""
    n = mesh.size("model")
    dims: dict = {}
    if n == 1:
        return ModelShards(mesh, dims)
    index = mesh.index("model")
    for mname, module in model.named_modules():
        local = {}
        for pname, p in list(module._parameters.items()):
            if p is None:
                continue
            spec = model_partition_spec(tuple(p.shape), n, kernel=pname == "weight")
            if not spec:
                continue
            dim = spec.index("model")
            size = p.shape[dim] // n
            module._parameters[pname] = torch.nn.Parameter(
                p.detach().narrow(dim, index * size, size).clone(), requires_grad=p.requires_grad)
            local[pname] = dim
            dims[f"{mname}.{pname}" if mname else pname] = dim
        if local:
            module.__class__ = _gathering_class(type(module))
            module.__dict__["_model_shards"] = (local, mesh.group("model"))
    return ModelShards(mesh, dims)


def sync_global_devices(name: str = "barrier") -> None:
    """Barrier over every rank of the gang (no-op outside one). ``name`` is
    kept for the reference's signature."""
    if is_distributed():
        dist.barrier()


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, replicated):
        ctx.group, ctx.dim, ctx.replicated = group, dim, replicated
        ctx.index, ctx.size = dist.get_rank(group), x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def all_gather(x: torch.Tensor, group=None, dim: int = 0,
               replicated: bool = False) -> torch.Tensor:
    """Concatenate ``x`` of every rank of ``group`` along ``dim`` in rank
    order (every rank's ``x`` has the same shape). Differentiable: the
    gradient of this rank's ``x`` is its slice of the sum of the incoming
    gradients over the group; with ``replicated`` every rank computes the
    same function of the gathered tensor (a replicated loss), so every rank
    receives the same incoming gradient, and its slice of this rank's alone
    is the gradient (no communication; the sum would count it once per
    rank)."""
    return _AllGather.apply(x, group, dim, replicated)


def allgather_rows(x: np.ndarray, group=None) -> np.ndarray:
    """Concatenate a host array of every rank along its first axis, in rank
    order; the ranks may hold different numbers of rows."""
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, np.asarray(x), group=group)
    return np.concatenate(parts, axis=0)
