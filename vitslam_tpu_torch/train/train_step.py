"""The training step (port of vitslam_tpu/train/train_step.py).

One step runs the whole chunk loop of a batch: the frozen backbone and
decoder heads per chunk (without autograd unless a parameter there is
trainable), the AlignmentHead and the pose and scale composition with
autograd (train mode: frame dropout), the overlap-0 merge of the chunk
outputs, the GT alignment, and the multi-task loss. Gradients are taken
for the trainable parameters only, then one optimizer (micro-)step updates
them in place. The reference jits the same loop into one XLA graph per
shape bucket; here it runs eagerly.

Data parallelism (``data_group``, a process group of a gang): the objective
is the global batch's, as the reference computes it over its sharded batch
(masked means and the quantile filter over the whole batch, the GT
alignment's batch-level reductions). Each rank runs the chunk loop on its
rows of the global batch (the frame dropout draws the global batch's
uniforms and keeps its rows), the merged predictions are gathered over the
group, every rank computes the same global loss from them, and the
parameter gradients are summed over the group. The gather's backward hands
each rank its own rows' slice of that (replicated) loss's gradient, so the
sum is the gradient of the global objective, not an average of per-rank
losses'. A batch whose rows do not divide over the group is held whole by
every rank; each computes the same gradient, and the group's first rank's
is broadcast so the ranks' parameters stay bit-identical.

Tensor parallelism (``parallel.shard_params_model``) needs nothing here:
the model's sharded parameters are gathered where they are read, the
gradients of the trainable ones are this rank's slices, the data group's
sum runs over those slices, and the optimizer's norm is the whole
gradient's (``AdamW.grad_norm``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..geometry import pad_to_4x4
from ..ops.attention import plain_attention_routes
from ..parallel.mesh import all_gather
from ..slam.chunking import CHUNK_AXIS_KEYS, FRAME_AXIS_KEYS
from ..slam.gt_alignment import align_outputs
from .optim import AdamW


@dataclass
class TrainState:
    """The trainable parameters (name -> parameter of the model, updated in
    place), their optimizer, and the number of steps taken."""
    trainable: dict
    optimizer: AdamW
    step: int = 0


def merge_outputs_traced(outs: Sequence[dict], overlap: int = 0) -> dict:
    """Concatenate per-chunk output dicts of device tensors (keeping their
    graph) along the frame axis; training merges with overlap 0, so the
    duplicated overlap frames stay in both predictions and GT."""
    merged: dict = {}
    for key in outs[0]:
        vals = [o[key] for o in outs if o.get(key) is not None]
        if not vals:
            continue
        if key in CHUNK_AXIS_KEYS:
            merged[key] = torch.cat(vals, dim=1)
        elif key in FRAME_AXIS_KEYS:
            if overlap > 0:
                vals = [vals[0]] + [v[:, overlap:] for v in vals[1:]]
            merged[key] = torch.cat(vals, dim=1)
        else:
            merged[key] = vals[-1]
    return merged


def loss_and_grads(model, loss_fn, trainable: dict, chunk_batches: Sequence[dict],
                   merged_batch: dict, step: int, num_overlap: int,
                   gt_alignment_type: str = "scale_from_depths", use_gt_poses: bool = False,
                   generator: Optional[torch.Generator] = None,
                   plain_attention: bool = False, data_group=None):
    """The losses of one batch (dict of 0-d tensors, 'objective' among
    them) and the gradient of the objective for every trainable parameter
    (name -> tensor; zeros where the objective does not depend on it).
    ``plain_attention`` routes the attention of every stage that takes a
    gradient around the kernels (``ops.attention.plain_attention_routes``),
    to hold the kernel path against the plain one; a frozen backbone keeps
    its kernels, its output is the same either way. ``data_group``: the
    data-parallel group; the chunk batches then hold this rank's rows of
    the global batch whose GT ``merged_batch`` is, or all of them."""
    dev = next(iter(trainable.values())).device
    encode_grad = any(p.requires_grad for p in model.core.parameters())
    rows = _batch_rows(chunk_batches[0]["images"].shape[0],
                       merged_batch["images"].shape[0], data_group)
    context, outs = None, []
    for chunk in chunk_batches:
        images = torch.as_tensor(chunk["images"], device=dev)
        gt_poses = None
        if use_gt_poses and "extrinsics" in chunk:
            gt_poses = pad_to_4x4(torch.as_tensor(chunk["extrinsics"], device=dev).float())
        with torch.set_grad_enabled(encode_grad), \
                plain_attention_routes(plain_attention and encode_grad):
            raw = model.encode_chunks(images)
        with plain_attention_routes(plain_attention):
            out, context = model.align_chunk(raw, images.shape, num_overlap, context, gt_poses,
                                             train=True, generator=generator, batch_rows=rows)
        outs.append(out)
    preds = merge_outputs_traced(outs, overlap=0)
    if rows is not None:
        preds = {k: all_gather(v, data_group, dim=0, replicated=True) for k, v in preds.items()}
    preds = align_outputs(preds, merged_batch, gt_alignment_type,
                          image_size_hw=tuple(merged_batch["images"].shape[-2:]))
    losses = loss_fn(preds, merged_batch, step, generator)
    names = list(trainable)
    # the attention backward follows the forward's route (saved per call)
    grads = torch.autograd.grad(losses["objective"], [trainable[n] for n in names],
                                allow_unused=True)
    grads = {n: torch.zeros_like(trainable[n]) if g is None else g for n, g in zip(names, grads)}
    if data_group is not None:
        grads = _reduce_grads(grads, data_group, sharded=rows is not None)
    return {k: v.detach() for k, v in losses.items() if v.ndim == 0}, grads


def _batch_rows(local: int, total: int, data_group):
    """(offset, total) of this rank's rows in the global batch, or None
    when it holds the whole batch."""
    if local == total:
        return None
    n = dist.get_world_size(data_group) if data_group is not None else 1
    if local * n != total:
        raise ValueError(f"chunk batches of {local} rows do not split a global batch of "
                         f"{total} rows over {n} data-parallel ranks")
    return dist.get_rank(data_group) * local, total


def _reduce_grads(grads: dict, group, sharded: bool) -> dict:
    """Sum the gradients over the group (``sharded``), or take its first
    rank's, in one collective over one flat buffer."""
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    if sharded:
        dist.all_reduce(flat, group=group)
    else:
        dist.broadcast(flat, dist.get_global_rank(group, 0), group=group)
    out, i = {}, 0
    for n in names:
        k = grads[n].numel()
        out[n] = flat[i:i + k].view_as(grads[n])
        i += k
    return out


def make_train_step(model, loss_fn, num_overlap: int,
                    gt_alignment_type: str = "scale_from_depths", use_gt_poses: bool = False,
                    data_group=None):
    """The step function ``step_fn(state, chunk_batches, merged_batch,
    generator=None, plain_attention=False) -> (state, metrics)``:
    chunk_batches are the per-chunk GT dicts (images + GT keys),
    merged_batch their overlap-0 concatenation; the generator draws the
    frame dropout and the relative-pose loss's large offset. The state's
    parameters are updated in place. Metrics: 'objective', every scalar
    loss and 'grad_norm' (the global norm of this micro-step's gradient),
    as 0-d tensors. ``data_group``: as in ``loss_and_grads``."""

    def step_fn(state: TrainState, chunk_batches, merged_batch,
                generator: Optional[torch.Generator] = None, plain_attention: bool = False):
        losses, grads = loss_and_grads(
            model, loss_fn, state.trainable, chunk_batches, merged_batch, state.step,
            num_overlap, gt_alignment_type, use_gt_poses, generator, plain_attention, data_group)
        metrics = dict(losses, grad_norm=state.optimizer.grad_norm(grads))
        state.optimizer.step(grads)
        state.step += 1
        return state, metrics

    return step_fn
