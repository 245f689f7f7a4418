"""The training step (port of vitslam_tpu/train/train_step.py).

One step runs the whole chunk loop of a batch: the frozen backbone and
decoder heads per chunk (without autograd unless a parameter there is
trainable), the AlignmentHead and the pose and scale composition with
autograd (train mode: frame dropout), the overlap-0 merge of the chunk
outputs, the GT alignment, and the multi-task loss. Gradients are taken
for the trainable parameters only, then one optimizer (micro-)step updates
them in place. The reference jits the same loop into one XLA graph per
shape bucket; here it runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..geometry import pad_to_4x4
from ..ops.attention import plain_attention_routes
from ..slam.chunking import CHUNK_AXIS_KEYS, FRAME_AXIS_KEYS
from ..slam.gt_alignment import align_outputs
from .optim import AdamW, global_norm


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
                   plain_attention: bool = False):
    """The losses of one batch (dict of 0-d tensors, 'objective' among
    them) and the gradient of the objective for every trainable parameter
    (name -> tensor; zeros where the objective does not depend on it).
    ``plain_attention`` routes the attention of every stage that takes a
    gradient around the kernels (``ops.attention.plain_attention_routes``),
    to hold the kernel path against the plain one; a frozen backbone keeps
    its kernels, its output is the same either way."""
    dev = next(iter(trainable.values())).device
    encode_grad = any(p.requires_grad for p in model.core.parameters())
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
                                             train=True, generator=generator)
        outs.append(out)
    preds = merge_outputs_traced(outs, overlap=0)
    preds = align_outputs(preds, merged_batch, gt_alignment_type,
                          image_size_hw=tuple(merged_batch["images"].shape[-2:]))
    losses = loss_fn(preds, merged_batch, step, generator)
    names = list(trainable)
    # the attention backward follows the forward's route (saved per call)
    grads = torch.autograd.grad(losses["objective"], [trainable[n] for n in names],
                                allow_unused=True)
    grads = {n: torch.zeros_like(trainable[n]) if g is None else g for n, g in zip(names, grads)}
    return {k: v.detach() for k, v in losses.items() if v.ndim == 0}, grads


def make_train_step(model, loss_fn, num_overlap: int,
                    gt_alignment_type: str = "scale_from_depths", use_gt_poses: bool = False):
    """The step function ``step_fn(state, chunk_batches, merged_batch,
    generator=None, plain_attention=False) -> (state, metrics)``:
    chunk_batches are the per-chunk GT dicts (images + GT keys),
    merged_batch their overlap-0 concatenation; the generator draws the
    frame dropout and the relative-pose loss's large offset. The state's
    parameters are updated in place. Metrics: 'objective', every scalar
    loss and 'grad_norm' (the global norm of this micro-step's gradient),
    as 0-d tensors."""

    def step_fn(state: TrainState, chunk_batches, merged_batch,
                generator: Optional[torch.Generator] = None, plain_attention: bool = False):
        losses, grads = loss_and_grads(
            model, loss_fn, state.trainable, chunk_batches, merged_batch, state.step,
            num_overlap, gt_alignment_type, use_gt_poses, generator, plain_attention)
        metrics = dict(losses, grad_norm=global_norm(grads.values()))
        state.optimizer.step(grads)
        state.step += 1
        return state, metrics

    return step_fn
