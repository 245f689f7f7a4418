"""Sequence parallelism for the large-chunk backbone encode (port of
vitslam_tpu/parallel/seq.py).

The chunk's frame axis S is split over a process group. Patch embedding,
frame attention, the MLPs and projections and the DPT decode are
frame-local, so they need no communication. Each global attention gathers
its LayerNormed and rotated keys and values over the group and computes
exact attention for its local queries (``nn.layers.Attention(seq_group=...)``;
with more than 4,096 gathered keys that is kernel K2 with Nq = S/n frames'
tokens against all S frames' keys). The camera head attends across frames:
it gathers the S camera tokens, runs replicated and keeps the local frames
(``models.vggt_core.VGGTCore.decode_camera``). Each query row sees the same
keys in the same order as the unsharded encode.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import all_gather


def sequence_parallel_encode(model, images: torch.Tensor, group=None) -> dict:
    """``model.encode_chunks`` on this rank's frames of ``images``
    (B, S, 3, H, W), S a multiple of the group's size n: rank i of the
    group takes frames [i * S/n, (i + 1) * S/n). ``model`` must have been
    built with ``seq_group=group`` (the point- and pose-aligned models and
    VGGTCore take it). Returns the raw-outputs dict with every (B, S, ...)
    output's local (B, S/n, ...) slice; ``gather_sequence`` assembles them."""
    if getattr(model, "seq_group", None) is not group:
        raise ValueError("sequence_parallel_encode: the model must be built with "
                         "seq_group set to the group it runs over")
    n = dist.get_world_size(group)
    S = images.shape[1]
    if S % n != 0:
        raise ValueError(f"sequence-parallel encode needs S % group size == 0 (got S={S}, "
                         f"group size {n}); pad the chunk to a multiple")
    s = S // n
    i = dist.get_rank(group)
    return model.encode_chunks(images[:, i * s:(i + 1) * s])


def gather_sequence(raw: dict, group=None) -> dict:
    """The full (B, S, ...) outputs from every rank's local slices, in
    frame order."""
    return {k: all_gather(v, group, dim=1) for k, v in raw.items()}
