"""Chunk scheduling and sequence assembly (port of the driver part of
vitslam_tpu/slam/chunking.py): ``generate_chunks`` (index schedules),
``chunk_batch`` (per-chunk slicing) and ``merge_chunk_outputs``
(overlap-deduplicating concatenation)."""
from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
import torch

# keys concatenated along the frame axis with overlap dedup
FRAME_AXIS_KEYS = (
    "pose_enc", "world_points", "world_points_conf", "depth", "depth_conf",
    "extrinsics", "intrinsics", "scales", "cam_points", "depths",
    "point_masks", "images", "ids",
)
# per-chunk outputs concatenated without dedup
CHUNK_AXIS_KEYS = ("chunk_sim3_enc", "frame_se3_enc")
# list-valued keys merged element-wise along the frame axis
NESTED_LIST_KEYS = ("pose_enc_list",)


def generate_chunks(num_frames: int, mode: str, seq_width: int, overlap: int,
                    rng: Optional[random.Random] = None) -> list[list[int]]:
    """Per-chunk frame-index lists. Modes: ``chunk_gt`` (non-overlapping +
    remainder), ``chunk_overlap`` (stride seq_width - overlap + a remainder
    chunk covering the tail), ``all`` (one chunk), ``two_chunks`` (a random
    disjoint split)."""
    indices: list[list[int]] = []
    if mode == "chunk_gt":
        for i in range(0, num_frames - seq_width + 1, seq_width):
            indices.append(list(range(i, i + seq_width)))
        if len(indices) * seq_width < num_frames:
            indices.append(list(range(len(indices) * seq_width, num_frames)))
    elif mode == "chunk_overlap":
        if num_frames < seq_width:
            indices.append(list(range(num_frames)))
        else:
            stride = seq_width - overlap
            for i in range(0, num_frames - seq_width + 1, stride):
                indices.append(list(range(i, i + seq_width)))
            if len(indices) * stride < num_frames - overlap:
                indices.append(list(range(len(indices) * stride, num_frames)))
    elif mode == "all":
        indices = [list(range(num_frames))]
    elif mode == "two_chunks":
        if num_frames < 2:
            raise ValueError("two_chunks mode needs at least 2 frames")
        rng = rng or random
        if num_frames == 2:
            indices = [[0, 1]]
        else:
            all_idx = list(range(num_frames))
            first = sorted(rng.sample(all_idx, rng.randint(1, num_frames - 1)))
            indices = [first, [i for i in all_idx if i not in first]]
    else:
        raise ValueError(f"unknown chunking mode: {mode!r}")
    return indices


def chunk_batch(batch: dict, indices: Sequence[Sequence[int]]) -> list[dict]:
    """Slice every array value of ``batch`` (B, N, ...) — numpy or torch —
    into per-chunk dicts along the frame axis."""
    chunks = []
    for chunk_ids in indices:
        chunk = {}
        for key, val in batch.items():
            if isinstance(val, torch.Tensor) and val.ndim >= 2:
                chunk[key] = val[:, torch.as_tensor(chunk_ids, device=val.device)]
            elif isinstance(val, np.ndarray) and val.ndim >= 2:
                chunk[key] = val[:, np.asarray(chunk_ids)]
        chunks.append(chunk)
    return chunks


def _cat(vals: list, axis: int):
    if isinstance(vals[0], torch.Tensor):
        return torch.cat(vals, dim=axis)
    return np.concatenate([np.asarray(v) for v in vals], axis=axis)


def _merge_frame_axis(vals: list, overlap: int):
    if overlap > 0:
        vals = [vals[0]] + [v[:, overlap:] for v in vals[1:]]
    return _cat(vals, 1)


def merge_chunk_outputs(chunk_dicts: Sequence[dict], overlap: int) -> dict:
    """Concatenate per-chunk dicts along the frame axis, dropping the first
    ``overlap`` frames of every chunk but the first for frame-axis keys;
    chunk-axis keys concatenate without dedup; other keys keep the latest."""
    if not chunk_dicts:
        return {}
    merged: dict = {}
    for key in chunk_dicts[0]:
        if key in NESTED_LIST_KEYS:
            per_chunk = [d[key] for d in chunk_dicts if key in d]
            merged[key] = [_merge_frame_axis([c[i] for c in per_chunk], overlap)
                           for i in range(len(per_chunk[0]))]
            continue
        vals = [d[key] for d in chunk_dicts if key in d]
        if key in CHUNK_AXIS_KEYS:
            merged[key] = _cat(vals, 1)
        elif key in FRAME_AXIS_KEYS:
            merged[key] = _merge_frame_axis(vals, overlap)
        else:
            merged[key] = vals[-1]
    return merged
