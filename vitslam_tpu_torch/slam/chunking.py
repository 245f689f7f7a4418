"""Chunk scheduling and sequence assembly (port of
vitslam_tpu/slam/chunking.py): ``generate_chunks`` (index schedules),
``chunk_batch`` (per-chunk slicing), ``merge_chunk_outputs``
(overlap-deduplicating concatenation), ``normalize_extrinsics_and_points``
(first-camera-centric GT normalisation) and ``check_and_fix_inf_nan``."""
from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
import torch

from ..geometry import closed_form_inverse_se3, pad_to_4x4

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


def check_and_fix_inf_nan(x: torch.Tensor, name: str = "tensor",
                          hard_max: Optional[float] = None) -> torch.Tensor:
    """NaN and +-Inf replaced by 0, optionally clamped to [-hard_max,
    hard_max] (``name`` is the reference's label and changes nothing)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    if hard_max is not None:
        x = x.clamp(-hard_max, hard_max)
    return x


def normalize_extrinsics_and_points(extrinsics: torch.Tensor,
                                    cam_points: Optional[torch.Tensor] = None,
                                    world_points: Optional[torch.Tensor] = None,
                                    depths: Optional[torch.Tensor] = None,
                                    scale_by_points: bool = False,
                                    point_masks: Optional[torch.Tensor] = None):
    """Re-express GT w2c extrinsics (B, S, 3|4, 4) and world points
    (B, S, H, W, 3) in the first camera's frame, optionally scaling the
    scene to unit mean point distance. Returns (extrinsics (B, S, 3, 4),
    cam_points, world_points, depths)."""
    e = pad_to_4x4(extrinsics.float())
    new_e = e @ closed_form_inverse_se3(e[:, 0])[:, None]
    new_world = None
    if world_points is not None:
        R = e[:, 0, :3, :3]
        t = e[:, 0, :3, 3]
        new_world = (torch.einsum("bij,bshwj->bshwi", R, world_points.float())
                     + t[:, None, None, None, :])
    if scale_by_points:
        if world_points is None or point_masks is None:
            raise ValueError("scale_by_points needs world_points and point_masks")
        dist = torch.linalg.vector_norm(new_world, dim=-1)
        m = point_masks.float()
        avg = ((dist * m).sum(dim=(1, 2, 3)) / (m.sum(dim=(1, 2, 3)) + 1e-3)).clamp(1e-6, 1e6)
        new_world = new_world / avg[:, None, None, None, None]
        new_e = new_e.clone()
        new_e[:, :, :3, 3] = new_e[:, :, :3, 3] / avg[:, None, None]
        if depths is not None:
            depths = depths / avg[:, None, None, None]
        if cam_points is not None:
            cam_points = cam_points / avg[:, None, None, None, None]
        return (check_and_fix_inf_nan(new_e[:, :, :3]), cam_points,
                check_and_fix_inf_nan(new_world), depths)
    return new_e[:, :, :3], cam_points, new_world, depths
