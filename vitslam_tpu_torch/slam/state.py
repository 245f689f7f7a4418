"""Chunk-to-chunk context state (port of vitslam_tpu/slam/state.py): only
what the next chunk consumes stays on the device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class FeatureAlignContext:
    """State consumed by FeatureAlignedVGGT for chunks after the first.

    overlap_tokens: (B, 1+overlap, 1+P, C_embed) processed tokens of the
        previous chunk (first-frame column + overlap frames).
    memory_tokens: (B, M, dec_dim) unit-norm rolling memory, or None.
    prev_pose_enc: (B, overlap, 9) previous chunk's aligned pose encodings
        of its last ``overlap`` frames.
    """
    overlap_tokens: torch.Tensor
    memory_tokens: Optional[torch.Tensor]
    prev_pose_enc: torch.Tensor


@dataclass
class PointAlignContext:
    """State consumed by PointAlignedVGGT for chunks after the first.

    prev_points: (B, overlap, H, W, 3) previous chunk's aligned world points
        of its last ``overlap`` frames.
    prev_conf: (B, overlap, H, W) their confidences.
    """
    prev_points: torch.Tensor
    prev_conf: torch.Tensor


@dataclass
class PoseAlignContext:
    """State consumed by PoseAlignedVGGT for chunks after the first.

    prev_pose_enc: (B, overlap, 9) previous chunk's aligned pose encodings
        of its last ``overlap`` frames.
    """
    prev_pose_enc: torch.Tensor
