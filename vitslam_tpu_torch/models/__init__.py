"""Models (port of vitslam_tpu/models): the backbone, heads and the
feature-, point- and pose-aligned chunk models."""
from .aggregator import Aggregator, PatchEmbedViT, expand_frame_tokens
from .alignment_head import AlignmentHead
from .camera_head import CameraHead
from .dpt_head import DPTHead
from .feature_aligned import FeatureAlignedVGGT
from .point_aligned import PointAlignedVGGT
from .pose_aligned import PoseAlignedVGGT
from .presets import (
    flagship,
    flagship_point_aligned,
    flagship_pose_aligned,
    flagship_pose_only,
    small_feature_aligned,
)
from .track_head import TrackHead
from .vggt_core import VGGTCore

__all__ = [
    "Aggregator", "PatchEmbedViT", "expand_frame_tokens", "AlignmentHead",
    "CameraHead", "DPTHead", "FeatureAlignedVGGT", "PointAlignedVGGT",
    "PoseAlignedVGGT", "TrackHead", "VGGTCore", "flagship", "flagship_point_aligned",
    "flagship_pose_aligned", "flagship_pose_only", "small_feature_aligned",
]
