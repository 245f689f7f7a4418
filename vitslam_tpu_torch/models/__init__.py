"""Models (port of vitslam_tpu/models): the backbone, heads and the
feature-aligned chunk model. The point/pose-aligned variants and the
TrackHead are not ported yet."""
from .aggregator import Aggregator, PatchEmbedViT, expand_frame_tokens
from .alignment_head import AlignmentHead
from .camera_head import CameraHead
from .dpt_head import DPTHead
from .feature_aligned import FeatureAlignedVGGT
from .presets import flagship, small_feature_aligned
from .vggt_core import VGGTCore

__all__ = [
    "Aggregator", "PatchEmbedViT", "expand_frame_tokens", "AlignmentHead",
    "CameraHead", "DPTHead", "FeatureAlignedVGGT", "VGGTCore", "flagship",
    "small_feature_aligned",
]
