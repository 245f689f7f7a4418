"""Chunk driver, context states, chunking helpers and GT alignment (port
of vitslam_tpu/slam)."""
from .chunking import (
    check_and_fix_inf_nan,
    chunk_batch,
    generate_chunks,
    merge_chunk_outputs,
    normalize_extrinsics_and_points,
)
from .gt_alignment import align_outputs, apply_sim3_on_dict, per_chunk_scale_from_poses
from .pipeline import ChunkedPipeline
from .state import FeatureAlignContext, PointAlignContext, PoseAlignContext

__all__ = ["ChunkedPipeline", "FeatureAlignContext", "PointAlignContext",
           "PoseAlignContext", "align_outputs", "apply_sim3_on_dict",
           "check_and_fix_inf_nan", "chunk_batch", "generate_chunks", "merge_chunk_outputs",
           "normalize_extrinsics_and_points", "per_chunk_scale_from_poses"]
