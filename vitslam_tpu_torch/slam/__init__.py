"""Chunk driver and context states (port of vitslam_tpu/slam; GT alignment
is not ported yet)."""
from .chunking import chunk_batch, generate_chunks, merge_chunk_outputs
from .pipeline import ChunkedPipeline
from .state import FeatureAlignContext, PointAlignContext, PoseAlignContext

__all__ = ["ChunkedPipeline", "FeatureAlignContext", "PointAlignContext",
           "PoseAlignContext", "chunk_batch", "generate_chunks", "merge_chunk_outputs"]
