"""Chunk driver and context state (port of vitslam_tpu/slam; GT alignment
is not ported yet)."""
from .chunking import chunk_batch, generate_chunks, merge_chunk_outputs
from .pipeline import ChunkedPipeline
from .state import FeatureAlignContext

__all__ = ["ChunkedPipeline", "FeatureAlignContext", "chunk_batch",
           "generate_chunks", "merge_chunk_outputs"]
