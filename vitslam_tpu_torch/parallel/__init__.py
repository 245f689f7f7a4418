"""Distributed execution on ``torch.distributed`` (port of
vitslam_tpu/parallel): the (data, model) rank grid and its collectives,
tensor parallelism over ``model``, the sequence-parallel encode, the gang
launcher and the pod-topology worker."""
from .mesh import (
    Mesh,
    ModelShards,
    all_gather,
    allgather_rows,
    init_distributed,
    is_distributed,
    make_mesh,
    model_partition_spec,
    node_index,
    rank,
    replicate,
    shard_batch,
    shard_params_model,
    sync_global_devices,
)
from .seq import gather_sequence, sequence_parallel_encode
from .spawn import clean_env, free_port, python_worker_argv, spawn_gang

__all__ = [
    "Mesh", "ModelShards", "all_gather", "allgather_rows", "clean_env", "free_port",
    "gather_sequence", "init_distributed", "is_distributed", "make_mesh",
    "model_partition_spec", "node_index", "python_worker_argv", "rank", "replicate",
    "sequence_parallel_encode", "shard_batch", "shard_params_model", "spawn_gang",
    "sync_global_devices",
]
