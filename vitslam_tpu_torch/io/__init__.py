"""Weights and train states carried across from the JAX package, and the
port's own checkpoints (whole-tensor and sharded); the JAX package's
orbax checkpoints are read without orbax (``orbax_format``, ``ocdbt``), and
a public VGGT-1B checkpoint without the safetensors package (``from_vggt``,
``safetensors``)."""
from .checkpoint import CheckpointManager, load_checkpoint, load_model_params, save_checkpoint
from .from_jax import load_jax_params, train_state_from_jax
from .from_vggt import load_vggt_state_dict, vggt_into
from .orbax_format import read_orbax
from .safetensors import read_safetensors
from .sharded_ckpt import ShardedCheckpointManager, as_dtensors, load_sharded, save_sharded

__all__ = ["CheckpointManager", "ShardedCheckpointManager", "as_dtensors", "load_checkpoint",
           "load_jax_params", "load_model_params", "load_sharded", "load_vggt_state_dict",
           "read_orbax", "read_safetensors", "save_checkpoint", "save_sharded",
           "train_state_from_jax", "vggt_into"]
