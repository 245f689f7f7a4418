"""Weights and train states carried across from the JAX package, and the
port's own checkpoints (whole-tensor and sharded)."""
from .checkpoint import CheckpointManager, load_checkpoint, load_model_params, save_checkpoint
from .from_jax import load_jax_params, train_state_from_jax
from .sharded_ckpt import ShardedCheckpointManager, as_dtensors, load_sharded, save_sharded

__all__ = ["CheckpointManager", "ShardedCheckpointManager", "as_dtensors", "load_checkpoint",
           "load_jax_params", "load_model_params", "load_sharded", "save_checkpoint",
           "save_sharded", "train_state_from_jax"]
