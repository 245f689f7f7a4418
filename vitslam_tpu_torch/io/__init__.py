"""Weights carried across from the JAX package, and the port's own
checkpoints."""
from .checkpoint import CheckpointManager, load_checkpoint, load_model_params, save_checkpoint
from .from_jax import load_jax_params

__all__ = ["CheckpointManager", "load_checkpoint", "load_jax_params", "load_model_params",
           "save_checkpoint"]
