"""Weights carried across from the JAX package."""
from .from_jax import load_jax_params

__all__ = ["load_jax_params"]
