"""Seeded weights for the port's model-level parity tests.

The port model draws its weights from its own initialisers
(``init_weights``), and ``jax_variables`` moves them into the JAX model's
variable tree. The tree's structure comes from ``jax.eval_shape`` of the JAX
init, a trace without a compile: a jitted JAX init costs 15-20 s per model on
the CPU, most of a parity test's time.
"""
import jax
import numpy as np
import torch

from vitslam_tpu.io.torch_convert import export_torch_style, import_torch_style
from vitslam_tpu_torch.io.from_jax import port_name
from vitslam_tpu_torch.nn.layers import init_weights


def seeded(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """``model`` with its weights drawn from the port's initialisers."""
    return init_weights(model, torch.Generator().manual_seed(seed))


def jax_variables(init, model: torch.nn.Module):
    """The JAX variables holding ``model``'s parameters. ``init(rng)`` is the
    JAX model's init on sample inputs; every leaf of its tree must have a
    port parameter of the same name."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = dict(model.named_parameters())
    flat = {k: params[port_name(k)].detach().cpu().numpy()
            for k in export_torch_style(template)}
    variables, missing = import_torch_style(flat, template)
    assert missing == []
    return variables
