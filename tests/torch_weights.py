"""Seeded weights for the port's model-level parity tests, and the JAX
compile cache they share.

The port model draws its weights from its own initialisers
(``init_weights``), and ``jax_variables`` moves them into the JAX model's
variable tree. The tree's structure comes from ``jax.eval_shape`` of the JAX
init, a trace without a compile: a jitted JAX init costs 15-20 s per model on
the CPU, most of a parity test's time.

``shared_jax_cache`` (a module-scoped autouse fixture: a test module turns
it on by importing it) gives the module's JAX reference runs a persistent
compilation cache shared by the pytest-xdist workers of one run: the port's
parity tests build the same tiny JAX models in many tests and files, and a
jitted function made anew compiles its unchanged HLO again. A cache hit
hands back the executable the same compile made, so no result changes.
The cache lives in the temporary directory, one per run (xdist's test-run
id), and is off outside xdist and outside these modules, so the JAX
package's own tests run as they do without it.
"""
import os
import tempfile

import jax
import numpy as np
import pytest
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


# the cache's size bound: any value turns on its file lock, which makes
# reads and writes safe across the workers
_CACHE_MAX_BYTES = 1 << 32


@pytest.fixture(scope="module", autouse=True)
def shared_jax_cache():
    """The module's JAX compiles through the run's persistent cache (module
    docstring); the settings before the module are restored after it."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        yield
        return
    from jax._src import compilation_cache

    keys = ("jax_compilation_cache_dir", "jax_compilation_cache_max_size")
    before = {k: getattr(jax.config, k) for k in keys}
    jax.config.update(keys[0], os.path.join(tempfile.gettempdir(), f"vitslam-jax-cache-{run}"))
    jax.config.update(keys[1], _CACHE_MAX_BYTES)
    compilation_cache.reset_cache()  # whether the cache is used is decided per process once
    try:
        yield
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
