"""Port parity for K5, the fused block tail (ops/mlp_tail.py) and the
blocks that route through it (nn/layers.py Block(mlp_tail=...)): the same
numpy inputs and weights through the JAX function or module (the Pallas
kernel in interpret mode, as tests/test_fused_attention.py runs it) and the
port on the CPU, in fp32."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.nn import layers as jl  # noqa: E402
from vitslam_tpu.ops.mlp_tail import mlp_tail as jax_mlp_tail  # noqa: E402
from vitslam_tpu.ops.mlp_tail import mlp_tail_reference  # noqa: E402
from vitslam_tpu_torch.io import load_jax_params  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.ops.mlp_tail import _MlpTail, mlp_tail, mlp_tail_plain  # noqa: E402

# vitslam_tpu_torch.ops re-exports the function under the module's name
tail_mod = importlib.import_module("vitslam_tpu_torch.ops.mlp_tail")

torch.set_num_threads(2)

# the reference's own tolerances: 1e-3 for the tail against its plain math
# (sums of 512 products in another order), 5e-3 for the gradients, 2e-4 for
# a block with fused tails against the JAX block with fused tails (fp32)
TAIL_TOL = 1e-3
GRAD_TOL = 5e-3
BLOCK_TOL = 2e-4
# Block(mlp_tail=...) -> the reference's VITSLAM_MLP_TAIL value
ENV = {"mlp": "mlp", "proj": "proj", "both": "1"}


def _inputs(m, f, c, seed=0):
    """h (m, f), w2 (f, c) in the reference's layout, b2, res, gamma, beta."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * sc + mu
            for s, sc, mu in (((m, f), 1, 0), ((f, c), 0.05, 0), ((c,), 0.1, 0),
                              ((m, c), 1, 0), ((c,), 0.1, 1), ((c,), 0.1, 0))]


def _port_args(h, w2, b2, res, gamma, beta):
    return [torch.tensor(h), torch.tensor(w2.T.copy()), torch.tensor(b2), torch.tensor(res),
            torch.tensor(gamma), torch.tensor(beta)]


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("m,f,c", [(256, 512, 256), (300, 512, 128)])
def test_plain_matches_jax_kernel_and_reference(m, f, c, ln, gelu):
    """The cases of tests/test_fused_attention.py::TestMlpTail, with and
    without gelu and the LayerNorm epilogue: the port's plain version (what
    a CPU tensor runs) against the JAX kernel in interpret mode and against
    mlp_tail_reference, within 1e-3."""
    args = _inputs(m, f, c)
    h, w2, b2, res, gamma, beta = (jnp.asarray(a) for a in args)
    kw = dict(gelu=gelu, ln=ln)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mlp_tail(h, w2, b2, res, gamma, beta, block_m=128, block_k=256, **kw)
    ref = mlp_tail_reference(h, w2, b2, res, gamma, beta, **kw)
    got = mlp_tail(*_port_args(*args), **kw)
    plain = mlp_tail_plain(*_port_args(*args), **kw)
    if not ln:
        got, plain, want, ref = (got,), (plain,), (want,), (ref,)
    for g, p, w, r in zip(got, plain, want, ref):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TAIL_TOL, rtol=TAIL_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TAIL_TOL, rtol=TAIL_TOL)


def test_autograd_function_grads_match_jax_vjp(monkeypatch):
    """The wrapper's autograd.Function (K5 forward, backward by autograd
    through the plain version) against the JAX kernel's custom VJP, the case
    of test_tail_backward_matches_reference_grad. The CPU has no kernel, so
    the Function's forward runs the plain version here; its backward is the
    code the card runs."""
    m, f, c = 256, 512, 256
    args = _inputs(m, f, c, seed=5)

    def loss_k(h, w2, b2, res, g, b):
        with pltpu.force_tpu_interpret_mode():
            x, y = jax_mlp_tail(h, w2, b2, res, g, b, gelu=True, block_m=128, block_k=256)
        return jnp.sum(x * x) + jnp.sum(y)

    want = jax.grad(loss_k, argnums=(0, 1, 2, 3, 4, 5))(*(jnp.asarray(a) for a in args))
    monkeypatch.setattr(tail_mod, "_launch",
                        lambda h, w2, b2, res, g, bt, eps, gelu, ln: mlp_tail_plain(
                            h, w2, b2, res, g, bt, eps=eps, gelu=gelu, ln=ln))
    t = [a.requires_grad_() for a in _port_args(*args)]
    x, y = _MlpTail.apply(*t, 1e-6, True, True)
    ((x * x).sum() + y.sum()).backward()
    for a, w, name in zip(t, want, ("h", "w2", "b2", "res", "gamma", "beta")):
        w = np.asarray(w)
        got = a.grad.numpy().T if name == "w2" else a.grad.numpy()
        np.testing.assert_allclose(got, w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def _jax_block(C, heads, init_values, x):
    blk = jl.Block(dim=C, num_heads=heads, qk_norm=False, rope=None,
                   init_values=init_values, dtype=jnp.float32, fused_tail=True)
    variables = blk.init(jax.random.PRNGKey(0), x)
    # perturb every leaf so unit scales, zero biases and equal LayerScale
    # gains are not special cases
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(1)
    leaves = [v + 0.05 * rng.normal(size=v.shape).astype(np.float32) for v in leaves]
    return blk, jax.tree_util.tree_unflatten(tree, [jnp.asarray(v) for v in leaves])


@pytest.mark.parametrize("init_values", [None, 0.01])
@pytest.mark.parametrize("site", ["mlp", "proj", "both"])
def test_block_tail_matches_jax_fused_block(monkeypatch, site, init_values):
    """Block(mlp_tail=site) at 1,024 rows against the JAX Block with
    fused_tail=True under VITSLAM_MLP_TAIL (kernel in interpret mode), the
    setting of TestBlockFusedTail, within 2e-4."""
    rng = np.random.default_rng(7)
    C, heads = 256, 4
    x = rng.normal(size=(2, 512, C)).astype(np.float32)
    blk, variables = _jax_block(C, heads, init_values, jnp.asarray(x))
    monkeypatch.setenv("VITSLAM_MLP_TAIL", ENV[site])
    with pltpu.force_tpu_interpret_mode():
        want = blk.apply(variables, jnp.asarray(x))
    port = tl.Block(C, heads, qk_norm=False, init_values=init_values, mlp_tail=site)
    load_jax_params(port, export_torch_style(variables))
    calls = []
    real = tl.mlp_tail
    monkeypatch.setattr(tl, "mlp_tail", lambda *a, **k: calls.append(k["ln"]) or real(*a, **k))
    with torch.no_grad():
        got = port(torch.tensor(x))
    assert sorted(calls) == sorted({"mlp": [False], "proj": [True],
                                    "both": [False, True]}[site])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BLOCK_TOL, rtol=BLOCK_TOL)


@pytest.mark.parametrize("rows,launched", [(1023, 0), (1024, 2)])
def test_tails_engage_from_1024_rows(monkeypatch, rows, launched):
    """The gate counts the block input's rows: below TAIL_MIN_ROWS the
    block keeps its unfused tails (and then equals mlp_tail="off")."""
    C = 64
    blk = tl.init_weights(tl.Block(C, 2, qk_norm=False, init_values=0.01, mlp_tail="both"),
                          torch.Generator().manual_seed(0))
    off = tl.Block(C, 2, qk_norm=False, init_values=0.01)
    off.load_state_dict(blk.state_dict())
    calls = []
    real = tl.mlp_tail
    monkeypatch.setattr(tl, "mlp_tail", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.tensor(np.random.default_rng(0).normal(size=(1, rows, C)), dtype=torch.float32)
    with torch.no_grad():
        got = blk(x)
        want = off(x)
    assert len(calls) == launched
    if not launched:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tl.TAIL_MIN_ROWS == jl._TAIL_MIN_ROWS == 1024


def test_parameters_unchanged_by_tails():
    """mlp_tail adds and renames no parameter (io/from_jax.py loads the same
    tree), for a block and for a whole model."""
    from vitslam_tpu_torch.models import FeatureAlignedVGGT

    for site in ("mlp", "proj", "both"):
        a = tl.Block(64, 2, init_values=0.01, rope="2d", mlp_tail=site)
        b = tl.Block(64, 2, init_values=0.01, rope="2d")
        assert [(n, p.shape) for n, p in a.named_parameters()] == \
            [(n, p.shape) for n, p in b.named_parameters()]
    kw = dict(img_size=28, patch_size=14, embed_dim=32, depth=1, num_heads=2,
              patch_embed_depth=1, intermediate_layers=(0, 0, 0, 0), align_embed_dim=32,
              align_dec_dim=16, num_memory_tokens=2, dtype=torch.float32)
    a = FeatureAlignedVGGT(**kw, mlp_tail="both")
    b = FeatureAlignedVGGT(**kw)
    assert [(n, p.shape) for n, p in a.named_parameters()] == \
        [(n, p.shape) for n, p in b.named_parameters()]
    with pytest.raises(ValueError):
        tl.Block(64, 2, mlp_tail="on")


def test_wrapper_rejects_what_it_cannot_run():
    h, w2, b2, res, g, b = _port_args(*_inputs(4, 64, 128))
    with pytest.raises(ValueError):  # LayerNorm without its params
        mlp_tail(h, w2, b2, res)
    with pytest.raises(ValueError):  # neither cpu nor cuda
        mlp_tail(h.to("meta"), w2, b2, res, g, b)
