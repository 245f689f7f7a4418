"""Port parity for K3's lse output and the flash backward (K4,
ops/flash_attention.py): the port's plain versions and autograd through
the port's ``flash_attention`` on the CPU, against the JAX package's Pallas
kernels in interpret mode, on tests/test_flash_bwd.py's cases (ragged,
cross, bounded and online max) at head dims 32, 64 and 128. fp32 on both
sides; atol 2e-4, rtol 1e-3, the JAX tests' own tolerance for the flash
backward against XLA autodiff. The CUDA kernels are tested in
test_torch_cuda.py."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vitslam_tpu_torch.ops import attention as tattn  # noqa: E402
from vitslam_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_lse,
    flash_attention_plain,
    flash_attention_reference,
)

# the module, not the function that vitslam_tpu.ops re-exports under its name
jfa = importlib.import_module("vitslam_tpu.ops.flash_attention")
torch.set_num_threads(2)
ATOL, RTOL = 2e-4, 1e-3

CASES = [  # (nq, nk, static_max, head dim)
    (130, 130, 6.0, 32),     # ragged single-K, bounded (test_flash_bwd.py)
    (130, 130, None, 32),    # ragged single-K, online max
    (256, 640, None, 32),    # cross-attention, streaming K
    (640, 256, 6.0, 32),     # more queries than keys
    (130, 130, None, 64),    # the backbone's head dim
    (640, 256, 6.0, 64),
    (130, 130, 6.0, 128),    # the AlignmentHead's head dim
    (256, 640, None, 128),
]


def _qkv(nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(1, 2, n, d)).astype(np.float32) for n in (nq, nk, nk))


def _loss(out):
    return out.sin().sum() if isinstance(out, torch.Tensor) else jnp.sum(jnp.sin(out))


@pytest.mark.parametrize("nq,nk,static_max,d", CASES)
def test_autograd_matches_jax_flash_backward(nq, nk, static_max, d):
    """d/dq, d/dk, d/dv of sum(sin(attention)) through the port's
    flash_attention (the CPU runs the plain forward with lse and the plain
    FA2 backward) against jax.grad through the JAX flash_attention, whose
    VJP is the Pallas K4 kernels (interpret mode, blocks of 128)."""
    q, k, v = _qkv(nq, nk, d, seed=0)
    flash = lambda q, k, v: _loss(jfa.flash_attention(  # noqa: E731
        q, k, v, static_max=static_max, block_q=128, block_k=128))
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(flash, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = flash_attention_backward.launches
    _loss(flash_attention(tq, tk, tv, static_max=static_max)).backward()
    assert flash_attention_backward.launches == before  # the CPU runs the plain version
    for t, w, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("nq,nk,static_max,d", CASES)
def test_lse_and_plain_backward_match_jax_kernels(nq, nk, static_max, d):
    """K3's lse output against ``_flash_forward(..., with_lse=True)`` and the
    plain FA2 backward against ``_flash_backward`` on the same residuals
    (out, lse) and cotangent, both Pallas kernels in interpret mode."""
    q, k, v = (x[0] for x in _qkv(nq, nk, d, seed=1))  # (BH, N, D)
    scale = 1.0 / np.sqrt(d)
    smax = jnp.asarray([static_max or 0.0], jnp.float32)
    g = np.random.default_rng(2).normal(size=(2, nq, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jax.jit(lambda q, k, v: jfa._flash_forward(
            q, k, v, smax, scale, 128, 128, static_max is not None, with_lse=True))(q, k, v)
        want = jax.jit(lambda *a: jfa._flash_backward(*a, scale))(
            q, k, v, out, lse, jnp.asarray(g))
    t_out, t_lse = flash_attention_lse(*(torch.tensor(x)[None] for x in (q, k, v)),
                                       static_max=static_max)
    np.testing.assert_allclose(t_lse[0].numpy(), np.asarray(lse)[..., 0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(out), atol=ATOL, rtol=RTOL)
    got = flash_attention_backward_plain(
        *(torch.tensor(np.asarray(x)) for x in (q, k, v, out)),
        torch.tensor(np.asarray(lse)[..., 0]), torch.tensor(g))
    for t, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


def test_plain_versions_agree_with_autograd_through_plain_attention():
    """The plain lse is log2(sum exp2(logits)) and the plain FA2 backward
    equals torch autograd through flash_attention_plain, with query rows
    taken in several blocks (PLAIN_MAX_LOGITS lowered) so that dk and dv sum
    over blocks; the reference route (plain forward and backward) gives the
    same gradients. fp32 through two summation orders: within 1e-5."""
    tfa = importlib.import_module("vitslam_tpu_torch.ops.flash_attention")
    q, k, v = (torch.tensor(x) for x in _qkv(90, 70, 16, seed=3))
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((flash_attention_plain(*leaves) * w).sum(), leaves)
    keep = tfa.PLAIN_MAX_LOGITS
    tfa.PLAIN_MAX_LOGITS = 2 * 70 * 25  # blocks of 25 query rows
    try:
        out, lse = flash_attention_plain(q, k, v, with_lse=True)
        got = flash_attention_backward_plain(q, k, v, out, lse, w)
        ref = torch.autograd.grad((flash_attention_reference(*leaves) * w).sum(), leaves)
    finally:
        tfa.PLAIN_MAX_LOGITS = keep
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0 * tfa.LOG2E
    torch.testing.assert_close(lse, torch.log2(torch.exp2(s).sum(-1)), atol=1e-5, rtol=0)
    for g, r, wnt in zip(got, ref, want):
        torch.testing.assert_close(g, wnt, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(r, wnt, atol=1e-5, rtol=1e-5)


def test_route_switch_and_lse_output():
    """``plain_attention_routes`` maps the kernel routes around the kernels
    (fused/flat -> plain, flash -> reference) and restores them after; the
    public ``with_lse`` output is the lse of flash_attention_lse, also when
    a gradient is taken."""
    assert tattn.attention_route(600, 600, fusable=False, fast=False) == "flash"
    with tattn.plain_attention_routes():
        assert tattn.attention_route(600, 600, fusable=False, fast=False) == "reference"
        assert tattn.attention_route(400, 400, fusable=True, fast=True) == "plain"
        assert tattn.attention_route(5000, 5000, fusable=False, fast=True) == "plain"
    with tattn.plain_attention_routes(False):
        assert tattn.attention_route(5000, 5000, fusable=False, fast=True) == "flat"
    assert tattn.attention_route(400, 400, fusable=True, fast=True) == "fused"
    q, k, v = (torch.tensor(x) for x in _qkv(40, 600, 32, seed=4))
    out, lse = flash_attention(q, k, v, with_lse=True)
    want_out, want_lse = flash_attention_lse(q, k, v)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    qg = q.clone().requires_grad_()
    out_g, lse_g = flash_attention(qg, k, v, with_lse=True)
    assert out_g.grad_fn is not None and not lse_g.requires_grad
    torch.testing.assert_close(lse_g, want_lse, atol=0, rtol=0)
