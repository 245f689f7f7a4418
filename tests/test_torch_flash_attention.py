"""Port parity for the K3 forward (ops/flash_attention.py): the port's plain
version against the JAX package's ``_xla_attention``, and the wrapper on the
CPU against the JAX Pallas kernel in interpret mode, bounded (fixed shift)
and online max, self and cross, mirroring tests/test_nn.py's flash cases.
The CUDA kernel itself is tested in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vitslam_tpu.ops.flash_attention import _xla_attention  # noqa: E402
from vitslam_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from vitslam_tpu_torch.ops import attention as tattn  # noqa: E402
from vitslam_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from torch_weights import shared_jax_cache  # noqa: E402,F401

torch.set_num_threads(2)


def _qkv(B, H, nq, nk, seed, gain=1.0):
    rng = np.random.default_rng(seed)
    return (gain * rng.normal(size=(B, H, nq, 64)).astype(np.float32),
            gain * rng.normal(size=(B, H, nk, 64)).astype(np.float32),
            rng.normal(size=(B, H, nk, 64)).astype(np.float32))


@pytest.mark.parametrize("nq,nk,dtype", [
    (300, 337, np.float32), (337, 300, np.float32), (200, 600, jnp.bfloat16),
])
def test_plain_matches_xla_attention(nq, nk, dtype):
    """(B*H, N, D) through both plain versions. fp32: sums in another order,
    within 1e-5. bf16: the same rounding points (fp32 logits, P cast to bf16
    before P V, bf16 output), within one bf16 ulp of O(1) outputs (1e-2)."""
    q, k, v = (x.reshape(-1, x.shape[2], 64) for x in _qkv(2, 2, nq, nk, seed=1))
    want = _xla_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), 0.125)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = flash_attention_plain(*(torch.tensor(x).to(tdt) for x in (q, k, v)), 0.125)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-5 if dtype == np.float32 else 1e-2, rtol=0)


@pytest.mark.parametrize("nq,nk,smax,gain", [
    (300, 337, None, 1.0),    # online max, cross (test_flash_matches_xla_interpret)
    (200, 233, 24.0, 1.0),    # fixed shift (test_flash_static_max_matches_xla)
    (150, 170, "true", 2.5),  # logits past 24, shift = true max + 1 (traced-shift case)
    (640, 600, 24.0, 1.0),    # several q and k blocks, self length
])
def test_wrapper_matches_jax_kernel_interpret(nq, nk, smax, gain):
    """fp32 on both sides (the Pallas kernel keeps fp32 inputs in fp32 here),
    blocks of 128 as in the JAX tests: within 3e-5, the JAX tests' own
    tolerance for this kernel against XLA attention."""
    q, k, v = _qkv(1, 2, nq, nk, seed=2, gain=gain)
    if smax == "true":
        true_max = float(np.abs(np.einsum("bhqd,bhkd->bhqk", q, k)).max()) / 8.0
        assert true_max > 24.0
        smax = true_max + 1.0
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda q, k, v: jax_flash(q, k, v, block_q=128, block_k=128,
                                                 static_max=smax))(q, k, v)
    before = flash_attention.launches
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), static_max=smax)
    assert flash_attention.launches == before  # the CPU runs the plain version
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_flash_route_and_unported_lse():
    """The flash route of the dispatch is K3 (the plain version on the CPU);
    the lse output, needed by the backward, is the plain version's: the log2
    of the row sums of the exp2-domain logits (test_torch_flash_bwd.py holds
    it to the JAX kernel)."""
    q, k, v = (torch.tensor(x) for x in _qkv(1, 2, 8, 600, seed=3))
    torch.testing.assert_close(
        tattn.scaled_dot_product_attention(q, k, v, route="flash", static_max=24.0),
        flash_attention_plain(q, k, v), atol=0, rtol=0)
    out, lse = flash_attention(q, k, v, with_lse=True)
    want_out, want_lse = flash_attention_plain(q, k, v, with_lse=True)
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    assert lse.shape == (1, 2, 8) and lse.dtype == torch.float32
    with pytest.raises(ValueError):
        tattn.scaled_dot_product_attention(q, k, v, route="flat")
