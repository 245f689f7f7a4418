"""Port parity for K2 (ops/fused_attention.py::flat_flash_attention): the
port's plain version against the JAX package's plain reference
(``_flat_reference``) and the wrapper on the CPU against the JAX Pallas
kernel in interpret mode, mirroring tests/test_fused_attention.py's
TestFlatFlashLargeN (large N, ragged tail, cross length). The CUDA kernel
itself is tested in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vitslam_tpu.ops.fused_attention import _flat_reference  # noqa: E402
from vitslam_tpu.ops.fused_attention import flat_flash_attention as jax_flat  # noqa: E402
from vitslam_tpu_torch.ops.fused_attention import (  # noqa: E402
    flat_flash_attention,
    flat_flash_attention_plain,
)
from torch_weights import shared_jax_cache  # noqa: E402,F401

torch.set_num_threads(2)
H, DH = 2, 64


def _qkv(nq, nk, seed=0, B=1):
    rng = np.random.default_rng(seed)
    C = H * DH
    return tuple(rng.normal(size=(B, n, C)).astype(np.float32) for n in (nq, nk, nk))


@pytest.mark.parametrize("nq,nk,dtype", [
    (300, 700, np.float32), (700, 300, np.float32), (257, 513, jnp.bfloat16),
])
def test_plain_matches_jax_reference(nq, nk, dtype):
    """Same pre-scaled inputs through both plain versions. fp32: sums in
    another order, within 1e-5. bf16: the same rounding points (logits fp32,
    P cast to bf16 before P V, bf16 output), within one bf16 ulp of O(1)
    outputs (1e-2)."""
    q, k, v = _qkv(nq, nk, seed=1, B=2)
    q = q * 0.18  # ~ scale * log2(e) at dh 64
    want = _flat_reference(*(jnp.asarray(x, dtype) for x in (q, k, v)), num_heads=H)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = flat_flash_attention_plain(*(torch.tensor(x).to(tdt) for x in (q, k, v)), num_heads=H)
    assert got.dtype == tdt and got.shape == (2, nq, H * DH)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-5 if dtype == np.float32 else 1e-2, rtol=0)


@pytest.mark.parametrize("nq,nk", [
    (4352, 4352),   # large N: several 1024-key blocks on the TPU
    (4250, 4250),   # ragged tail: the TPU kernel subtracts the pad mass
    (640, 4352),    # cross length, the KV-merged shape
])
def test_wrapper_matches_jax_kernel_interpret(nq, nk):
    """fp32 inputs: the Pallas kernel rounds q (after the scale fold), k, v
    and P to bf16 inside, the port's CPU path does not; 2e-2 is the
    tolerance TestFlatFlashLargeN holds that kernel to against exact
    softmax attention for the same reason."""
    q, k, v = _qkv(nq, nk, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=H,
                        static_max=16.0)
    before = flat_flash_attention.launches
    got = flat_flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               num_heads=H, static_max=16.0)
    assert flat_flash_attention.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_wrapper_on_cpu_is_exact_softmax_attention():
    """On the CPU the wrapper folds scale * log2(e) into q in fp32 and keeps
    fp32: it equals softmax(q k^T / sqrt(dh)) v per head within 1e-5, with
    v a strided slice of a packed projection, as the model passes it."""
    q, k, _ = _qkv(300, 500, seed=3)
    packed = np.random.default_rng(4).normal(size=(1, 500, 3 * H * DH)).astype(np.float32)
    v = torch.tensor(packed)[..., 2 * H * DH:]
    got = flat_flash_attention(torch.tensor(q), torch.tensor(k), v, num_heads=H,
                               static_max=24.0)
    split = lambda x: np.asarray(x).reshape(1, x.shape[1], H, DH).transpose(0, 2, 1, 3)
    s = np.einsum("bhqd,bhkd->bhqk", split(q), split(k)) / np.sqrt(DH)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bhkd->bhqd", p, split(v.numpy())).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want.reshape(1, 300, H * DH), atol=1e-5)
