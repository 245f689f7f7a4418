"""Tests of the port that need an NVIDIA GPU: the hand-written CUDA
kernels (K1, K2, K3) against their plain PyTorch versions, and the presets'
default device. They import no JAX, so they
also run on a machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: the suite's conftest imports JAX.) Without a card they
skip."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vitslam_tpu_torch.models import small_feature_aligned  # noqa: E402
from vitslam_tpu_torch.nn.layers import qk_shift_from  # noqa: E402
from vitslam_tpu_torch.nn.rope import patch_grid_positions, rope_cache_2d  # noqa: E402
from vitslam_tpu_torch.ops.flash_attention import (  # noqa: E402
    LOG2E,
    flash_attention,
    flash_attention_plain,
)
from vitslam_tpu_torch.ops.fused_attention import (  # noqa: E402
    flat_flash_attention,
    flat_flash_attention_plain,
    fused_qkv_attention,
    fused_qkv_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,nq,with_ln,with_rope,bounded", [
    (5, 412, False, False, False),   # patch embed: online max
    (5, 412, True, True, True),      # frame attention
    (2, 1000, True, True, True),     # ragged
    (1, 2060, True, True, True),     # global attention
    (2, 130, True, True, False),     # LN + RoPE with an online max
])
def test_k1_kernel_matches_plain(cuda, B, nq, with_ln, with_rope, bounded):
    """K1 against the plain version in bf16 on the card, elementwise within
    2e-2 + 2e-2 * |plain| (as in chip_smoke.py: bf16 output ulps, q rounded
    after the scale fold, bf16 P, summation order)."""
    rng = np.random.default_rng(3)
    heads, dh = 16, 64
    C = heads * dh
    x = torch.tensor(rng.normal(size=(B, nq, 3 * C)), dtype=torch.float32,
                     device=cuda).to(torch.bfloat16)
    kw = dict(num_heads=heads)
    if with_ln:
        ln = [(torch.tensor(rng.normal(1, 0.1, dh), dtype=torch.float32, device=cuda),
               torch.tensor(rng.normal(0, 0.1, dh), dtype=torch.float32, device=cuda))
              for _ in range(2)]
        kw.update(q_ln=ln[0], k_ln=ln[1])
        if bounded:
            kw["static_max"] = qk_shift_from(ln[0], ln[1], dh)
    if with_rope:
        pos = patch_grid_positions(B, 11, -(-nq // 11), 0, cuda)[:, :nq]
        cos, sin, nsplit = rope_cache_2d(pos, dh)
        kw.update(cos=cos.to(torch.bfloat16), sin=sin.to(torch.bfloat16), nsplit=nsplit)
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(x, **kw)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    want = fused_qkv_attention_plain(x, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_k1_rejects_what_it_does_not_take(cuda):
    """On a CUDA tensor the wrapper launches or raises: no silent fallback."""
    x = torch.zeros((1, 412, 3 * 128), device=cuda, dtype=torch.float32)
    with pytest.raises(TypeError):
        fused_qkv_attention(x, num_heads=2)
    with pytest.raises(ValueError):  # head dim 32
        fused_qkv_attention(x.to(torch.bfloat16), num_heads=4)
    with pytest.raises(ValueError):  # more than 4096 tokens
        fused_qkv_attention(torch.zeros((1, 4100, 3 * 128), device=cuda,
                                        dtype=torch.bfloat16), num_heads=2)


def _bf16(rng, shape, device, scale=1.0):
    return (scale * torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                                 device=device)).to(torch.bfloat16)


@pytest.mark.parametrize("B,nq,nk", [
    (1, 4352, 4352),   # just above the fused window
    (1, 4250, 4250),   # ragged K tail
    (1, 640, 4352),    # cross length (KV-merged shape)
    (2, 4200, 5000),   # batched, both tails ragged
])
def test_k2_kernel_matches_plain(cuda, B, nq, nk):
    """K2 against its plain version on the same scaled q, in bf16, within
    2e-2 + 2e-2 * |plain| (bf16 output ulps, P rounded to bf16 before P V,
    summation order). v is a strided slice of a packed projection, as the
    model passes it."""
    rng = np.random.default_rng(4)
    heads, dh = 16, 64
    C = heads * dh
    q = _bf16(rng, (B, nq, C), cuda)
    k = _bf16(rng, (B, nk, C), cuda)
    v = _bf16(rng, (B, nk, 3 * C), cuda)[..., 2 * C:]
    before = flat_flash_attention.launches
    got = flat_flash_attention(q, k, v, num_heads=heads, static_max=24.0)
    torch.cuda.synchronize()
    assert flat_flash_attention.launches == before + 1
    qs = (q.float() * (LOG2E / 8.0)).to(torch.bfloat16)
    want = flat_flash_attention_plain(qs, k, v, num_heads=heads)
    assert got.shape == (B, nq, C) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,H,nq,nk,bounded", [
    (1, 16, 2060, 1474, True),   # KV-merged global attention, 5/1 at p2s2
    (2, 4, 300, 337, True),      # ragged self/cross
    (1, 8, 1379, 700, False),    # online max, cross
    (3, 2, 130, 4500, False),    # online max, many key tiles
])
def test_k3_kernel_matches_plain(cuda, B, H, nq, nk, bounded):
    """K3 against its plain version in bf16; the kernel folds
    scale * log2(e) into q and rounds it to bf16, which moves logits by
    ~2^-8 relative: 2e-2 + 2e-2 * |plain| as for K1."""
    rng = np.random.default_rng(5)
    q = _bf16(rng, (B, H, nq, 64), cuda)
    k = _bf16(rng, (B, H, nk, 64), cuda)
    v = _bf16(rng, (B, H, nk, 64), cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, static_max=24.0 if bounded else None)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v)
    assert got.shape == (B, H, nq, 64) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_k2_k3_reject_what_they_do_not_take(cuda):
    """On CUDA tensors the wrappers launch or raise: no silent fallback."""
    x = torch.zeros((1, 2, 600, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # fp32 keys
        flash_attention(x, x.float(), x)
    with pytest.raises(ValueError):  # head dim 32
        flash_attention(x[..., :32], x[..., :32], x[..., :32])
    with pytest.raises(NotImplementedError):  # the lse output: training slice
        flash_attention(x, x, x, with_lse=True)
    flat = torch.zeros((1, 4100, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 32
        flat_flash_attention(flat, flat, flat, num_heads=4, static_max=24.0)


def test_presets_default_to_the_gpu(cuda):
    """A preset built without ``device=`` lands on the card."""
    model = small_feature_aligned(embed_dim=128, num_heads=2, depth=1, patch_embed_depth=1,
                                  intermediate_layers=(0, 0, 0, 0), align_embed_dim=64,
                                  align_dec_dim=32, num_memory_tokens=4)
    assert {p.device.type for p in model.parameters()} == {"cuda"}
