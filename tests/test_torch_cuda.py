"""Tests of the port that need an NVIDIA GPU: the hand-written CUDA
kernels against their plain PyTorch versions. They import no JAX, so they
also run on a machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: the suite's conftest imports JAX.) Without a card they
skip."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vitslam_tpu_torch.nn.layers import qk_shift_from  # noqa: E402
from vitslam_tpu_torch.nn.rope import patch_grid_positions, rope_cache_2d  # noqa: E402
from vitslam_tpu_torch.ops.fused_attention import (  # noqa: E402
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
