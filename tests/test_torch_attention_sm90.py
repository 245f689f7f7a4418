"""CPU checks of the pieces around the port's Hopper attention core
(csrc/attention_fwd_sm90.cuh, csrc/fused_attention.cu) that do not need the
card: K1's prep as its plain version computes it (``qk_prep_plain``) against
the JAX package's own LayerNorm + RoPE, and the tensor-map geometry the
kernels derive from a tensor view (``tma_geometry``) on the layouts the
wrappers hand them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vitslam_tpu.nn.layers import HeadLayerNorm as JaxHeadLayerNorm  # noqa: E402
from vitslam_tpu.nn.rope import apply_rope_flat as jax_apply_rope_flat  # noqa: E402
from vitslam_tpu.nn.rope import patch_grid_positions as jax_grid  # noqa: E402
from vitslam_tpu.nn.rope import rope_cache_1d as jax_rope_cache_1d  # noqa: E402
from vitslam_tpu.nn.rope import rope_cache_2d as jax_rope_cache_2d  # noqa: E402
from vitslam_tpu.ops.fused_attention import _fused_reference  # noqa: E402
from vitslam_tpu_torch.ops.flash_attention import LOG2E, q_fold, tma_geometry  # noqa: E402
from vitslam_tpu_torch.ops.fused_attention import (  # noqa: E402
    _heads,
    fused_qkv_attention_plain,
    qk_prep,
    qk_prep_plain,
)

torch.set_num_threads(2)

H, DH = 3, 64


def _inputs(nsplit, with_ln, with_rope, seed=0, B=2, N=37):
    """numpy qkv, a RoPE cache (2-D on a patch grid for nsplit 2, 1-D for
    nsplit 1) and LayerNorm params (scale, bias) for q and k."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3 * H * DH)).astype(np.float32)
    cos = sin = q_ln = k_ln = None
    if with_rope:
        if nsplit == 2:
            pos = jnp.asarray(np.asarray(jax_grid(B, 4, -(-N // 4), 1))[:, :N])
            c, s, _ = jax_rope_cache_2d(pos, DH)
        else:
            c, s, _ = jax_rope_cache_1d(jnp.asarray(np.tile(np.arange(N), (B, 1))), DH)
        cos, sin = np.asarray(c, np.float32), np.asarray(s, np.float32)
    if with_ln:
        q_ln, k_ln = [(rng.normal(1, 0.2, DH).astype(np.float32),
                       rng.normal(0, 0.2, DH).astype(np.float32)) for _ in range(2)]
    return qkv, cos, sin, q_ln, k_ln


def _jax_prep(x, ln, cos, sin, nsplit, fold):
    """The JAX package's flat route: HeadLayerNorm(flat=True) (fp32 out),
    then apply_rope_flat in fp32, then the fold, all in fp32."""
    xf = jnp.asarray(x, jnp.float32)
    if ln is not None:
        mod = JaxHeadLayerNorm(num_heads=H, head_dim=DH, dtype=jnp.float32)
        xf = mod.apply({"params": {"scale": jnp.asarray(ln[0]), "bias": jnp.asarray(ln[1])}},
                       xf, flat=True)
    if cos is not None:
        xf = jax_apply_rope_flat(xf, jnp.asarray(cos), jnp.asarray(sin), H, nsplit)
    return np.asarray(xf * fold, np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _torch_kw(cos, sin, q_ln, k_ln, nsplit):
    kw = dict(num_heads=H, nsplit=nsplit)
    if cos is not None:
        kw.update(cos=torch.tensor(cos), sin=torch.tensor(sin))
    if q_ln is not None:
        kw.update(q_ln=tuple(map(torch.tensor, q_ln)), k_ln=tuple(map(torch.tensor, k_ln)))
    return kw


@pytest.mark.parametrize("nsplit,with_ln,with_rope", [
    (2, True, True), (1, True, True), (2, False, True), (1, False, True),
    (2, True, False), (2, False, False),
])
def test_qk_prep_plain_matches_jax_flat_route_fp32(nsplit, with_ln, with_rope):
    """fp32: q^ = fold * RoPE(LN(q)), k^ = RoPE(LN(k)) against the JAX
    package's HeadLayerNorm(flat=True) + apply_rope_flat; the JAX LayerNorm
    takes its statistics through pooling matmuls, so the two differ by
    fp32 summation order only: rel-L2 <= 1e-5."""
    qkv, cos, sin, q_ln, k_ln = _inputs(nsplit, with_ln, with_rope)
    C = H * DH
    fold = q_fold(DH)
    q_hat, k_hat = qk_prep_plain(torch.tensor(qkv), **_torch_kw(cos, sin, q_ln, k_ln, nsplit),
                                 fold=fold)
    assert q_hat.dtype == torch.float32 and q_hat.shape == (2, 37, C)
    want_q = _jax_prep(qkv[..., :C], q_ln, cos, sin, nsplit, fold)
    want_k = _jax_prep(qkv[..., C:2 * C], k_ln, cos, sin, nsplit, 1.0)
    assert _rel_l2(q_hat.numpy(), want_q) <= 1e-5
    assert _rel_l2(k_hat.numpy(), want_k) <= 1e-5


@pytest.mark.parametrize("nsplit,with_ln,with_rope", [
    (2, True, True), (1, True, True), (2, False, False),
])
def test_qk_prep_plain_matches_jax_flat_route_bf16(nsplit, with_ln, with_rope):
    """bf16 qkv: both sides compute in fp32 from the same bf16 inputs and
    round once to bf16, so each element is the same bf16 value or one ulp
    apart where the fp32 values straddle a rounding boundary: elementwise
    within 2^-7 relative (one bf16 ulp) and 1e-6 absolute, and at most 1%
    of the elements differ at all."""
    qkv, cos, sin, q_ln, k_ln = _inputs(nsplit, with_ln, with_rope, seed=1)
    x = torch.tensor(qkv).to(torch.bfloat16)
    C = H * DH
    fold = q_fold(DH)
    q_hat, k_hat = qk_prep_plain(x, **_torch_kw(cos, sin, q_ln, k_ln, nsplit), fold=fold)
    assert q_hat.dtype == torch.bfloat16 and k_hat.dtype == torch.bfloat16
    xs = x.float().numpy()
    for got, part, ln, f in ((q_hat, xs[..., :C], q_ln, fold), (k_hat, xs[..., C:2 * C], k_ln, 1.0)):
        want = torch.tensor(_jax_prep(part, ln, cos, sin, nsplit, f)).to(torch.bfloat16).float()
        g = got.float()
        torch.testing.assert_close(g, want, atol=1e-6, rtol=2.0 ** -7)
        assert (g != want).float().mean().item() <= 1e-2


@pytest.mark.parametrize("nsplit", [1, 2])
def test_fused_plain_is_prep_then_attention(nsplit):
    """K1's plain version, rebuilt as qk_prep_plain -> flash_attention_plain
    on the exp2 scale, against the JAX package's fp32 pieces end to end: its
    flat-route LayerNorm + RoPE (the prep of ``_fused_reference``) and a
    softmax attention in fp32 (``_fused_reference`` itself rounds q and k to
    bf16, which test_torch_fused_attention.py holds at 1e-2). Within 1e-5:
    the fold of log2(e) into q and its division out of the logits are fp32
    roundings, for both RoPE splits."""
    import jax

    qkv, cos, sin, q_ln, k_ln = _inputs(nsplit, True, True, seed=2)
    B, N, _ = qkv.shape
    C = H * DH
    q = _jax_prep(qkv[..., :C], q_ln, cos, sin, nsplit, 1.0).reshape(B, N, H, DH)
    k = _jax_prep(qkv[..., C:2 * C], k_ln, cos, sin, nsplit, 1.0).reshape(B, N, H, DH)
    v = qkv[..., 2 * C:].reshape(B, N, H, DH)
    p = jax.nn.softmax(jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(DH), axis=-1)
    want = np.asarray(jnp.einsum("bhqk,bkhd->bqhd", p, v)).reshape(B, N, C)
    got = fused_qkv_attention_plain(torch.tensor(qkv), **_torch_kw(cos, sin, q_ln, k_ln, nsplit))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # and the JAX oracle of the fused kernel, whose bf16 q/k rounding is the
    # only difference left (the tolerance the JAX package holds its kernel to)
    ref = _fused_reference(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                           *map(jnp.asarray, q_ln), *map(jnp.asarray, k_ln), num_heads=H,
                           scale=1.0 / np.sqrt(DH), nsplit=nsplit, do_ln=True, do_rope=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2, rtol=2e-2)


def test_qk_prep_on_cpu_runs_the_plain_version():
    """A CPU tensor goes to the plain version (no launch counted); without
    LayerNorm and RoPE k^ is the k slice of qkv itself, not a copy."""
    qkv, cos, sin, q_ln, k_ln = _inputs(2, True, True, seed=3)
    x = torch.tensor(qkv)
    before = qk_prep.launches
    got = qk_prep(x, **_torch_kw(cos, sin, q_ln, k_ln, 2), fold=0.5)
    want = qk_prep_plain(x, **_torch_kw(cos, sin, q_ln, k_ln, 2), fold=0.5)
    assert qk_prep.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    q_hat, k_hat = qk_prep(x, num_heads=H, fold=LOG2E / 8)
    assert k_hat.data_ptr() == x[..., H * DH:].data_ptr()
    torch.testing.assert_close(q_hat, x[..., :H * DH] * (LOG2E / 8), atol=0, rtol=0)


# ---- tma_geometry: the tensor maps of the wrappers' real layouts ----

def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tma_geometry_k1_slices_of_packed_qkv():
    """K1: q^ and k^ scratch (B, N, C) and the v slice of the packed
    (B, N, 3C) qkv at row stride 3C, as (B, H, N, 64) head views."""
    B, N, heads = 3, 412, 16
    C = heads * 64
    qkv = _bf16(B, N, 3 * C)
    v = _heads(qkv[..., 2 * C:], heads)
    geo = tma_geometry(v)
    assert geo["dims"] == (64, N, heads, B)
    assert geo["strides"] == (3 * C * 2, 64 * 2, N * 3 * C * 2)
    assert geo["box"] == (64, 128, 1, 1) and geo["swizzle"] == 128
    q_hat = _heads(_bf16(B, N, C), heads)
    assert tma_geometry(q_hat)["strides"] == (C * 2, 128, N * C * 2)
    k_slice = _heads(qkv[..., C:2 * C], heads)  # k^ without LN / RoPE
    assert tma_geometry(k_slice)["strides"] == (3 * C * 2, 128, N * 3 * C * 2)


def test_tma_geometry_k2_flat_heads_and_k3_transposed_views():
    """K2's flat (B, N, C) head views, K3's (B, H, N, D) views of
    (B, N, H, D) buffers (its output and the head's q/k/v), and D 128."""
    flat = _heads(_bf16(1, 30900, 1024), 16)
    assert tma_geometry(flat) == dict(dims=(64, 30900, 16, 1), strides=(2048, 128, 2048),
                                      box=(64, 128, 1, 1), swizzle=128)
    bnhd = _bf16(2, 2060, 16, 64).transpose(1, 2)
    assert tma_geometry(bnhd)["strides"] == (16 * 64 * 2, 128, 2060 * 16 * 64 * 2)
    d128 = _bf16(1, 10738, 8, 128).transpose(1, 2)
    geo = tma_geometry(d128)
    assert geo["dims"] == (128, 10738, 8, 1)
    assert geo["strides"] == (8 * 128 * 2, 256, 8 * 128 * 2)
    contiguous = _bf16(2, 4, 300, 128)
    assert tma_geometry(contiguous)["strides"] == (256, 300 * 256, 4 * 300 * 256)


def test_tma_geometry_raises_on_what_tma_does_not_take():
    with pytest.raises(ValueError, match="base address"):  # base 2 bytes off
        tma_geometry(_heads(_bf16(1, 100, 3 * 1024 + 8)[..., 1:1025], 16))
    with pytest.raises(ValueError, match="multiples of 16"):  # row of 1,028 elements
        tma_geometry(_heads(_bf16(1, 100, 1028)[..., :1024], 16))
    with pytest.raises(ValueError, match="contiguous head dim"):
        tma_geometry(_bf16(1, 2, 64, 100).transpose(-1, -2))
    with pytest.raises(ValueError, match="D in"):  # head dim 96
        tma_geometry(_bf16(1, 2, 100, 96))
    with pytest.raises(ValueError, match="multiples of 16"):  # an expanded (stride 0) head
        tma_geometry(_bf16(1, 1, 100, 64).expand(1, 4, 100, 64))
