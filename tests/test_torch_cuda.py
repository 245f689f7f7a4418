"""Tests of the port that need an NVIDIA GPU: the hand-written CUDA
kernels (K1 with its prep kernel, K2, K3 with its lse output, K4, K5)
against their plain PyTorch versions, the edges of the wgmma + TMA attention
core (short and ragged tiles, batch boundaries, strided views, the in-kernel
q fold), gradients through every kernel wrapper, the presets' default
device, the int8 projection (``torch._int_mm``) and a small TrackHead in
fp32 against the same computations on the CPU. They import no JAX, so they
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
    q_fold,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_lse,
    flash_attention_plain,
    flash_attention_reference,
)
from vitslam_tpu_torch.ops.fused_attention import (  # noqa: E402
    flat_flash_attention,
    flat_flash_attention_plain,
    fused_qkv_attention,
    fused_qkv_attention_plain,
    qk_prep,
    qk_prep_plain,
)
from vitslam_tpu_torch.ops.mlp_tail import mlp_tail, mlp_tail_plain  # noqa: E402

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
    before = (fused_qkv_attention.launches, qk_prep.launches)
    got = fused_qkv_attention(x, **kw)
    torch.cuda.synchronize()
    prepped = with_ln or with_rope  # the patch embed's K1 is the attention kernel alone
    assert (fused_qkv_attention.launches, qk_prep.launches) == (before[0] + 1,
                                                                before[1] + prepped)
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
    (1, 10300, 30900),  # sequence-parallel global attention: 25 of 75 frames' queries
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
    x96 = torch.zeros((1, 2, 600, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 96: the kernels take 64 and 128
        flash_attention(x96, x96, x96)
    flat = torch.zeros((1, 4100, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 32
        flat_flash_attention(flat, flat, flat, num_heads=4, static_max=24.0)


def test_presets_default_to_the_gpu(cuda):
    """A preset built without ``device=`` lands on the card."""
    model = small_feature_aligned(embed_dim=128, num_heads=2, depth=1, patch_embed_depth=1,
                                  intermediate_layers=(0, 0, 0, 0), align_embed_dim=64,
                                  align_dec_dim=32, num_memory_tokens=4)
    assert {p.device.type for p in model.parameters()} == {"cuda"}


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want).clamp_min(1e-12)).item()


@pytest.mark.parametrize("B,H,nq,nk,dh,bounded", [
    (1, 8, 1100, 1100, 128, True),   # the head's global attention: self, ragged
    (1, 8, 700, 1300, 128, False),   # cross, online max
    (2, 4, 300, 337, 64, True),      # ragged self/cross at the backbone's head dim
    (1, 16, 1000, 600, 64, False),   # more queries than keys, online max
])
def test_k3_lse_and_k4_match_plain(cuda, B, H, nq, nk, dh, bounded):
    """K3 with lse and K4 against their plain versions in fp32 on the
    query the kernels see (q * scale * log2(e) rounded to bf16, scaled
    back), on the same bf16 k, v, output and output gradient: what is left
    is P and dS rounded to bf16 before their products, bf16 outputs and the
    summation order. Elementwise 2e-2 + 2e-2 * |plain| and rel-L2 <= 1e-2
    (chip_smoke.py's criteria); lse within 2e-2 absolute."""
    rng = np.random.default_rng(6)
    q = _bf16(rng, (B, H, nq, dh), cuda, 2.0)
    k = _bf16(rng, (B, H, nk, dh), cuda)
    v = _bf16(rng, (B, H, nk, dh), cuda)
    fold = LOG2E / dh ** 0.5
    q_eff = (q.float() * fold).to(torch.bfloat16).float() / fold
    before = (flash_attention_lse.launches, flash_attention_backward.launches)
    out, lse = flash_attention_lse(q, k, v, static_max=24.0 if bounded else None)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_plain(q_eff, k, v, with_lse=True)
    assert out.shape == (B, H, nq, dh) and lse.shape == (B, H, nq)
    assert lse.dtype == torch.float32 and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=2e-2, rtol=0)
    dout = _bf16(rng, (B, H, nq, dh), cuda)
    got = flash_attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    want = flash_attention_backward_plain(q_eff, k, v, out, lse, dout)
    assert (flash_attention_lse.launches, flash_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2, msg=name)
        assert _rel_l2(g, w) <= 1e-2, name


def test_gradients_flow_through_k3_and_k4(cuda):
    """autograd through flash_attention on the card (K3 with lse, then K4)
    against the same loss through flash_attention_reference (the plain
    forward and backward), on strided (B, H, N, 128) views as the head's
    global attention passes them: rel-L2 <= 1e-2 per gradient."""
    rng = np.random.default_rng(7)
    B, H, N, dh = 1, 8, 900, 128
    x = _bf16(rng, (B, N, 3 * H * dh), cuda)
    q, k, v = (x[..., i * H * dh:(i + 1) * H * dh].reshape(B, N, H, dh).transpose(1, 2)
               .detach().requires_grad_() for i in range(3))
    w = _bf16(rng, (B, H, N, dh), cuda)
    before = (flash_attention_lse.launches, flash_attention_backward.launches)
    (flash_attention(q, k, v, static_max=24.0).float() * w.float()).sum().backward()
    got = [t.grad for t in (q, k, v)]
    assert (flash_attention_lse.launches, flash_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    for t in (q, k, v):
        t.grad = None
    (flash_attention_reference(q, k, v).float() * w.float()).sum().backward()
    for g, t, name in zip(got, (q, k, v), ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        assert _rel_l2(g, t.grad) <= 1e-2, (name, _rel_l2(g, t.grad))


def test_gradients_flow_through_k1_and_k2(cuda):
    """K1 and K2 on tensors that require grad keep their graph: the
    backward recomputes through the plain version, so the gradients equal
    those of the plain version itself (bf16, up to the forward's rounding:
    rel-L2 <= 1e-2)."""
    rng = np.random.default_rng(8)
    heads, dh = 16, 64
    C = heads * dh
    qkv = _bf16(rng, (1, 412, 3 * C), cuda).requires_grad_()
    ln = [tuple(torch.tensor(rng.normal(m, 0.1, dh), dtype=torch.float32, device=cuda)
                .requires_grad_() for m in (1.0, 0.0)) for _ in range(2)]
    pos = patch_grid_positions(1, 11, 38, 0, cuda)[:, :412]
    cos, sin, nsplit = rope_cache_2d(pos, dh)
    kw = dict(num_heads=heads, cos=cos, sin=sin, q_ln=ln[0], k_ln=ln[1], nsplit=nsplit,
              static_max=qk_shift_from(ln[0], ln[1], dh))
    w = _bf16(rng, (1, 412, C), cuda).float()
    leaves = [qkv, *ln[0], *ln[1]]
    before = fused_qkv_attention.launches
    got = torch.autograd.grad((fused_qkv_attention(qkv, **kw).float() * w).sum(), leaves)
    assert fused_qkv_attention.launches == before + 1
    want = torch.autograd.grad((fused_qkv_attention_plain(qkv, **kw).float() * w).sum(), leaves)
    for g, ref in zip(got, want):
        assert _rel_l2(g, ref) <= 1e-2

    q = _bf16(rng, (1, 4352, C), cuda).requires_grad_()
    k = _bf16(rng, (1, 4352, C), cuda).requires_grad_()
    v = _bf16(rng, (1, 4352, C), cuda).requires_grad_()
    w = _bf16(rng, (1, 4352, C), cuda).float()
    before = flat_flash_attention.launches
    got = torch.autograd.grad(
        (flat_flash_attention(q, k, v, num_heads=heads, static_max=24.0).float() * w).sum(),
        (q, k, v))
    assert flat_flash_attention.launches == before + 1

    def plain(q, k, v):
        return flat_flash_attention_plain((q.float() * (LOG2E / 8.0)).to(q.dtype), k, v,
                                          num_heads=heads)

    want = torch.autograd.grad((plain(q, k, v).float() * w).sum(), (q, k, v))
    for g, ref in zip(got, want):
        assert _rel_l2(g, ref) <= 1e-2


def _tail_inputs(rng, M, Fd, C, dev):
    """h, w2 (C, F), b2, res, gamma, beta at the backbone's scales: unit h
    and res, weights ~ 1/sqrt(F) (lecun), LayerScale-sized bias."""
    h = _bf16(rng, (M, Fd), dev)
    w2 = (torch.tensor(rng.normal(size=(C, Fd)) / np.sqrt(Fd), dtype=torch.float32,
                       device=dev)).to(torch.bfloat16)
    vec = lambda mu, sd: torch.tensor(rng.normal(mu, sd, C), dtype=torch.float32,  # noqa: E731
                                      device=dev)
    return h, w2, vec(0, 0.1), _bf16(rng, (M, C), dev), vec(1, 0.1), vec(0, 0.1)


@pytest.mark.parametrize("M,Fd,gelu,ln", [
    (2060, 4096, True, False),    # 5/1 mlp site
    (2060, 1024, False, True),    # 5/1 proj site
    (30900, 4096, True, False),   # 75/30 mlp site
    (30900, 1024, False, True),   # 75/30 proj site
    (77, 128, True, True),        # ragged M, both epilogues
    (333, 64, False, False),      # one K slice
])
def test_k5_kernel_matches_plain(cuda, M, Fd, gelu, ln):
    """K5 against the plain version in bf16 on the card, elementwise within
    2e-2 + 2e-2 * |plain| and rel-L2 <= 1e-2 per output (as in
    chip_smoke.py: both round x' and y to bf16 and sum F products in
    another order; y's statistics come from the fp32 x' on both sides)."""
    rng = np.random.default_rng(11)
    args = _tail_inputs(rng, M, Fd, 1024 if M > 1000 else 256, cuda)
    before = mlp_tail.launches
    got = mlp_tail(*args, gelu=gelu, ln=ln)
    torch.cuda.synchronize()
    assert mlp_tail.launches == before + 1
    want = mlp_tail_plain(*args, gelu=gelu, ln=ln)
    if not ln:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert _rel_l2(g, w) <= 1e-2


def test_k5_gradients_through_the_wrapper(cuda):
    """Autograd through K5: the backward recomputes through the plain
    version, so the gradients equal those of the plain version up to the
    forward's bf16 rounding (which does not enter them)."""
    rng = np.random.default_rng(12)
    args = [t.requires_grad_() for t in _tail_inputs(rng, 1100, 256, 256, cuda)]
    w = _bf16(rng, (1100, 256), cuda).float()
    before = mlp_tail.launches
    x, y = mlp_tail(*args, gelu=True, ln=True)
    assert mlp_tail.launches == before + 1
    got = torch.autograd.grad(((x.float() + y.float()) * w).sum(), args)
    xp, yp = mlp_tail_plain(*args, gelu=True, ln=True)
    want = torch.autograd.grad(((xp.float() + yp.float()) * w).sum(), args)
    for g, ref in zip(got, want):
        assert _rel_l2(g, ref) <= 1e-5


def test_k5_rejects_what_it_does_not_take(cuda):
    rng = np.random.default_rng(13)
    h, w2, b2, res, g, b = _tail_inputs(rng, 64, 128, 256, cuda)
    with pytest.raises(ValueError):  # F not a multiple of 64
        mlp_tail(h[:, :96].contiguous(), w2[:, :96].contiguous(), b2, res, g, b)
    with pytest.raises(ValueError):  # C not a multiple of 256 (a CTA's 256 columns)
        mlp_tail(h, w2[:192].contiguous(), b2[:192], res[:, :192].contiguous(), g[:192], b[:192])
    with pytest.raises(ValueError):  # a multiple of 128, not of 256
        wide = _tail_inputs(rng, 8, 64, 384, cuda)
        mlp_tail(*wide)
    with pytest.raises(ValueError):  # LayerNorm rows wider than a cluster of 8 CTAs
        big = _tail_inputs(rng, 8, 64, 2304, cuda)
        mlp_tail(*big)
    with pytest.raises(TypeError):  # fp32 h
        mlp_tail(h.float(), w2, b2, res, g, b)
    with pytest.raises(ValueError):  # a strided h
        mlp_tail(h.t().contiguous().t(), w2, b2, res, g, b)


def test_flagship_block_tails_on_the_card(cuda):
    """A full-width backbone block (1,024 wide, 16 heads, LayerScale) over
    2,060 rows with mlp_tail="both": two K5 launches, and the output within
    bf16 noise of the same block with the tails off."""
    from vitslam_tpu_torch.nn.layers import Block, init_weights

    blk = init_weights(Block(1024, 16, qk_norm=False, init_values=1.0, dtype=torch.bfloat16,
                             device=cuda, mlp_tail="both"),
                       torch.Generator(device=cuda).manual_seed(0))
    off = Block(1024, 16, qk_norm=False, init_values=1.0, dtype=torch.bfloat16, device=cuda)
    off.load_state_dict(blk.state_dict())
    x = _bf16(np.random.default_rng(14), (5, 412, 1024), cuda)
    before = mlp_tail.launches
    with torch.no_grad():
        got = blk(x)
        want = off(x)
    torch.cuda.synchronize()
    assert mlp_tail.launches == before + 2
    assert _rel_l2(got, want) <= 1e-2


# ---- edges of the wgmma + TMA forward core (csrc/attention_fwd_sm90.cuh) ----

@pytest.mark.parametrize("B,H,nq,nk,dh,bounded", [
    (1, 2, 40, 300, 64, True),     # Nq < 64: one consumer warpgroup's rows, the other idle
    (2, 3, 100, 1, 64, False),     # Nk = 1: one valid key in a 128-key tile
    (1, 4, 257, 129, 128, False),  # Nk = one tile + 1, D 128
    (1, 2, 33, 1, 128, True),      # Nq < 64 and Nk = 1 at D 128
])
def test_core_short_and_ragged_tiles(cuda, B, H, nq, nk, dh, bounded):
    """K3 (with lse) where the tiles are mostly empty: TMA zero-fills the
    rows past Nq and Nk, the kernel masks the keys and skips storing the
    rows. Against the plain version on the kernel's own q (folded and
    rounded as the kernel does): 2e-2 + 2e-2 * |plain|, lse 2e-2."""
    rng = np.random.default_rng(20)
    q = _bf16(rng, (B, H, nq, dh), cuda, 2.0)
    k = _bf16(rng, (B, H, nk, dh), cuda)
    v = _bf16(rng, (B, H, nk, dh), cuda)
    fold = q_fold(dh)
    q_eff = (q.float() * fold).to(torch.bfloat16).float() / fold
    out, lse = flash_attention_lse(q, k, v, static_max=24.0 if bounded else None)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_plain(q_eff, k, v, with_lse=True)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=2e-2, rtol=0)


def test_core_ragged_tile_stays_in_its_batch(cuda):
    """B = 2 with Nk = 200: batch 0's second K/V tile is ragged, and the
    rows past its end are batch 1's first rows in memory. Batch 1's keys
    and values are huge, so a tensor map that read across the batch
    boundary would move batch 0's output by O(100)."""
    rng = np.random.default_rng(21)
    B, H, nq, nk = 2, 2, 150, 200
    q = _bf16(rng, (B, nq, H, 64), cuda).transpose(1, 2)
    k = _bf16(rng, (B, nk, H, 64), cuda)
    v = _bf16(rng, (B, nk, H, 64), cuda)
    k[1] = 40.0
    v[1] = 300.0
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v)
    assert got[0].float().abs().max().item() < 10.0
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got[1].float(), want[1].float(), atol=2e-2 * 300, rtol=2e-2)


@pytest.mark.parametrize("bounded", [False, True])
def test_core_d128_lse_on_strided_views(cuda, bounded):
    """D 128 with an online max (and the fixed shift) and lse, on q/k/v
    that are (B, H, N, D) views of one packed (B, N, 3, H, D) projection
    (v a strided slice of it), into a (B, H, N, D) output view of a
    (B, N, H, D) buffer."""
    rng = np.random.default_rng(22)
    B, H, N, dh = 2, 4, 333, 128
    x = _bf16(rng, (B, N, 3 * H * dh), cuda)
    q, k, v = (x[..., i * H * dh:(i + 1) * H * dh].reshape(B, N, H, dh).transpose(1, 2)
               for i in range(3))
    fold = q_fold(dh)
    q_eff = (q.float() * fold).to(torch.bfloat16).float() / fold
    out, lse = flash_attention_lse(q, k, v, static_max=24.0 if bounded else None)
    torch.cuda.synchronize()
    assert out.stride() == (N * H * dh, dh, H * dh, 1)
    want_out, want_lse = flash_attention_plain(q_eff, k, v, with_lse=True)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    assert _rel_l2(out, want_out) <= 1e-2
    torch.testing.assert_close(lse, want_lse, atol=2e-2, rtol=0)


@pytest.mark.parametrize("dh", [64, 128])
def test_core_q_fold_is_the_torch_fold(cuda, dh):
    """The kernel folds scale * log2(e) into q in shared memory; K4 rebuilds
    P from (q.float() * q_fold(D)).to(bf16). Read the kernel's q back
    exactly: head j attends to one key, the unit vector e_j, with an online
    max, so its lse is s = q^ . e_j = q^[:, j] (one product, exact in fp32)
    and log2(l) = log2(1) = 0. Every element must equal the torch fold bit
    for bit."""
    rng = np.random.default_rng(23)
    nq = 300
    q1 = _bf16(rng, (nq, dh), cuda, 3.0)
    q = q1.expand(1, dh, nq, dh).contiguous()
    k = torch.eye(dh, device=cuda, dtype=torch.bfloat16).reshape(1, dh, 1, dh)
    v = torch.zeros((1, dh, 1, dh), device=cuda, dtype=torch.bfloat16)
    _, lse = flash_attention_lse(q, k, v)
    torch.cuda.synchronize()
    want = (q1.float() * q_fold(dh)).to(torch.bfloat16).float()
    assert torch.equal(lse[0].t(), want)


@pytest.mark.parametrize("B,N,with_ln,with_rope,nsplit", [
    (75, 412, True, True, 2),     # 75/30 frame attention
    (1, 2060, True, True, 2),     # 5/1 global attention
    (3, 300, True, True, 1),      # 1-D RoPE
    (2, 130, True, False, 2),     # LayerNorm only
    (2, 130, False, True, 2),     # RoPE only
    (5, 412, False, False, 2),    # patch embed: the fold only
])
def test_k1_prep_kernel_matches_plain(cuda, B, N, with_ln, with_rope, nsplit):
    """K1's prep kernel against qk_prep_plain on the card: both compute in
    fp32 in the same order and round once to bf16, but the LayerNorm sums
    run in another order, so the fp32 values may differ in their last bits.
    Each element is the plain version's bf16 value or one ulp from it (2^-7
    relative), or, where RoPE's x cos + rot sin cancels O(1) operands to
    near zero, within 1e-6 absolute (a few fp32 ulps of the operands); at
    least 99.9% are bit-identical."""
    rng = np.random.default_rng(24)
    heads, dh = 16, 64
    x = _bf16(rng, (B, N, 3 * heads * dh), cuda)
    kw = dict(num_heads=heads, nsplit=nsplit, fold=q_fold(dh))
    if with_ln:
        kw.update(q_ln=[torch.tensor(rng.normal(m, 0.1, dh), dtype=torch.float32, device=cuda)
                        for m in (1.0, 0.0)],
                  k_ln=[torch.tensor(rng.normal(m, 0.1, dh), dtype=torch.float32, device=cuda)
                        for m in (1.0, 0.0)])
    if with_rope:
        if nsplit == 2:
            pos = patch_grid_positions(B, 11, -(-N // 11), 0, cuda)[:, :N]
            cos, sin, _ = rope_cache_2d(pos, dh)
        else:
            from vitslam_tpu_torch.nn.rope import rope_cache_1d
            cos, sin, _ = rope_cache_1d(torch.arange(N, device=cuda).expand(B, N), dh)
        kw.update(cos=cos, sin=sin)
    before = qk_prep.launches
    got = qk_prep(x, **kw)
    torch.cuda.synchronize()
    assert qk_prep.launches == before + 1
    want = qk_prep_plain(x, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=1e-6, rtol=2.0 ** -7)
        assert (g != w).float().mean().item() <= 1e-3


# ---- K4 (csrc/flash_attention_bwd.cu) at its edges ----

def _k4_inputs(rng, B, H, nq, nk, dh, dev):
    """q, k, v, dO as strided (B, H, N, D) views of (B, N, H, D) buffers,
    the head's layout, and the forward's output and lse on them."""
    q, k, v = (_bf16(rng, (B, n, H, dh), dev, sc).transpose(1, 2)
               for n, sc in ((nq, 2.0), (nk, 1.0), (nk, 1.0)))
    dout = _bf16(rng, (B, nq, H, dh), dev).transpose(1, 2)
    out, lse = flash_attention_lse(q, k, v)
    return q, k, v, dout, out, lse


@pytest.mark.parametrize("B,H,nq,nk,dh", [
    (2, 3, 1, 65, 128),      # one query: a tile of one row
    (1, 4, 63, 129, 64),     # less than a 64-query half; one key past a key block
    (2, 2, 65, 1, 128),      # one key: dS = P (dP - Dvec) is zero in exact arithmetic
    (1, 3, 129, 63, 64),     # ragged both ways
    (1, 16, 2060, 1474, 64),   # the KV-merged cross shape
    (1, 8, 2060, 1474, 128),
])
def test_k4_ragged_strided_and_masked_rows(cuda, B, H, nq, nk, dh):
    """K4 against its plain version on the query the kernels see, with every
    fifth query row's lse set to +inf (P = 0 for that row: the padding rule
    of the reference). Elementwise 2e-2 + 2e-2 * |plain| and rel-L2 <= 1e-2;
    with one key dq and dk are rounding noise around zero (P = 1, dP =
    Dvec), so for them only the elementwise bound applies. Masked rows get
    dq = 0 exactly."""
    rng = np.random.default_rng(30)
    q, k, v, dout, out, lse = _k4_inputs(rng, B, H, nq, nk, dh, cuda)
    lse = lse.clone()
    lse[:, :, ::5] = float("inf")
    fold = q_fold(dh)
    q_eff = (q.float() * fold).to(torch.bfloat16).float() / fold
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    want = flash_attention_backward_plain(q_eff, k, v, out, lse, dout)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2, msg=name)
        if nk > 1 or name == "dv":
            assert _rel_l2(g, w) <= 1e-2, name
    assert (got[0][:, :, ::5] == 0).all()


def test_k4_dq_differs_between_runs_by_one_ulp_at_most(cuda):
    """dq's key blocks add into its fp32 accumulator by atomic bulk adds,
    one key block after another in key order: two runs give bit-identical
    dq, dk and dv (no element differs, so none by more than one ulp), at
    D 128 and at D 64 with more key blocks than the card has SMs."""
    rng = np.random.default_rng(31)
    for shape in ((1, 8, 2060, 2060, 128), (2, 16, 300, 20000, 64)):
        q, k, v, dout, out, lse = _k4_inputs(rng, *shape, cuda)
        first = flash_attention_backward(q, k, v, out, lse, dout)
        second = flash_attention_backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b), shape


# ---- K5 (csrc/mlp_tail.cu) at its edges ----

@pytest.mark.parametrize("gelu,ln", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("M", [1, 63, 64, 65, 2060, 30900])
def test_k5_rows_and_epilogues(cuda, M, gelu, ln):
    """K5 at every row count the edges reach (one row, a 64-row tile and
    one row less or more, the 5/1 and 75/30 chunks, which take 64- and
    128-row tiles) with the gelu and the cluster LayerNorm on and off,
    against the plain version: 2e-2 + 2e-2 * |plain| and rel-L2 <= 1e-2."""
    rng = np.random.default_rng(32)
    Fd, C = (1024, 1024) if M > 1000 else (128, 512)
    args = _tail_inputs(rng, M, Fd, C, cuda)
    before = mlp_tail.launches
    got = mlp_tail(*args, gelu=gelu, ln=ln)
    torch.cuda.synchronize()
    assert mlp_tail.launches == before + 1
    want = mlp_tail_plain(*args, gelu=gelu, ln=ln)
    got, want = (got, want) if ln else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (M, C) and torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert _rel_l2(g, w) <= 1e-2


@pytest.mark.parametrize("M,ln", [(65, True), (2060, True), (130, False)])
def test_k5_leaves_rows_past_m_untouched(cuda, M, ln):
    """The C entry point on x and y buffers 64 rows taller than M, filled
    with a sentinel: rows < M are written, rows >= M keep the sentinel."""
    from vitslam_tpu_torch.ops.cuda_build import library

    rng = np.random.default_rng(33)
    C = 1024
    h, w2, b2, res, g, bt = _tail_inputs(rng, M, 256, C, cuda)
    sentinel = -12345.0
    x = torch.full((M + 64, C), sentinel, dtype=torch.bfloat16, device=cuda)
    y = torch.full((M + 64, C), sentinel, dtype=torch.bfloat16, device=cuda)
    err = library("mlp_tail").vitslam_mlp_tail_bf16(
        h.data_ptr(), w2.data_ptr(), b2.data_ptr(), res.data_ptr(), g.data_ptr(), bt.data_ptr(),
        x.data_ptr(), y.data_ptr(), M, 256, C, 1, int(ln), 1e-6,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert (x[M:] == sentinel).all() and (x[:M] != sentinel).all()
    assert (y[M:] == sentinel).all()
    assert (y[:M] != sentinel).all() if ln else (y[:M] == sentinel).all()


def test_k5_gelu_is_the_exact_gelu_over_every_bf16_input(cuda):
    """K5's in-kernel gelu against torch's exact-erf gelu on the card: every
    finite bf16 value below 1e30 in magnitude goes through the tail with W
    = I, b = 0 and a zero residual, so x' = bf16(gelu(h)). Both evaluate
    x / 2 (1 + erf(x / sqrt(2))) with erff in fp32: bit-identical."""
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    h = bits.reshape(256, 256).to(cuda)
    h = torch.where(torch.isfinite(h.float()) & (h.float().abs() < 1e30), h, torch.zeros_like(h))
    eye = torch.eye(256, dtype=torch.bfloat16, device=cuda)
    x = mlp_tail(h, eye, torch.zeros(256, device=cuda), torch.zeros_like(h), gelu=True, ln=False)
    want = torch.nn.functional.gelu(h.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(x, want)


def test_nccl_gather_at_world_size_1(cuda):
    """The collectives of vitslam_tpu_torch.parallel through an NCCL group of
    one rank on the card: the gather returns the tensor on its device, the
    host gather the array, the gradient of a replicated gather passes
    through."""
    import torch.distributed as dist

    from vitslam_tpu_torch import parallel

    torch.cuda.set_device(0)  # torch 2.11 takes no index-less device here
    parallel.init_distributed("nccl", f"localhost:{parallel.free_port()}", 1, 0)
    try:
        x = torch.arange(6.0, device=cuda).reshape(2, 3).requires_grad_()
        got = parallel.all_gather(x, dim=1, replicated=True)
        assert got.device == x.device and torch.equal(got.detach(), x.detach())
        got.sum().backward()
        assert torch.equal(x.grad, torch.ones_like(x))
        np.testing.assert_array_equal(parallel.allgather_rows(np.arange(3)), np.arange(3))
        mesh = parallel.make_mesh()
        assert mesh.coords == {"data": 0, "model": 0}
    finally:
        dist.destroy_process_group()


def _bf16_ulps(a, b) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors whose elements share their signs."""
    assert bool((torch.sign(a.float()) == torch.sign(b.float())).all())
    return int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())


@pytest.mark.parametrize("M,K,N", [(2060, 1024, 3072), (30900, 1024, 1024), (130, 64, 72)])
def test_int8_projection_on_the_card_matches_the_cpu(cuda, M, K, N):
    """ops.quant on the card (torch._int_mm) against the same arithmetic on
    the CPU: the same integers and scales, the same int32 product, the bf16
    output within one unit in the last place."""
    from vitslam_tpu_torch.ops.quant import int8_matmul, int_mm, quantize_cols, quantize_rows

    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, device=cuda, generator=g) / K ** 0.5
    b = torch.randn(N, device=cuda, generator=g)
    with torch.no_grad():
        got = [quantize_rows(x), quantize_cols(w.t())]
        got_y = int_mm(got[0][0], got[1][0])
        got_out = int8_matmul(x, w.t(), b)
        want = [quantize_rows(x.cpu()), quantize_cols(w.cpu().t())]
        want_y = int_mm(want[0][0], want[1][0])
        want_out = int8_matmul(x.cpu(), w.cpu().t(), b.cpu())
    for (gq, gs), (wq, ws) in zip(got, want):
        assert torch.equal(gq.cpu(), wq) and torch.equal(gs.cpu(), ws)
    assert torch.equal(got_y.cpu(), want_y)
    assert _bf16_ulps(got_out.cpu(), want_out) <= 1


def test_int8_projection_refuses_what_int_mm_does_not_take(cuda):
    from vitslam_tpu_torch.ops.quant import int8_matmul

    w = torch.randn(64, 32, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="more than 16 rows"):
        int8_matmul(torch.randn(16, 32, device=cuda), w.t())


def test_track_head_fp32_on_the_card_matches_the_cpu(cuda):
    """A small TrackHead (features 32, hidden 64, updater depth 2, 2
    iterations, 4 correlation levels down to a one-pixel-tall level) in
    fp32 on the card, TF32 off, against the CPU on the same inputs, the flow
    head drawn from a seed: relative L2 error per output within 1e-3."""
    from vitslam_tpu_torch.models import TrackHead
    from vitslam_tpu_torch.nn.layers import init_weights

    kw = dict(dim_in=64, patch_size=14, features=32, iters=2, corr_levels=4, hidden_size=64,
              updater_depth=2, dtype=torch.float32)
    cpu = init_weights(TrackHead(**kw, device="cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():
        flow = cpu.tracker.updateformer.flow_head.weight
        flow.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    card = TrackHead(**kw, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    images = torch.tensor(rng.uniform(size=(1, 3, 3, 28, 42)), dtype=torch.float32)
    taps = [torch.tensor(rng.normal(size=(1, 3, 11, 64)), dtype=torch.float32) for _ in range(4)]
    query = torch.tensor([[[10.0, 12.0], [20.0, 5.0], [41.0, 27.0]]])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = card([t.to(cuda) for t in taps], images.to(cuda), 5, query.to(cuda))
            want = cpu(taps, images, 5, query)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.isfinite(g).all()
        assert float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)) <= 1e-3
