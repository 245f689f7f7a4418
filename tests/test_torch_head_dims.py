"""Port parity at the shapes the port's kernels were widened to: head dims
other than 32, 64 and 128 (K1's prep and attention, K3 with its lse, the
K4 backward), K5 at a width and depth that are not multiples of its tiles
(F 1,536 at C 384: the small preset's mlp site), and the int8 product at
shapes ``torch._int_mm`` refuses on the card. The plain versions, which the
kernels are held to on the card (test_torch_cuda.py, chip_smoke.py's
``shapes`` step), against the JAX package: its Pallas kernels in interpret
mode on the CPU where they compute the function, its plain reference where
they do not (the JAX K5 sums only 1,024 of F 1,536's columns). Small
shapes, one JAX compile a case."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vitslam_tpu.nn.rope import patch_grid_positions as jax_grid  # noqa: E402
from vitslam_tpu.nn.rope import rope_cache_2d as jax_rope_cache_2d  # noqa: E402
from vitslam_tpu.ops.fused_attention import fused_qkv_attention as jax_fused  # noqa: E402
from vitslam_tpu.ops.mlp_tail import mlp_tail_reference  # noqa: E402
from vitslam_tpu_torch.nn.layers import qk_shift_from  # noqa: E402
from vitslam_tpu_torch.ops import quant as tq  # noqa: E402
from vitslam_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_backward_plain,
    flash_attention_lse,
)
from vitslam_tpu_torch.ops.fused_attention import fused_qkv_attention  # noqa: E402
from vitslam_tpu_torch.ops.mlp_tail import mlp_tail  # noqa: E402
from torch_weights import shared_jax_cache  # noqa: E402,F401

# the module, not the function that vitslam_tpu.ops re-exports under its name
jfa = importlib.import_module("vitslam_tpu.ops.flash_attention")
torch.set_num_threads(2)


@pytest.mark.parametrize("heads,dh", [(8, 8), (4, 16), (2, 48)])
def test_k1_matches_jax_kernel_interpret_at_head_dim(heads, dh):
    """K1 at heads of 8, 16 and 48 (the JAX kernel packs 128 // dh heads a
    lane block; the port's kernel pads the head dim to its 32 or 64
    instance): the wrapper on the CPU (the plain version) against the JAX
    Pallas kernel in interpret mode, qk-norm, 2-D RoPE and the fixed shift,
    on fp32 qkv. The JAX kernel rounds q, k and P to bf16 inside, the plain
    version on fp32 does not: 2e-2, the tolerance test_torch_fused_attention
    holds the two to at head dim 64."""
    rng = np.random.default_rng(heads * dh)
    B, nq = 1, 130
    C = heads * dh
    qkv = rng.normal(size=(B, nq, 3 * C)).astype(np.float32)
    pos = np.asarray(jax_grid(B, 5, -(-nq // 5), 0))[:, :nq]
    cos, sin, _ = jax_rope_cache_2d(jnp.asarray(pos), dh)
    q_ln, k_ln = ((rng.normal(1, 0.1, dh).astype(np.float32),
                   rng.normal(0, 0.1, dh).astype(np.float32)) for _ in range(2))
    kw = dict(num_heads=heads, cos=torch.tensor(np.asarray(cos)),
              sin=torch.tensor(np.asarray(sin)), nsplit=2,
              q_ln=tuple(map(torch.tensor, q_ln)), k_ln=tuple(map(torch.tensor, k_ln)))
    kw["static_max"] = qk_shift_from(kw["q_ln"], kw["k_ln"], dh)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused(jnp.asarray(qkv), num_heads=heads, cos=cos, sin=sin,
                         q_ln=tuple(map(jnp.asarray, q_ln)), k_ln=tuple(map(jnp.asarray, k_ln)),
                         static_max=float(kw["static_max"]))
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(torch.tensor(qkv), **kw)
    assert fused_qkv_attention.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d,static_max", [(8, 6.0), (16, None), (48, 6.0), (96, None)])
def test_k3_lse_and_k4_match_jax_kernels_at_head_dim(d, static_max):
    """K3's output and lse (``flash_attention_lse`` on the CPU) against
    ``_flash_forward(..., with_lse=True)``, and the plain FA2 backward
    against ``_flash_backward`` on the same residuals and cotangent, both
    Pallas kernels in interpret mode, at head dims the port's K3 pads to
    its 32, 64 or 128 instance and its K4 to 64 or 128 (ragged cross
    lengths, bounded and online max). fp32; atol 2e-4, rtol 1e-3 as in
    test_torch_flash_bwd.py."""
    rng = np.random.default_rng(d)
    nq, nk = 130, 200
    q, k, v = (rng.normal(size=(2, n, d)).astype(np.float32) for n in (nq, nk, nk))
    g = rng.normal(size=(2, nq, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    smax = jnp.asarray([static_max or 0.0], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jax.jit(lambda q, k, v: jfa._flash_forward(
            q, k, v, smax, scale, 128, 128, static_max is not None, with_lse=True))(q, k, v)
        want = jax.jit(lambda *a: jfa._flash_backward(*a, scale))(
            q, k, v, out, lse, jnp.asarray(g))
    t_out, t_lse = flash_attention_lse(*(torch.tensor(x)[None] for x in (q, k, v)),
                                       static_max=static_max)
    np.testing.assert_allclose(t_lse[0].numpy(), np.asarray(lse)[..., 0], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(out), atol=2e-4, rtol=1e-3)
    got = flash_attention_backward_plain(
        *(torch.tensor(np.asarray(x)) for x in (q, k, v, out)),
        torch.tensor(np.asarray(lse)[..., 0]), torch.tensor(g))
    for t, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=2e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


def test_k5_plain_matches_reference_at_f_1536():
    """K5 at (M 256, F 1,536, C 384) with the gelu and the LayerNorm: the
    wrapper on the CPU (``mlp_tail_plain``) against ``mlp_tail_reference``
    in fp32, within 1e-5 (sums in another order). The JAX Pallas kernel
    sums only the first 1,024 of F's 1,536 columns here (its grid takes F
    // 1,024 steps), so the port is held to the reference's function, as
    its kernel is on the card."""
    rng = np.random.default_rng(15)
    M, Fd, C = 256, 1536, 384
    h = rng.normal(size=(M, Fd)).astype(np.float32)
    w2 = (rng.normal(size=(Fd, C)) / np.sqrt(Fd)).astype(np.float32)  # the reference's (F, C)
    b2, res = rng.normal(0, 0.1, C).astype(np.float32), rng.normal(size=(M, C)).astype(np.float32)
    gamma, beta = rng.normal(1, 0.1, C).astype(np.float32), rng.normal(0, 0.1, C).astype(np.float32)
    want = mlp_tail_reference(*(jnp.asarray(a) for a in (h, w2, b2, res, gamma, beta)),
                              gelu=True, ln=True)
    got = mlp_tail(*(torch.tensor(a) for a in (h, w2.T.copy(), b2, res, gamma, beta)),
                   gelu=True, ln=True)
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_int8_product_padding_is_exact():
    """The shapes torch._int_mm refuses on the card (fewer than 17 rows, K
    or N not a multiple of 8) are padded to ones it takes, and the padded
    product, sliced back, is the int64 product of the unpadded operands."""
    rng = np.random.default_rng(16)
    for M, K, N in ((1, 12, 20), (16, 1024, 72), (5, 64, 3), (17, 8, 8)):
        padded = tq.int_mm_padding(M, K, N)
        tq.check_int_mm_shape(*padded)
        assert padded == (max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8)
        xq = torch.tensor(rng.integers(-127, 128, (M, K)), dtype=torch.int8)
        wq = torch.tensor(rng.integers(-127, 128, (N, K)), dtype=torch.int8).t()
        got = tq.int_mm_padded(xq, wq, *padded)
        assert got.dtype == torch.int32 and got.shape == (M, N)
        assert torch.equal(got.long(), xq.long() @ wq.long())
