"""Port parity for K1 (ops/fused_attention.py): the port's plain version
against the JAX package's plain reference (``_fused_reference``) and against
its Pallas kernel run in interpret mode on the CPU, and the wrapper's CPU
routing. The CUDA kernel itself is tested in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vitslam_tpu.nn.rope import patch_grid_positions as jax_grid  # noqa: E402
from vitslam_tpu.nn.rope import rope_cache_2d as jax_rope_cache_2d  # noqa: E402
from vitslam_tpu.ops.fused_attention import (  # noqa: E402
    _fused_reference,
    fused_qkv_attention as jax_fused,
)
from vitslam_tpu_torch.nn.layers import qk_shift_from  # noqa: E402
from vitslam_tpu_torch.ops.fused_attention import (  # noqa: E402
    fused_qkv_attention,
    fused_qkv_attention_plain,
)

torch.set_num_threads(2)

H, DH = 2, 64  # the kernel's head dim


def _case(nq, with_ln, with_rope, seed=0, B=2):
    """numpy inputs: qkv, a 2-D RoPE cache on a patch grid, LN params."""
    rng = np.random.default_rng(seed)
    C = H * DH
    qkv = rng.normal(size=(B, nq, 3 * C)).astype(np.float32)
    cos = sin = q_ln = k_ln = None
    if with_rope:
        pos = np.asarray(jax_grid(B, 5, -(-nq // 5), 0))[:, :nq]
        c, s, _ = jax_rope_cache_2d(jnp.asarray(pos), DH)
        cos, sin = np.asarray(c), np.asarray(s)
    if with_ln:
        q_ln = (rng.normal(1, 0.1, DH).astype(np.float32),
                rng.normal(0, 0.1, DH).astype(np.float32))
        k_ln = (rng.normal(1, 0.1, DH).astype(np.float32),
                rng.normal(0, 0.1, DH).astype(np.float32))
    return qkv, cos, sin, q_ln, k_ln


def _torch_kw(cos, sin, q_ln, k_ln, bounded, dtype=torch.float32):
    kw = dict(num_heads=H)
    if cos is not None:
        kw.update(cos=torch.tensor(cos), sin=torch.tensor(sin), nsplit=2)
    if q_ln is not None:
        kw.update(q_ln=tuple(map(torch.tensor, q_ln)), k_ln=tuple(map(torch.tensor, k_ln)))
        if bounded:
            kw["static_max"] = qk_shift_from(kw["q_ln"], kw["k_ln"], DH)
    return kw


def _jax_reference(qkv, cos, sin, q_ln, k_ln):
    B, nq = qkv.shape[:2]
    zero = jnp.zeros((DH,), jnp.float32)
    zcs = jnp.zeros((B, nq, DH), jnp.float32)
    return _fused_reference(
        jnp.asarray(qkv), zcs if cos is None else jnp.asarray(cos),
        zcs if sin is None else jnp.asarray(sin),
        *(map(jnp.asarray, q_ln) if q_ln else (zero, zero)),
        *(map(jnp.asarray, k_ln) if k_ln else (zero, zero)),
        num_heads=H, scale=1.0 / np.sqrt(DH), nsplit=2,
        do_ln=q_ln is not None, do_rope=cos is not None)


@pytest.mark.parametrize("nq,with_ln,with_rope", [
    (130, True, True), (130, False, False), (130, True, False),
    (130, False, True), (256, True, True), (640, True, True),
])
def test_plain_matches_jax_reference(nq, with_ln, with_rope):
    """Both sides in bf16 with the same rounding points (q/k cast to bf16
    before S, P cast to bf16 before P V, bf16 output): they differ by the
    summation order and bf16 output rounding, within 1e-2 for O(1) outputs."""
    qkv, cos, sin, q_ln, k_ln = _case(nq, with_ln, with_rope)
    want = _jax_reference(qkv.astype(jnp.bfloat16), cos, sin, q_ln, k_ln)
    got = fused_qkv_attention_plain(torch.tensor(qkv).to(torch.bfloat16),
                                    **_torch_kw(cos, sin, q_ln, k_ln, True))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("nq,with_ln,with_rope,bounded", [
    (130, True, True, True),      # ragged, qk-norm fixed shift
    (256, True, True, True),      # exact block fit
    (130, False, False, False),   # patch-embed style: online max
    (130, True, False, True),     # LN without RoPE
    (130, True, True, False),     # LN + RoPE with an online max
    (640, True, True, True),      # several q blocks over one K tile
])
def test_plain_matches_jax_kernel_interpret(nq, with_ln, with_rope, bounded):
    """The JAX Pallas kernel (interpret mode) on fp32 qkv rounds q/k and P
    to bf16 inside; the port's plain version on fp32 qkv does not. 2e-2 is
    the tolerance the JAX package holds its kernel to against its own
    reference for the same reason."""
    qkv, cos, sin, q_ln, k_ln = _case(nq, with_ln, with_rope, seed=1)
    kw = _torch_kw(cos, sin, q_ln, k_ln, bounded)
    jkw = dict(num_heads=H)
    if cos is not None:
        jkw.update(cos=jnp.asarray(cos), sin=jnp.asarray(sin))
    if q_ln is not None:
        jkw.update(q_ln=tuple(map(jnp.asarray, q_ln)), k_ln=tuple(map(jnp.asarray, k_ln)))
    if bounded:
        jkw["static_max"] = float(kw.get("static_max", 24.0))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused(jnp.asarray(qkv), **jkw)
    got = fused_qkv_attention_plain(torch.tensor(qkv), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_wrapper_on_cpu_runs_the_plain_version():
    """A CPU tensor goes to the plain version (no launch counted); a
    head-tiled (B, N, C) RoPE table gives the same result as (B, N, dh)."""
    qkv, cos, sin, q_ln, k_ln = _case(130, True, True, seed=2)
    kw = _torch_kw(cos, sin, q_ln, k_ln, True)
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(torch.tensor(qkv), **kw)
    assert fused_qkv_attention.launches == before
    torch.testing.assert_close(got, fused_qkv_attention_plain(torch.tensor(qkv), **kw),
                               atol=0, rtol=0)
    tiled = dict(kw, cos=kw["cos"].repeat(1, 1, H), sin=kw["sin"].repeat(1, 1, H))
    torch.testing.assert_close(fused_qkv_attention(torch.tensor(qkv), **tiled), got,
                               atol=0, rtol=0)
