"""Port parity for the int8 serving mode: ops/quant.py (the quantisation of
activations per row and weights per column, the int8 product with its fp32
rescale and its gradient), one int8 Block and the tiny feature-aligned model with int8 on,
each against the JAX package with VITSLAM_INT8=1 on the same numpy inputs
in fp32. JAX reads the switch when it traces, so it is set before the
first trace of a fresh function."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_weights import jax_variables, seeded  # noqa: E402
from vitslam_tpu import models as jm  # noqa: E402
from vitslam_tpu.nn import layers as jl  # noqa: E402
from vitslam_tpu.ops import quant as jq  # noqa: E402
from vitslam_tpu_torch import cli  # noqa: E402
from vitslam_tpu_torch import models as tm  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.ops import quant as tq  # noqa: E402

torch.set_num_threads(2)

# the same fp32 inputs quantise to the same integers and scales as the
# reference under jit, as it runs (max-abs times the fp32 reciprocal of 127,
# then a true division and round-half-to-even): no integer may differ, and
# the int32 products are equal
INT_DIFFS = 0
# int8_matmul on the same inputs: the same integers, the same exact int32
# product and the same fp32 rescale order; XLA may contract the rescale and
# the bias into one rounding, so the outputs agree to fp32 rounding
# (measured 3.5e-8)
MATMUL_RTOL = 1e-6
# through a block or a model, activations differ at ~1e-7 between the two
# packages' fp32 sums, so a value at a rounding tie may quantise one step
# apart: relative L2 error per output (measured 7e-9 for the block, up to
# 1.3e-6 for the model's outputs)
BLOCK_RTOL = 1e-4
MODEL_RTOL = 1e-3


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _int8_on(monkeypatch):
    monkeypatch.setenv("VITSLAM_INT8", "1")
    assert jq.int8_enabled()


@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 48), (512, 256)])
def test_quantize_rows_and_cols_match_jax(shape):
    """Against the jitted reference: XLA turns its division by 127 into a
    product with the reciprocal (eager JAX divides, and its scales differ by
    an ulp in ~4% of rows)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, size=shape).astype(np.float32)
    x[..., 0] = 0.0
    x[0] = 0.0  # an all-zero row takes the 1e-12 scale floor
    q, s = tq.quantize_rows(torch.tensor(x))
    jqv, js = jax.jit(jq.quantize_rows)(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == shape[:-1] + (1,)
    assert int((q.numpy() != np.asarray(jqv)).sum()) == INT_DIFFS
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    w = rng.normal(0, 0.05, size=(shape[-1], 24)).astype(np.float32)
    wq, ws = tq.quantize_cols(torch.tensor(w))
    jwq, jws = jax.jit(jq.quantize_cols)(jnp.asarray(w))
    assert int((wq.numpy() != np.asarray(jwq)).sum()) == INT_DIFFS
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    # the port quantises a transposed view of its (N, K) weight: the same
    # integers, kept column-major
    wq_t, _ = tq.quantize_cols(torch.tensor(np.ascontiguousarray(w.T)).t())
    assert wq_t.stride() == (1, shape[-1])
    np.testing.assert_array_equal(wq_t.numpy(), wq.numpy())
    # the scale is the product with the reciprocal, on the CPU as on the card
    amax = torch.tensor(x).abs().amax(-1, keepdim=True)
    np.testing.assert_array_equal(s.numpy(), (amax * np.float32(1 / 127)).clamp_min(1e-12))


def test_rounding_is_half_to_even_after_a_division():
    # rows whose max is 127 have scale exactly 1: x / 1 rounds half to even
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127.0]])
    q, s = tq.quantize_rows(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 126, -127]]


@pytest.mark.parametrize("bias,out", [(True, "float32"), (False, "float32"),
                                      (True, "bfloat16")])
def test_int8_matmul_matches_jax(bias, out):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 11, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, size=(64, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32) if bias else None
    got = tq.int8_matmul(torch.tensor(x), torch.tensor(w), None if b is None else torch.tensor(b),
                         getattr(torch, out))
    want = jax.jit(jq.int8_matmul, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        getattr(jnp, out))
    assert got.dtype == getattr(torch, out) and got.shape == (3, 11, 40)
    tol = MATMUL_RTOL if out == "float32" else 2.0 ** -8  # one bf16 rounding
    assert _rel(got, want) <= tol
    # the int32 product itself is exact
    xq, _ = tq.quantize_rows(torch.tensor(x).reshape(-1, 64))
    wq, _ = tq.quantize_cols(torch.tensor(w))
    ref = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)
    np.testing.assert_array_equal(tq.int_mm(xq, wq).numpy(), ref)


def test_int8_matmul_refuses_gradients_and_card_shapes():
    """The products torch._int_mm refuses on the card raise there, before
    the product; the CPU takes any shape."""
    x = torch.randn(20, 16, requires_grad=True)
    w = torch.randn(16, 8)
    assert tq.int8_matmul(x, w).shape == (20, 8)
    tq.check_int_mm_shape(17, 1024, 3072)
    for m, k, n in ((16, 64, 64), (64, 60, 64), (64, 64, 12)):
        with pytest.raises(ValueError, match="multiples of 8"):
            tq.check_int_mm_shape(m, k, n)


def _grad_case(shape, seed=4):
    """x with a zero row (its scale clamped at 1e-12) and a row whose max
    |x| is tied between two entries of opposite sign; w with a column whose
    max |w| is tied."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[1] = 0.0
    top = np.abs(rows[2]).max() + 0.5
    rows[2, 3], rows[2, 6] = top, -top
    w = rng.normal(size=(shape[-1], 6)).astype(np.float32)
    w[2, 4] = w[5, 4] = np.abs(w[:, 4]).max() + 0.25
    b = rng.normal(size=(6,)).astype(np.float32)
    gy = rng.normal(size=shape[:-1] + (6,)).astype(np.float32)
    return x, w, b, gy


@pytest.mark.parametrize("shape", [(4, 8), (2, 5, 8)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_int8_matmul_gradient_matches_jax(shape, out):
    """d/dx, d/dw and d/db of sum(int8_matmul(x, w, b) * gy) against
    jax.grad of the jitted reference, within 1e-6 of the largest entry:
    the int32 product is a constant to both (the int8 cast has no
    gradient), so d/dx is nonzero only at each row's largest |x| (the tie
    shares it, the zero row has none) and d/dw only at each column's."""
    x, w, b, gy = _grad_case(shape)
    dt = getattr(jnp, out)
    want = jax.jit(jax.grad(
        lambda x, w, b: jnp.sum(jq.int8_matmul(x, w, b, dt).astype(jnp.float32) * gy),
        argnums=(0, 1, 2)))(x, w, b)
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = tq.int8_matmul(tx, tw, tb, getattr(torch, out))
    (y.float() * torch.tensor(gy)).sum().backward()
    for got, ref in zip((tx.grad, tw.grad, tb.grad), want):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        np.testing.assert_array_equal(got.numpy() != 0, ref != 0)
    rows = tx.grad.reshape(-1, shape[-1]).numpy()
    assert (rows[1] == 0).all() and (rows[2] != 0).sum() == 2
    assert ((rows != 0).sum(axis=1) == [1, 0, 2] + [1] * (len(rows) - 3)).all()
    assert (tw.grad[:, 4] != 0).sum() == 2 and (tw.grad != 0).sum() == 7


def test_dense_quantises_only_when_built_quant_and_switched_on():
    rng = np.random.default_rng(2)
    dense = seeded(tl.Dense(32, 24, quant=True))
    plain = seeded(tl.Dense(32, 24))
    x = torch.tensor(rng.normal(size=(5, 32)).astype(np.float32))
    with torch.no_grad():
        off = dense(x)
        tl.set_int8(dense, True)
        tl.set_int8(plain, True)
        assert dense.int8 and not plain.int8
        on = dense(x)
        want = tq.int8_matmul(x, dense.weight.t(), dense.bias, torch.float32)
    torch.testing.assert_close(on, want, rtol=0, atol=0)
    assert 0 < _rel(on, off) < 3e-2


def test_int8_block_matches_jax_and_takes_no_tail(monkeypatch):
    """A frame block (qk-norm, 2-D RoPE, LayerScale) with quant=True under
    the int8 switch; built with both fused tails asked for, the block still
    takes neither, as the reference's does not."""
    _int8_on(monkeypatch)
    C, heads = 64, 4
    kw = dict(qk_norm=True, init_values=0.01, rope="2d")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, C)).astype(np.float32)
    pos = np.stack(np.meshgrid(np.arange(3), np.arange(3), indexing="ij"), -1).reshape(1, 9, 2)
    pos = np.repeat(pos, 2, axis=0).astype(np.int32)
    tb = tl.set_int8(seeded(tl.Block(C, heads, **kw, quant=True, mlp_tail="both")), True)
    jb = jl.Block(C, heads, **kw, dtype=jnp.float32, quant=True, fused_tail=True)
    v = jax_variables(lambda r: jb.init(r, jnp.asarray(x), jnp.asarray(pos)), tb)
    want = jax.jit(jb.apply)(v, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = tb(torch.tensor(x), torch.tensor(pos))
    assert _rel(got, want) <= BLOCK_RTOL
    # no tail site is taken, at any row count
    monkeypatch.setattr(tl, "TAIL_MIN_ROWS", 1)
    monkeypatch.setattr(tl, "mlp_tail", lambda *a, **k: pytest.fail("K5 ran under int8"))
    with torch.no_grad():
        again = tb(torch.tensor(x), torch.tensor(pos))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_tiny_int8_feature_aligned_model_matches_jax(monkeypatch):
    """The chunk step of the feature-aligned model with int8=True (288
    projections at full depth; here the patch-embed, frame and global
    blocks of a 2-layer backbone) against the JAX model under
    VITSLAM_INT8=1; switched off, the same model's outputs move."""
    _int8_on(monkeypatch)
    kw = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
              patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1),
              align_embed_dim=32, align_dec_dim=16, num_memory_tokens=4)
    tmod = seeded(tm.FeatureAlignedVGGT(**kw, dtype=torch.float32, device="cpu", int8=True))
    n_int8 = sum(m.int8 for m in tmod.modules() if isinstance(m, tl.Dense))
    assert n_int8 == 4 * (1 + 2 * 2)  # 4 projections a block, 5 blocks
    jmod = jm.FeatureAlignedVGGT(**kw, dtype=jnp.float32)
    imgs = np.random.default_rng(4).uniform(size=(1, 4, 3, 28, 42)).astype(np.float32)
    v = jax_variables(lambda r: jmod.init(r, jnp.asarray(imgs), 2), tmod)
    want, _ = jax.jit(jmod.apply, static_argnums=2)(v, jnp.asarray(imgs), 2)
    with torch.no_grad():
        got, _ = tmod(torch.tensor(imgs), 2)
        tl.set_int8(tmod, False)
        fp32, _ = tmod(torch.tensor(imgs), 2)
    errs = {k: _rel(got[k], want[k]) for k in ("pose_enc", "depth", "world_points",
                                               "chunk_sim3_enc")}
    assert all(e <= MODEL_RTOL for e in errs.values()), errs
    assert _rel(got["depth"], fp32["depth"]) > 0  # the switch changed the path


def test_cli_reads_the_int8_switch():
    assert cli.int8_from_env({"VITSLAM_INT8": "1"})
    assert not cli.int8_from_env({"VITSLAM_INT8": "true"})
    assert not cli.int8_from_env({})
