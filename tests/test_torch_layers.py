"""Port parity for nn/ and ops/ (RoPE, LayerNorms, attention modules and
their routing, blocks, GatedUpdate, matmul resizes): the same numpy inputs
and the same weights (export_torch_style -> load_jax_params) through the JAX
module and its port, in fp32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402

from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.nn import layers as jl  # noqa: E402
from vitslam_tpu.nn import rope as jr  # noqa: E402
from vitslam_tpu.nn.gated_update import GatedUpdate as JGatedUpdate  # noqa: E402
from vitslam_tpu.ops.resize import resize_bilinear_nhwc  # noqa: E402
from vitslam_tpu_torch.io import load_jax_params  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.nn import rope as tr  # noqa: E402
from vitslam_tpu_torch.nn.gated_update import GatedUpdate  # noqa: E402
from vitslam_tpu_torch.ops import attention as tattn  # noqa: E402
from vitslam_tpu_torch.ops.resize import (  # noqa: E402
    bicubic_matrix,
    resize_bilinear_nchw,
    resize_matmul,
)

torch.set_num_threads(2)

# fp32 on both sides; attention and MLP sums over <= a few hundred terms in
# another order: well inside 1e-4 for O(1) values
ATOL = 1e-4


def _t(x):
    return torch.tensor(np.array(x))


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0)


def _port(jmodule, tmodule, *args):
    """Init the flax module on ``args``, load its weights into the port
    module (strict), return the flax variables."""
    variables = jmodule.init(jax.random.PRNGKey(0), *args)
    # perturb every leaf so zero biases / unit scales are not special cases
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(1)
    leaves = [x + 0.05 * rng.normal(size=x.shape).astype(np.float32) for x in leaves]
    variables = jax.tree_util.tree_unflatten(tree, [jnp.asarray(x) for x in leaves])
    load_jax_params(tmodule, export_torch_style(variables))
    return variables


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 20, 16)).astype(np.float32)
    pos1 = rng.integers(0, 9, size=(2, 20))
    pos2 = np.asarray(jr.patch_grid_positions(2, 3, 5, 5))
    _close(tr.patch_grid_positions(2, 3, 5, 5), pos2, atol=0)
    _close(tr.apply_rope_1d(_t(x), _t(pos1)), jr.apply_rope_1d(jnp.asarray(x), jnp.asarray(pos1)))
    _close(tr.apply_rope_2d(_t(x), _t(pos2)), jr.apply_rope_2d(jnp.asarray(x), jnp.asarray(pos2)))
    for (tc, jc, p) in ((tr.rope_cache_1d, jr.rope_cache_1d, pos1),
                        (tr.rope_cache_2d, jr.rope_cache_2d, pos2)):
        tcache, jcache = tc(_t(p), 16), jc(jnp.asarray(p), 16)
        _close(tcache[0], jcache[0], atol=1e-6)
        _close(tcache[1], jcache[1], atol=1e-6)
        assert tcache[2] == int(jcache[2])
        _close(tr.apply_rope_cached(_t(x), tcache),
               jr.apply_rope_cached(jnp.asarray(x), jcache))
        flat = x.transpose(0, 2, 1, 3).reshape(2, 20, 48)
        _close(tr.apply_rope_flat(_t(flat), tcache[0], tcache[1], 3, tcache[2]),
               jr.apply_rope_flat(jnp.asarray(flat), jcache[0], jcache[1], 3, int(jcache[2])))
        tiled = (tcache[0].repeat(1, 1, 3), tcache[1].repeat(1, 1, 3))
        _close(tr.apply_rope_flat(_t(flat), *tiled, 3, tcache[2]),
               jr.apply_rope_flat(jnp.asarray(flat), jcache[0], jcache[1], 3, int(jcache[2])))


def test_layernorms_match_jax():
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.normal(size=(2, 7, 48))).astype(np.float32)
    jln = fnn.LayerNorm(epsilon=1e-6)
    tln = tl.LayerNorm(48)
    v = _port(jln, tln, jnp.asarray(x))
    _close(tln(_t(x)), jln.apply(v, jnp.asarray(x)))
    p = v["params"]
    _close(tl.ln_apply(_t(x), _t(p["scale"]), _t(p["bias"]), torch.float32),
           jl.ln_apply(jnp.asarray(x), p["scale"], p["bias"], jnp.float32))
    jhn = jl.HeadLayerNorm(3, 16)
    thn = tl.HeadLayerNorm(3, 16)
    heads = x.reshape(2, 7, 3, 16).transpose(0, 2, 1, 3)
    v = _port(jhn, thn, jnp.asarray(heads))
    _close(thn(_t(heads)), jhn.apply(v, jnp.asarray(heads)))
    _close(thn(_t(x), flat=True), jhn.apply(v, jnp.asarray(x), flat=True))


@pytest.mark.parametrize("n,qk_norm,rope,cache,route", [
    (400, True, "2d", True, "fused"),     # aggregator block: LN + RoPE cache
    (400, False, None, False, "fused"),   # patch-embed block: no prep
    (100, True, "2d", True, "plain"),     # below the fused window
    (100, True, "2d", False, "plain"),    # integer positions (alignment head)
    (100, False, None, False, "plain"),   # camera-head trunk
])
def test_attention_matches_jax(n, qk_norm, rope, cache, route):
    """The port's Attention (fused route = the plain version on CPU) against
    the JAX module's CPU path, fp32, and the route taken."""
    rng = np.random.default_rng(2)
    C, h = 128, 2
    x = rng.normal(size=(2, n, C)).astype(np.float32)
    jm = jl.Attention(C, h, qk_norm=qk_norm, rope=rope)
    tm = tl.Attention(C, h, qk_norm=qk_norm, rope=rope)
    jpos = tpos = None
    if rope:
        grid = np.asarray(jr.patch_grid_positions(2, 3, -(-n // 3), 1))[:, :n]
        if cache:
            jpos = jr.rope_cache_2d(jnp.asarray(grid), C // h)
            tpos = tr.rope_cache_2d(_t(grid), C // h)
        else:
            jpos, tpos = jnp.asarray(grid), _t(grid)
    v = _port(jm, tm, jnp.asarray(x), jpos)
    before = dict(tattn.ROUTE_COUNTS)
    got = tm(_t(x), tpos)
    assert tattn.ROUTE_COUNTS[route] == before.get(route, 0) + 1
    _close(got, jm.apply(v, jnp.asarray(x), jpos))


def test_blocks_mlp_and_cross_attention_match_jax():
    rng = np.random.default_rng(3)
    C, h = 64, 4
    x = rng.normal(size=(2, 12, C)).astype(np.float32)
    y = rng.normal(size=(2, 5, C)).astype(np.float32)
    grid = np.asarray(jr.patch_grid_positions(2, 3, 4, 0))
    jb = jl.Block(C, h, qk_norm=True, init_values=0.5, rope="2d")
    tb = tl.Block(C, h, qk_norm=True, init_values=0.5, rope="2d")
    v = _port(jb, tb, jnp.asarray(x), jnp.asarray(grid))
    _close(tb(_t(x), _t(grid)), jb.apply(v, jnp.asarray(x), jnp.asarray(grid)))

    pos = (rng.integers(0, 7, size=(2, 12)), rng.integers(0, 7, size=(2, 5)))
    jc = jl.CrossAttentionBlock(C, h, qk_norm=True, init_values=0.5, rope="1d")
    tc = tl.CrossAttentionBlock(C, h, qk_norm=True, init_values=0.5, rope="1d")
    jpos = tuple(map(jnp.asarray, pos))
    v = _port(jc, tc, jnp.asarray(x), jnp.asarray(y), jpos)
    _close(tc(_t(x), _t(y), tuple(map(_t, pos))),
           jc.apply(v, jnp.asarray(x), jnp.asarray(y), jpos))

    jm = jl.Mlp(96, 7)
    tm = tl.Mlp(C, 96, 7)
    v = _port(jm, tm, jnp.asarray(x))
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)))


def test_qk_logit_bound_matches_jax():
    rng = np.random.default_rng(4)
    qp = {"scale": rng.normal(2, 1, 16).astype(np.float32),
          "bias": rng.normal(0, 1, 16).astype(np.float32)}
    kp = {"scale": rng.normal(1, 1, 16).astype(np.float32),
          "bias": rng.normal(0, 1, 16).astype(np.float32)}
    want = jl._qk_shift_from((qp["scale"], qp["bias"]), (kp["scale"], kp["bias"]), 16)
    got = tl.qk_shift_from((_t(qp["scale"]), _t(qp["bias"])),
                           (_t(kp["scale"]), _t(kp["bias"])), 16)
    assert float(want) > 24.0
    _close(got, want, atol=1e-4)


def test_gated_update_matches_jax():
    rng = np.random.default_rng(5)
    mem = rng.normal(size=(2, 4, 16)).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=-1, keepdims=True)
    upd = rng.normal(size=(2, 16)).astype(np.float32)
    jg = JGatedUpdate(16, 4)
    tg = GatedUpdate(16, 4)
    v = _port(jg, tg, jnp.asarray(mem), jnp.asarray(upd))
    _close(tg(_t(mem), _t(upd)), jg.apply(v, jnp.asarray(mem), jnp.asarray(upd)))


def test_attention_routes_at_reference_thresholds():
    route = tattn.attention_route
    assert route(383, 383, fusable=True, fast=True) == "plain"
    assert route(384, 384, fusable=True, fast=True) == "fused"
    assert route(4096, 4096, fusable=True, fast=False) == "fused"
    assert route(4097, 4097, fusable=True, fast=True) == "flat"
    assert route(4097, 4097, fusable=True, fast=False) == "flash"
    assert route(413, 413, fusable=False, fast=False) == "plain"   # < 512 keys
    assert route(600, 600, fusable=False, fast=False) == "flash"
    assert route(5, 600, fusable=False, fast=False) == "flash"     # cross-attention
    assert route(600, 5, fusable=False, fast=False) == "plain"
    # on CPU the flash route (K3) runs its plain version
    q = torch.randn(1, 1, 600, 8)
    torch.testing.assert_close(tattn.scaled_dot_product_attention(q, q, q, route="flash"),
                               tattn.plain_attention(q, q, q))


@pytest.mark.parametrize("align_corners", [False, True])
def test_bilinear_resize_matches_jax(align_corners):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 11, 37, 3)).astype(np.float32)
    for oh, ow in ((22, 74), (5, 13), (11, 37)):
        want = resize_bilinear_nhwc(jnp.asarray(x), oh, ow, align_corners)
        got = resize_bilinear_nchw(_t(x.transpose(0, 3, 1, 2)), oh, ow, align_corners)
        _close(got.permute(0, 2, 3, 1), want, atol=1e-5)


@pytest.mark.parametrize("ng,gh,gw", [(37, 11, 37), (16, 7, 13), (2, 2, 3)])
def test_pos_embed_bicubic_matches_jax_image_resize(ng, gh, gw):
    """The pos-embed resize: jax.image.resize bicubic (Keys a=-0.5) with
    antialias, as (out, in) matrices."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(ng, ng, 8)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (gh, gw, 8), method="bicubic", antialias=True)
    got = resize_matmul(_t(x.transpose(2, 0, 1)), bicubic_matrix(gh, ng), bicubic_matrix(gw, ng))
    _close(got.permute(1, 2, 0), want, atol=1e-5)
