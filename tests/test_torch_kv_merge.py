"""Port parity for the routes slice 2 adds and the aggregator's KV merge:
the Attention module on the flat (K2) and KV-merged flash (K3) routes, the
merged aggregator against exact attention at stride 1 and against JAX at
pool 2 / stride 2, and the large-chunk presets' parameter trees; the same
weights (export_torch_style -> load_jax_params; the merged models' weights
seeded by torch_weights.py) and numpy inputs, in fp32 on the CPU, where every
kernel wrapper runs its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vitslam_tpu import models as jm  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.nn import layers as jl  # noqa: E402
from vitslam_tpu.nn import rope as jr  # noqa: E402
from vitslam_tpu_torch import models as tm  # noqa: E402
from vitslam_tpu_torch.io import load_jax_params  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.nn import rope as tr  # noqa: E402
from vitslam_tpu_torch.ops import ROUTE_COUNTS  # noqa: E402

from torch_weights import jax_variables, seeded  # noqa: E402

torch.set_num_threads(2)

KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
          patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1))
# fp32 on both sides through the whole backbone and heads: relative L2
# error per output (measured ~1e-6)
RTOL = 1e-4


def _t(x):
    return torch.tensor(np.array(x))


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _port_module(jmod, tmod, *args):
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(1)  # perturbed: unit scales / zero biases are not special
    variables = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(x + 0.05 * rng.normal(size=x.shape).astype(np.float32))
               for x in leaves])
    load_jax_params(tmod, export_torch_style(variables))
    return variables


@pytest.mark.parametrize("n,n_kv,route", [
    (4100, None, "flat"),    # self-attention just above the fused window: K2
    (600, 4200, "flat"),     # KV-merged global attention above 4096 keys: K2, Nq != Nk
    (600, 550, "flash"),     # KV-merged global attention with 512..4096 keys: K3
])
def test_attention_large_and_merged_routes_match_jax(n, n_kv, route):
    """The Attention module with qk-norm and RoPE caches (the aggregator's
    global block), fp32, within 1e-4 (sums over thousands of keys in another
    order), and the route taken."""
    C, h = 128, 2
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, n, C)).astype(np.float32)
    grid = np.asarray(jr.patch_grid_positions(1, 40, -(-max(n, n_kv or 0) // 40), 1))
    jpos = jr.rope_cache_2d(jnp.asarray(grid[:, :n]), C // h)
    tpos = tr.rope_cache_2d(_t(grid[:, :n]), C // h)
    jm_ = jl.Attention(C, h, qk_norm=True, rope="2d")
    tm_ = tl.Attention(C, h, qk_norm=True, rope="2d")
    v = _port_module(jm_, tm_, jnp.asarray(x), jpos)
    kw_j, kw_t = {}, {}
    if n_kv is not None:
        kv = rng.normal(size=(1, n_kv, C)).astype(np.float32)
        # fractional positions, as pooled tokens have
        pkv = grid[:, :n_kv].astype(np.float32) + 0.5
        kw_j = dict(kv=jnp.asarray(kv), pos_kv=jr.rope_cache_2d(jnp.asarray(pkv), C // h))
        kw_t = dict(kv=_t(kv), pos_kv=tr.rope_cache_2d(_t(pkv), C // h))
    before = ROUTE_COUNTS[route]
    with torch.no_grad():
        got = tm_(_t(x), tpos, **kw_t)
    assert ROUTE_COUNTS[route] == before + 1
    want = jax.jit(lambda v, x: jm_.apply(v, x, jpos, **kw_j))(v, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def merge_setup():
    """8 frames of 98 x 182 (96 tokens each): the exact global attention is
    768 tokens (fused route); the p2s2 merged KV set is 4 anchors x 96 + 4
    frames x (5 specials + 4 x 7 pooled) = 516 keys (flash route)."""
    kw = dict(KW, enable_depth=False)
    imgs = np.random.default_rng(6).uniform(size=(1, 8, 3, 98, 182)).astype(np.float32)
    jmodel = jm.PointAlignedVGGT(**kw, dtype=jnp.float32)
    params = jax_variables(lambda r: jmodel.init(r, jnp.asarray(imgs), 1),
                           seeded(tm.PointAlignedVGGT(**kw, dtype=torch.float32)))
    flat = export_torch_style(params)

    def port(**merge):
        model = tm.PointAlignedVGGT(**kw, **merge, dtype=torch.float32)
        load_jax_params(model, flat)
        return model

    def jax_encode(**merge):
        jmodel = jm.PointAlignedVGGT(**kw, **merge, dtype=jnp.float32)
        return jax.jit(lambda p, x: jmodel.apply(p, x, method=jmodel.encode_chunks))(
            params, jnp.asarray(imgs))

    return imgs, port, jax_encode


def test_all_anchor_merge_is_exact(merge_setup):
    """Stride 1 makes every frame an anchor: the merged KV set is the exact
    token set in the same order, so the merged path (kv= branch, flash
    route) must equal exact attention (fused route), as in the JAX test."""
    imgs, port, _ = merge_setup
    before = dict(ROUTE_COUNTS)
    with torch.no_grad():
        exact = port().encode_chunks(_t(imgs))
        mid = dict(ROUTE_COUNTS)
        merged = port(global_merge_pool=2, global_merge_stride=1).encode_chunks(_t(imgs))
    assert mid["fused"] - before.get("fused", 0) >= KW["depth"]
    assert ROUTE_COUNTS["flash"] - mid.get("flash", 0) == KW["depth"]
    for k in exact:
        np.testing.assert_allclose(merged[k].numpy(), exact[k].numpy(), atol=1e-5, err_msg=k)


def test_merged_p2s2_matches_jax(merge_setup):
    """Pool 2 / stride 2: anchors keep their tokens, other frames pool 2 x 2
    (edge-replicated 7 x 13 -> 8 x 14) at fractional mean positions."""
    imgs, port, jax_encode = merge_setup
    before = ROUTE_COUNTS["flash"]
    with torch.no_grad():
        got = port(global_merge_pool=2, global_merge_stride=2).encode_chunks(_t(imgs))
        exact = port().encode_chunks(_t(imgs))
    assert ROUTE_COUNTS["flash"] - before == KW["depth"]
    want = jax_encode(global_merge_pool=2, global_merge_stride=2)
    for k in want:
        assert _rel_err(got[k], want[k]) <= RTOL, k
    # the merge changes what the tokens attend to, by more than the
    # tolerance (with LayerScale 0.01 at init the change is small)
    assert _rel_err(got["points_raw"], exact["points_raw"]) > 5 * RTOL


def test_presets_build_the_reference_head_sets():
    """The large-chunk presets' head flags, DPT chunking and merge knobs,
    built at a small width on the CPU (the device is asked for explicitly).
    Their parameter trees load strictly from JAX in test_torch_large_chunk.py."""
    small = dict(img_size=28, embed_dim=64, depth=1, num_heads=1, patch_embed_depth=1,
                 intermediate_layers=(0, 0, 0, 0), dtype=torch.float32)
    point = tm.flagship_point_aligned(device="cpu", **small)
    pose = tm.flagship_pose_aligned(device="cpu", **small)
    only = tm.flagship_pose_only(device="cpu", **small, global_merge_pool=4,
                                 global_merge_stride=10)
    assert (point.core.depth_head, point.core.dpt_frames_chunk) == (None, 16)
    assert point.core.point_head is not None and point.core.camera_head is not None
    assert (pose.core.point_head, pose.core.dpt_frames_chunk) == (None, 16)
    assert only.core.depth_head is None and only.core.point_head is None
    assert (only.core.aggregator.merge_pool, only.core.aggregator.merge_stride) == (4, 10)
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises((RuntimeError, AssertionError)):
            tm.flagship_pose_only(**small)
