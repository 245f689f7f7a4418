"""Port parity for the VGGT TrackHead: the bilinear gather (its wrapped
negative index on a one-pixel pyramid level included), the flow embedding,
the DPT head's feature-only mode, the EfficientUpdateFormer and a tiny
TrackHead, each against the JAX package on the same numpy inputs in fp32
with the port's seeded weights, and a strict load of a model with the
track head from the JAX package's variable names."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401
from vitslam_tpu import models as jm  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.models import track_head as jt  # noqa: E402
from vitslam_tpu_torch import models as tm  # noqa: E402
from vitslam_tpu_torch.io import load_jax_params  # noqa: E402
from vitslam_tpu_torch.models import track_head as tt  # noqa: E402

torch.set_num_threads(2)

# the gather and the embedding do the same fp32 arithmetic on both sides:
# equal to rounding (measured 0 and 1.4e-8)
SAMPLE_RTOL = 1e-6
# a few fp32 layers summed in another order: relative L2 error per output
# (measured 1.5e-7 to 4.4e-7)
RTOL = 1e-5
H, W, PS = 28, 42, 14


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("hw", [(6, 9), (1, 4), (3, 1), (1, 1)])
def test_bilinear_sample_matches_jax(hw):
    """Coordinates inside, on and outside the map. On the (1, 4) level (the
    flagship's coarsest, 7 levels down from 77 x 259) the clip puts y at
    -0.001, y0 = -1, and the flat index wraps to the last row; on (1, 1)
    both wrap and x0 + y0 * W = -2 is out of range: NaN, as in JAX."""
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    coords = rng.uniform(-2, max(hw) + 2, size=(2, 40, 2)).astype(np.float32)
    coords[:, :3] = [[0.0, 0.0], [hw[1] - 1, hw[0] - 1], [0.5, 0.25]]
    got = tt.bilinear_sample(_t(feat), _t(coords))
    want = np.asarray(jt.bilinear_sample(jnp.asarray(feat), jnp.asarray(coords)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    if hw == (1, 1):
        assert np.isnan(want).all()
        return
    assert _rel(got, want) <= SAMPLE_RTOL
    if hw[0] == 1:  # the wrapped index reads the pixel the reference reads
        assert not np.isnan(want).any()


def test_flow_embedding_matches_jax():
    xy = np.random.default_rng(1).normal(0, 0.01, size=(2, 3, 4, 2)).astype(np.float32)
    for dim in (8, 64):
        got = tt.get_2d_embedding(_t(xy), dim)
        assert got.shape == (2, 3, 4, 2 * dim)
        assert _rel(got, jt.get_2d_embedding(jnp.asarray(xy), dim)) <= SAMPLE_RTOL


def test_dpt_feature_only_matches_jax():
    """The track head's feature extractor: no pos embedding, 3x3 head_conv1
    at ``features`` channels, the fused 16 x 24 map downscaled to 14 x 21
    (1/2 of the image) with align-corners, channels last."""
    rng = np.random.default_rng(2)
    imgs = rng.uniform(size=(1, 2, 3, H, W)).astype(np.float32)
    taps = [rng.normal(size=(1, 2, 5 + 6, 32)).astype(np.float32) for _ in range(4)]
    kw = dict(dim_in=32, features=16, out_channels=(16, 32, 64, 64), patch_size=PS,
              pos_embed=False, feature_only=True, down_ratio=2)
    th = seeded(tm.DPTHead(**kw, dtype=torch.float32, device="cpu"))
    jh = jm.DPTHead(**kw, dtype=jnp.float32)
    jtaps = [jnp.asarray(t) for t in taps]
    v = jax_variables(lambda r: jh.init(r, jtaps, jnp.asarray(imgs), 5), th)
    want = jax.jit(jh.apply, static_argnums=3)(v, jtaps, jnp.asarray(imgs), 5)
    with torch.no_grad():
        got = th([_t(t) for t in taps], _t(imgs), 5)
    assert got.shape == (1, 2, H // 2, W // 2, 16)
    assert _rel(got, want) <= RTOL
    assert not hasattr(th, "head_out")


def _randomize(module, seed: int):
    """Draw the zero-initialised flow head from a seed, so the tracker
    moves its tracks and features."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        module.weight.normal_(0.0, 0.05, generator=g)
    return module


def test_update_former_matches_jax():
    """4 time blocks and 2 space stages (after time blocks 0 and 2), 8
    virtual tracks."""
    kw = dict(input_dim=24, hidden_size=32, output_dim=10, time_depth=4, space_depth=2,
              num_heads=4, num_virtual_tracks=8)
    tu = seeded(tt.EfficientUpdateFormer(**kw))
    assert len(tu.space_virtual_blocks) == 2 and not tu.flow_head.weight.any()
    _randomize(tu.flow_head, 3)
    ju = jt.EfficientUpdateFormer(**kw)
    x = np.random.default_rng(3).normal(size=(2, 5, 3, 24)).astype(np.float32)
    v = jax_variables(lambda r: ju.init(r, jnp.asarray(x)), tu)
    want = jax.jit(ju.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tu(_t(x))
    assert got.shape == (2, 5, 3, 10)
    assert _rel(got, want) <= RTOL


def test_track_head_matches_jax():
    """The tiny head of tests/test_models.py (features 16, hidden 64,
    updater depth 1, 2 iterations) with 4 correlation levels, so the
    coarsest of the 14 x 21 feature map's pyramid is 1 x 2 (one pixel tall:
    the wrapped gather); the flow head drawn from a seed, so the second
    iteration starts from moved tracks."""
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(1, 3, 3, H, W)).astype(np.float32)
    taps = [rng.normal(size=(1, 3, 5 + 6, 64)).astype(np.float32) for _ in range(4)]
    q = np.asarray([[[10.0, 12.0], [20.0, 5.0], [41.0, 27.0]]], np.float32)
    kw = dict(dim_in=64, patch_size=PS, features=16, iters=2, corr_levels=4, hidden_size=64,
              updater_depth=1)
    th = seeded(tm.TrackHead(**kw, dtype=torch.float32, device="cpu"))
    _randomize(th.tracker.updateformer.flow_head, 5)
    jh = jm.TrackHead(**kw, dtype=jnp.float32)
    jtaps = [jnp.asarray(t) for t in taps]
    v = jax_variables(lambda r: jh.init(r, jtaps, jnp.asarray(imgs), 5, jnp.asarray(q)), th)
    want = jax.jit(jh.apply, static_argnums=3)(v, jtaps, jnp.asarray(imgs), 5, jnp.asarray(q))
    with torch.no_grad():
        got = th([_t(t) for t in taps], _t(imgs), 5, _t(q))
    assert got[0].shape == (1, 3, 3, 2) and got[1].shape == got[2].shape == (1, 3, 3)
    assert np.abs(got[0].numpy() - q[:, None]).max() > 1e-3  # the tracks moved
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert _rel(g, w) <= RTOL


def test_strict_load_of_a_model_with_the_track_head():
    """Every flax name of a feature-aligned model with enable_track=True
    (time_blocks_<i>, space_*_blocks_<i>, ffeat_updater_0, the GroupNorm's
    scale, virual_tracks) fills a port parameter, and every port parameter
    is filled."""
    kw = dict(img_size=H, patch_size=PS, embed_dim=32, depth=2, num_heads=4,
              patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1), align_embed_dim=32,
              align_dec_dim=16, num_memory_tokens=4, enable_track=True)
    jmod = jm.FeatureAlignedVGGT(**kw, dtype=jnp.float32)
    imgs = jnp.zeros((1, 2, 3, H, W), jnp.float32)
    q = jnp.zeros((1, 2, 2), jnp.float32)

    def init(module, images, query):
        taps, psi = module.core.encode(images)
        return module(images, 1), module.core.decode_track(taps, images, psi, query)

    shapes = jax.eval_shape(lambda r: jmod.init(r, imgs, q, method=init), jax.random.PRNGKey(0))
    flat = export_torch_style(jax.tree.map(lambda s: np.full(s.shape, 0.5, s.dtype), shapes))
    track_keys = [k for k in flat if ".track_head." in k]
    assert any("time_blocks_5" in k for k in track_keys)
    assert any(k.endswith("virual_tracks") for k in track_keys)
    assert any(k.endswith("ffeat_norm.scale") for k in track_keys)
    tmod = tm.FeatureAlignedVGGT(**kw, dtype=torch.float32, device="cpu")
    assert load_jax_params(tmod, flat, strict=True) == []
    head = tmod.core.track_head
    assert all(bool((p == 0.5).all()) for p in head.parameters())
    assert len(head.tracker.updateformer.time_blocks) == 6
