"""Port parity for models/: patch embedding, Aggregator, CameraHead,
DPTHead, AlignmentHead and the feature-aligned chunk step, each with the
port module's seeded weights moved into the JAX module's variable tree
(torch_weights.py: the tree from jax.eval_shape of the init, no compile)
on the same numpy inputs, in fp32 at small widths."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401
from vitslam_tpu import models as jm  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.slam.state import FeatureAlignContext as JContext  # noqa: E402
from vitslam_tpu_torch import models as tm  # noqa: E402
from vitslam_tpu_torch.io.from_jax import port_name  # noqa: E402
from vitslam_tpu_torch.ops import ROUTE_COUNTS  # noqa: E402
from vitslam_tpu_torch.slam.state import FeatureAlignContext  # noqa: E402

torch.set_num_threads(2)
F32 = jnp.float32

# fp32 on both sides through a few layers in another summation order:
# relative L2 error per output well under 1e-4 (measured ~1e-6)
RTOL = 1e-4


def _t(x):
    return torch.tensor(np.array(x))


def _rel_close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert err <= rtol, err


def _port(jmodule, tmodule, *args, static=()):
    """Seed the port module's weights and move them into the flax module's
    variables (every flax leaf a port parameter, every parameter used);
    return the variables and a jitted apply. ``static`` are the indices of
    static args (counting the variables as 0)."""
    seeded(tmodule)
    variables = jax_variables(lambda rng: jmodule.init(rng, *args), tmodule)
    assert {port_name(k) for k in export_torch_style(variables)} == \
        {n for n, _ in tmodule.named_parameters()}
    return variables, jax.jit(jmodule.apply, static_argnums=static)


def _images(B, S, H, W, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(B, S, 3, H, W)).astype(np.float32)


def test_patch_embed_and_aggregator_match_jax():
    """Aggregator with its patch embedding (pos-embed resized 2x2 -> 7x13)
    and taps; 4 frames of 96 tokens put the global attention at 384 tokens,
    on the fused route."""
    kw = dict(img_size=28, patch_size=14, embed_dim=64, depth=2, num_heads=1,
              patch_embed_depth=1, patch_embed_heads=2, intermediate_layers=(0, 1, 1))
    jagg = jm.Aggregator(**kw, dtype=F32)
    tagg = tm.Aggregator(**kw, dtype=torch.float32)
    imgs = _images(1, 4, 98, 182)
    v, apply = _port(jagg, tagg, jnp.asarray(imgs))
    before = ROUTE_COUNTS["fused"]
    taps, psi = tagg(_t(imgs))
    assert ROUTE_COUNTS["fused"] == before + 2  # one global attention per layer
    jtaps, jpsi = apply(v, jnp.asarray(imgs))
    assert psi == jpsi and len(taps) == 3
    for got, want in zip(taps, jtaps):
        _rel_close(got, want)
    # the split the pipeline's frame dedup uses: embed, then encode the tokens
    tok = tagg.embed(_t(imgs))
    _rel_close(tok, jax.jit(jagg.apply, static_argnums=3)(v, jnp.asarray(imgs), None, True))
    _rel_close(tagg(_t(imgs), tok)[0][0], jtaps[0])


def test_camera_and_dpt_heads_match_jax():
    rng = np.random.default_rng(1)
    cam = rng.normal(size=(2, 3, 64)).astype(np.float32)
    jc = jm.CameraHead(dim_in=64, trunk_depth=2, num_heads=4, dtype=F32)
    tc = tm.CameraHead(dim_in=64, trunk_depth=2, num_heads=4, dtype=torch.float32)
    v, apply = _port(jc, tc, jnp.asarray(cam))
    for got, want in zip(tc(_t(cam)), apply(v, jnp.asarray(cam))):
        _rel_close(got, want)

    imgs = _images(1, 2, 28, 42)
    taps = [rng.normal(size=(1, 2, 5 + 6, 64)).astype(np.float32) for _ in range(4)]
    for out_dim, act in ((2, "exp"), (4, "inv_log")):
        kw = dict(dim_in=64, output_dim=out_dim, features=32, out_channels=(16, 32, 64, 64),
                  activation=act)
        jd = jm.DPTHead(**kw, dtype=F32)
        td = tm.DPTHead(**kw, dtype=torch.float32)
        v, apply = _port(jd, td, [jnp.asarray(t) for t in taps], jnp.asarray(imgs), 5,
                         static=(3,))
        got = td([_t(t) for t in taps], _t(imgs), 5)
        want = apply(v, [jnp.asarray(t) for t in taps], jnp.asarray(imgs), 5)
        for g, w in zip(got, want):
            _rel_close(g, w)


@pytest.mark.parametrize("temporal", [True, False])
def test_alignment_head_first_and_next_chunk_match_jax(temporal):
    kw = dict(patch_size=14, in_dim=64, embed_dim=32, dec_dim=16, num_heads=2,
              num_memory_tokens=4, temporal_attention=temporal, depth_aa=2,
              depth_decoder=1)
    jh = jm.AlignmentHead(**kw, dtype=F32)
    th = tm.AlignmentHead(**kw, dtype=torch.float32)
    rng = np.random.default_rng(2)
    tok = rng.normal(size=(1, 3, 5 + 6, 64)).astype(np.float32)
    v, apply = _port(jh, th, jnp.asarray(tok), (28, 42), 1, static=(2, 3))
    got = th(_t(tok), (28, 42), 1)
    want = apply(v, jnp.asarray(tok), (28, 42), 1)
    for g, w in zip(got, want):
        _rel_close(g, w)
    # continuation chunk: previous overlap tokens + memory
    tok2 = rng.normal(size=(1, 3, 5 + 6, 64)).astype(np.float32)
    got2 = th(_t(tok2), (28, 42), 1, got[3], got[2])
    want2 = apply(v, jnp.asarray(tok2), (28, 42), 1, want[3], want[2])
    for g, w in zip(got2, want2):
        _rel_close(g, w)


def test_feature_aligned_chunk_steps_match_jax():
    """First chunk and a continuation chunk with overlap 2 (quaternion-
    averaged mean transform). The DPT heads are off
    here (the slice test covers them and the point transform) to keep the
    JAX compiles short."""
    kw = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
              patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1),
              align_embed_dim=32, align_dec_dim=16, num_memory_tokens=4,
              enable_depth=False, enable_point=False)
    jmod = jm.FeatureAlignedVGGT(**kw, dtype=F32)
    tmod = tm.FeatureAlignedVGGT(**kw, dtype=torch.float32)
    imgs = _images(1, 4, 28, 42, seed=3)
    v, apply = _port(jmod, tmod, jnp.asarray(imgs), 2, static=(2,))
    out, ctx = tmod(_t(imgs), 2)
    jout, jctx = apply(v, jnp.asarray(imgs), 2)
    for k in jout:
        _rel_close(out[k], jout[k])
    imgs2 = _images(1, 4, 28, 42, seed=4)
    out2, ctx2 = tmod(_t(imgs2), 2, ctx)
    jout2, _ = apply(v, jnp.asarray(imgs2), 2, jctx)
    for k in jout2:
        _rel_close(out2[k], jout2[k])
    assert isinstance(ctx2, FeatureAlignContext) and isinstance(jctx, JContext)
