"""Port parity for slice 2 end to end: the point- and pose-aligned models
(and the pose-only preset's head set) through the port's sequential and
two-stage drivers against vitslam_tpu's ChunkedPipeline, with the same
weights and numpy inputs, in fp32 on the CPU, where every kernel wrapper
runs its plain version.

The three variants share one seeded weight set (torch_weights.py): the
point and pose models have the same parameter tree, the pose-only head set a
subset of it. The port loads it back through export_torch_style ->
load_jax_params."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vitslam_tpu import models as jm  # noqa: E402
from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.slam import ChunkedPipeline as JaxPipeline  # noqa: E402
from vitslam_tpu.utils.testing import make_synthetic_batch  # noqa: E402
from vitslam_tpu_torch import models as tm  # noqa: E402
from vitslam_tpu_torch.io import load_jax_params  # noqa: E402
from vitslam_tpu_torch.slam import ChunkedPipeline  # noqa: E402

from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401

torch.set_num_threads(2)

KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
          patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1))
VARIANTS = {  # name -> (class name, head flags, sample mode, chunk width, overlap)
    # IRLS Sim(3) over 2 overlap frames, 4 chunks
    "point": ("PointAlignedVGGT", dict(enable_depth=True), "chunk_overlap", 4, 2),
    # GT poses: the LSE scale and the GT mean transform, point maps moved
    # by the chunk's transform, 2 chunks
    "pose": ("PoseAlignedVGGT", dict(enable_point=True), "chunk_gt", 5, 1),
    # Markley averaging of the relative poses over 2 overlap frames
    "pose_only": ("PoseAlignedVGGT", dict(enable_depth=False, enable_point=False),
                  "chunk_overlap", 4, 2),
}
H, W, N_FRAMES = 28, 42, 10
# fp32 on both sides through the whole model and 20 IRLS iterations:
# relative L2 error per output (measured ~1e-6)
RTOL = 1e-4


def _t(x):
    return torch.tensor(np.array(x))


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.fixture(scope="module")
def weights():
    """The frames, and one seeded weight set as JAX variables and as their
    export."""
    batch = make_synthetic_batch(B=1, N=N_FRAMES, H=H, W=W, seed=3)
    model = seeded(tm.PointAlignedVGGT(**KW, enable_depth=True, dtype=torch.float32))
    jmodel = jm.PointAlignedVGGT(**KW, enable_depth=True, dtype=jnp.float32)
    images = jnp.asarray(batch["images"][:, :4])
    params = jax_variables(lambda r: jmodel.init(r, images, 2), model)
    return batch, params, export_torch_style(params)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, weights):
    """The JAX pipeline's merged outputs and the port model with the same
    weights."""
    batch, params, flat = weights
    cls, flags, mode, width, overlap = VARIANTS[request.param]
    model = getattr(tm, cls)(**KW, **flags, dtype=torch.float32)
    # every parameter filled; strict (every key used) where all heads are on
    assert load_jax_params(model, flat, strict=request.param != "pose_only") == []
    run = dict(sample_mode=mode, chunk_width=width, num_overlap=overlap)
    # the JAX two-stage driver: it compiles the backbone once, the
    # sequential one twice (first chunk without state, then with)
    jmodel = getattr(jm, cls)(**KW, **flags, dtype=jnp.float32)
    want, _ = JaxPipeline(jmodel, params, encode_batch=4).run_sequence(batch, **run)
    return request.param, batch, model, want, run, flat


@pytest.mark.parametrize("encode_batch", [1, 3])
def test_pipeline_matches_jax(variant, encode_batch):
    name, batch, model, want, run, flat = variant
    got, _ = ChunkedPipeline(model, encode_batch=encode_batch).run_sequence(batch, **run)
    keys = sorted(want)
    assert keys == sorted(got) and "pose_enc" in keys
    assert ("world_points" in keys) == (name != "pose_only")
    assert ("depth" in keys) == (name != "pose_only")
    assert got["pose_enc"].shape == (1, N_FRAMES, 9)
    for k in keys:
        assert _rel_err(got[k], want[k]) <= RTOL, k
    if name == "pose":
        # the flagship_pose_aligned head set (point head off): the point
        # head feeds neither poses nor depth, so those match the same JAX run
        preset = tm.PoseAlignedVGGT(**KW, dtype=torch.float32)
        assert load_jax_params(preset, flat, strict=False) == []
        got, _ = ChunkedPipeline(preset, encode_batch=encode_batch).run_sequence(batch, **run)
        assert sorted(got) == ["depth", "depth_conf", "pose_enc"]
        for k in got:
            assert _rel_err(got[k], want[k]) <= RTOL, k
