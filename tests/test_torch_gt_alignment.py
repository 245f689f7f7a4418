"""Port parity for the GT-alignment slice: geometry/projection.py, the
synthetic GT batch, the chunking helpers (normalize_extrinsics_and_points,
check_and_fix_inf_nan), every alignment type of slam/gt_alignment.py, and
ChunkedPipeline.run_sequence with GT alignment on a small model, against
vitslam_tpu with the same numpy inputs (and the same seeded weights), in
fp32 on the CPU. Relative L2 error per output <= 1e-4 (fp32 in another
summation order; measured ~1e-7 for the closed forms)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_weights import jax_variables, seeded  # noqa: E402
from vitslam_tpu import geometry as jgeo  # noqa: E402
from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel  # noqa: E402
from vitslam_tpu.slam import ChunkedPipeline as JaxPipeline  # noqa: E402
from vitslam_tpu.slam import chunking as jchunk  # noqa: E402
from vitslam_tpu.slam import gt_alignment as jalign  # noqa: E402
from vitslam_tpu.utils.testing import make_synthetic_batch as jax_batch  # noqa: E402
from vitslam_tpu_torch import geometry as tgeo  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.slam import ChunkedPipeline, chunking, gt_alignment  # noqa: E402
from vitslam_tpu_torch.utils import make_synthetic_batch  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-4
TYPES = ["per_frame_scale_from_poses", "scale_from_poses", "scale_from_fc_poses",
         "scale_from_depths", "sim3_from_poses", "sim3_from_points", "none"]


def _close(got, want, rtol=RTOL, name=""):
    a = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    b = np.asarray(want, np.float32)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    err = np.linalg.norm(a.astype(np.float64) - b) / max(np.linalg.norm(b), 1e-12)
    assert err <= rtol, (name, err)


def test_projection_and_synthetic_batch_match_jax():
    batch = make_synthetic_batch(B=2, N=3, H=10, W=14, seed=4)
    want = jax_batch(B=2, N=3, H=10, W=14, seed=4)
    assert batch.keys() == want.keys()
    for k in batch:
        _close(batch[k], want[k], name=k)
    e, K = batch["extrinsics"], batch["intrinsics"]
    np.testing.assert_array_equal(tgeo.generate_pixel_grid(10, 14).numpy(),
                                  np.asarray(jgeo.generate_pixel_grid(10, 14)))
    pts = tgeo.unproject_depth_to_points(torch.tensor(batch["depths"])[..., None],
                                         torch.tensor(e), torch.tensor(K))
    _close(pts, jgeo.unproject_depth_to_points(jnp.asarray(batch["depths"])[..., None],
                                               jnp.asarray(e), jnp.asarray(K)))
    # points on both sides of the camera and at the |w| limits
    wp = batch["world_points"] * np.linspace(-1.5, 8.0, 14, dtype=np.float32)[:, None]
    pix, valid = tgeo.project_points_to_pixels(torch.tensor(wp), torch.tensor(e),
                                               torch.tensor(K))
    jpix, jvalid = jgeo.project_points_to_pixels(jnp.asarray(wp), jnp.asarray(e), jnp.asarray(K))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not valid.all() and valid.any()
    _close(pix, jpix)


@pytest.mark.parametrize("scale_by_points", [False, True])
def test_chunking_helpers_match_jax(scale_by_points):
    batch = make_synthetic_batch(B=2, N=4, H=8, W=12, seed=5)
    rng = np.random.default_rng(0)
    cam = rng.normal(size=batch["world_points"].shape).astype(np.float32)
    args = (batch["extrinsics"], cam, batch["world_points"], batch["depths"])
    got = chunking.normalize_extrinsics_and_points(
        *(torch.tensor(a) for a in args), scale_by_points=scale_by_points,
        point_masks=torch.tensor(batch["point_masks"]))
    want = jchunk.normalize_extrinsics_and_points(
        *(jnp.asarray(a) for a in args), scale_by_points=scale_by_points,
        point_masks=jnp.asarray(batch["point_masks"]))
    for g, w in zip(got, want):
        _close(g, w)
    x = np.array([1.0, np.nan, np.inf, -np.inf, -250.0, 3.0], np.float32)
    for hard_max in (None, 100.0):
        np.testing.assert_array_equal(
            chunking.check_and_fix_inf_nan(torch.tensor(x), hard_max=hard_max).numpy(),
            np.asarray(jchunk.check_and_fix_inf_nan(jnp.asarray(x), hard_max=hard_max)))


def _predictions(batch, seed=1):
    """Noisy, mis-scaled predictions of a synthetic batch (numpy)."""
    rng = np.random.default_rng(seed)
    B, S = batch["extrinsics"].shape[:2]
    t = batch["extrinsics"][..., :3, 3] * 0.7 + rng.normal(0, 0.05, (B, S, 3))
    q = rng.normal(size=(B, S, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    fov = rng.uniform(0.8, 1.4, (B, S, 2))
    noise = lambda x: x * rng.uniform(0.9, 1.1, x.shape)  # noqa: E731
    return {
        "pose_enc": np.concatenate([t, q, fov], -1).astype(np.float32),
        "depth": noise(batch["depths"][..., None] * 0.5).astype(np.float32),
        "depth_conf": rng.uniform(1, 3, batch["depths"].shape).astype(np.float32),
        "world_points": (noise(batch["world_points"] * 0.6)
                         + rng.normal(0, 0.1, batch["world_points"].shape)).astype(np.float32),
        "world_points_conf": rng.uniform(1, 5, batch["depths"].shape).astype(np.float32),
    }


@pytest.mark.parametrize("alignment_type", TYPES)
def test_alignment_types_match_jax(alignment_type):
    batch = make_synthetic_batch(B=2, N=6, H=14, W=21, seed=2)
    pred = _predictions(batch)
    kw = dict(seq_width=3) if alignment_type == "scale_from_fc_poses" else {}
    got = gt_alignment.align_outputs({k: torch.tensor(v) for k, v in pred.items()}, batch,
                                     alignment_type, image_size_hw=(14, 21), **kw)
    want = jalign.align_outputs({k: jnp.asarray(v) for k, v in pred.items()}, batch,
                                alignment_type, image_size_hw=(14, 21), **kw)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], name=k)
    if alignment_type != "none":
        assert "alignment_scales" in got


def test_per_chunk_scale_and_apply_sim3_match_jax():
    batch = make_synthetic_batch(B=2, N=7, H=8, W=12, seed=3)
    pred = _predictions(batch)
    idx = chunking.generate_chunks(7, "chunk_overlap", 4, 1)
    chunks_b = chunking.chunk_batch(batch, idx)
    chunks_p = chunking.chunk_batch(pred, idx)
    got = gt_alignment.per_chunk_scale_from_poses(
        [{k: torch.tensor(v) for k, v in c.items()} for c in chunks_p], chunks_b)
    want = jalign.per_chunk_scale_from_poses(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in chunks_p], chunks_b)
    for g, w in zip(got, want):
        for k in w:
            _close(g[k], w[k], name=k)
    rng = np.random.default_rng(4)
    R = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0].astype(np.float32)
    T = np.zeros((2, 4, 4), np.float32)
    T[:, :3, :3], T[:, :3, 3], T[:, 3, 3] = R, rng.normal(size=(2, 3)), 1.0
    s = np.array([0.5, 2.0], np.float32)
    got = gt_alignment.apply_sim3_on_dict({k: torch.tensor(v) for k, v in pred.items()},
                                          (8, 12), torch.tensor(T), torch.tensor(s))
    want = jalign.apply_sim3_on_dict({k: jnp.asarray(v) for k, v in pred.items()},
                                     (8, 12), jnp.asarray(T), jnp.asarray(s))
    for k in want:
        _close(got[k], want[k], name=k)
    with pytest.raises(ValueError):
        gt_alignment.align_outputs({k: torch.tensor(v) for k, v in pred.items()}, batch,
                                   "bogus")


KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
          patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1),
          align_embed_dim=32, align_dec_dim=16, num_memory_tokens=4)


@pytest.fixture(scope="module")
def pipelines():
    batch = make_synthetic_batch(B=1, N=7, H=28, W=42, seed=6)
    model = seeded(FeatureAlignedVGGT(**KW, dtype=torch.float32), seed=3)
    jmodel = JaxModel(**KW, dtype=jnp.float32)
    params = jax_variables(lambda r: jmodel.init(r, jnp.asarray(batch["images"][:, :4]), 1),
                           model)
    return batch, ChunkedPipeline(model), JaxPipeline(jmodel, params)


@pytest.mark.parametrize("alignment_type", ["scale_from_poses", "per_chunk_scale_from_poses",
                                            "scale_from_depths"])
def test_run_sequence_with_gt_alignment_matches_jax(pipelines, alignment_type):
    """The pipeline's GT alignment end to end: per chunk before the merge
    (per_chunk_scale_from_poses) or on the merged predictions."""
    batch, pipe, jpipe = pipelines
    got, merged = pipe.run_sequence(batch, chunk_width=4, num_overlap=1,
                                    gt_alignment_type=alignment_type)
    want, _ = jpipe.run_sequence(batch, chunk_width=4, num_overlap=1,
                                 gt_alignment_type=alignment_type)
    assert "alignment_scales" in got
    for k in ("pose_enc", "depth", "world_points", "alignment_scales"):
        _close(got[k], want[k], name=k)
    np.testing.assert_array_equal(merged["extrinsics"], batch["extrinsics"])
