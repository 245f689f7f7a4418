"""Port parity for slice 1 end to end: ChunkedPipeline.run_sequence over 3
chunks, through the port's sequential and two-stage (encode_batch) drivers,
against vitslam_tpu's ChunkedPipeline with the same weights, in fp32. The
chunk width and image size put the global attention at 384 tokens, so the
port takes the fused (K1) route there."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vitslam_tpu.io.torch_convert import export_torch_style  # noqa: E402
from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel  # noqa: E402
from vitslam_tpu.slam import ChunkedPipeline as JaxPipeline  # noqa: E402
from vitslam_tpu.slam import chunking as jchunk  # noqa: E402
from vitslam_tpu.utils.testing import make_synthetic_batch  # noqa: E402
from vitslam_tpu_torch.io import load_jax_params  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.ops import ROUTE_COUNTS  # noqa: E402
from vitslam_tpu_torch.slam import ChunkedPipeline, chunking  # noqa: E402

torch.set_num_threads(2)

KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
          patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1),
          align_embed_dim=32, align_dec_dim=16, num_memory_tokens=4)
# 98 x 182 frames: 7 x 13 patches + 5 specials = 96 tokens; 4 frames = 384
H, W, N_FRAMES, WIDTH, OVERLAP = 98, 182, 10, 4, 1
KEYS = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf",
        "chunk_sim3_enc", "frame_se3_enc", "memory_tokens")
# fp32 on both sides through the whole model: relative L2 error per output
# (measured ~1e-6; points pass expm1 and a rigid transform)
RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    batch = make_synthetic_batch(B=1, N=N_FRAMES, H=H, W=W)
    jmodel = JaxModel(**KW, dtype=jnp.float32)
    jpipe = JaxPipeline(jmodel)
    params = jpipe.init_params(jax.random.PRNGKey(0),
                               jnp.asarray(batch["images"][:, :WIDTH]), OVERLAP)
    want, _ = jpipe.run_sequence(batch, chunk_width=WIDTH, num_overlap=OVERLAP)
    model = FeatureAlignedVGGT(**KW, dtype=torch.float32)
    load_jax_params(model, export_torch_style(params))
    return batch, model, want, jpipe


@pytest.mark.parametrize("encode_batch", [1, 4])
def test_pipeline_matches_jax(setup, encode_batch):
    batch, model, want, _ = setup
    before = ROUTE_COUNTS["fused"]
    got, merged = ChunkedPipeline(model, encode_batch=encode_batch).run_sequence(
        batch, chunk_width=WIDTH, num_overlap=OVERLAP)
    n_chunks = got["chunk_sim3_enc"].shape[1]
    assert n_chunks == 3
    # one fused global attention per aggregator layer per encode: every chunk
    # sequentially, or the 3 chunks stacked in one batched encode
    encodes = n_chunks if encode_batch == 1 else 1
    assert ROUTE_COUNTS["fused"] - before == KW["depth"] * encodes
    assert got["pose_enc"].shape == (1, N_FRAMES, 9)
    assert got["depth"].shape == (1, N_FRAMES, H, W, 1)
    assert got["world_points"].shape == (1, N_FRAMES, H, W, 3)
    for k in KEYS:
        a = got[k].numpy()
        b = np.asarray(want[k], np.float32)
        assert a.shape == b.shape, k
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= RTOL, (k, err)
    np.testing.assert_array_equal(merged["images"], batch["images"])


def test_unported_gt_alignment_raises(setup):
    """GT alignment is ported: scale_from_poses scales the merged pose
    translations, depths and points by one scale per batch element
    (test_torch_gt_alignment.py holds every type to JAX); an unknown type
    raises."""
    batch, model, want, _ = setup
    got, _ = ChunkedPipeline(model).run_sequence(
        batch, chunk_width=WIDTH, num_overlap=OVERLAP, gt_alignment_type="scale_from_poses")
    s = got["alignment_scales"].numpy()
    assert s.shape == (1,) and s[0] > 0
    for k in ("depth", "world_points"):
        a = got[k].numpy()
        b = np.asarray(want[k], np.float32) * s[0]
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= RTOL, k
    with pytest.raises(ValueError):
        ChunkedPipeline(model).run_sequence(batch, chunk_width=WIDTH, num_overlap=OVERLAP,
                                            gt_alignment_type="bogus")


@pytest.mark.parametrize("mode,width,overlap", [
    ("chunk_overlap", 5, 1), ("chunk_overlap", 4, 2), ("chunk_gt", 4, 0),
    ("all", 4, 0), ("two_chunks", 4, 0),
])
def test_chunking_matches_jax(mode, width, overlap):
    n = 13
    idx = chunking.generate_chunks(n, mode, width, overlap, rng=random.Random(3))
    assert idx == jchunk.generate_chunks(n, mode, width, overlap, rng=random.Random(3))
    rng = np.random.default_rng(0)
    batch = {"images": rng.normal(size=(1, n, 2)).astype(np.float32),
             "extrinsics": rng.normal(size=(1, n, 3, 4)).astype(np.float32)}
    tchunks = chunking.chunk_batch({k: torch.tensor(v) for k, v in batch.items()}, idx)
    jchunks = jchunk.chunk_batch(batch, idx)
    for tc, jc in zip(tchunks, jchunks):
        for k in jc:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    outs = [{"pose_enc": c["extrinsics"][..., 0], "chunk_sim3_enc": c["images"][:, :1],
             "pose_enc_list": [c["images"]], "last": c["images"]} for c in tchunks]
    got = chunking.merge_chunk_outputs(outs, overlap)
    want = jchunk.merge_chunk_outputs([{k: (np.asarray(v) if not isinstance(v, list)
                                            else [np.asarray(x) for x in v])
                                        for k, v in o.items()} for o in outs], overlap)
    for k in ("pose_enc", "chunk_sim3_enc", "last"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    np.testing.assert_array_equal(got["pose_enc_list"][0].numpy(), want["pose_enc_list"][0])


def _close(got: dict, want: dict, keys):
    for k in keys:
        a = np.asarray(got[k], np.float32)
        b = np.asarray(want[k], np.float32)
        assert a.shape == b.shape, k
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= RTOL, (k, err)


@pytest.mark.parametrize("encode_batch", [1, 4])
@pytest.mark.parametrize("case", ["keep_images", "merge_overlap_0", "py_rng_two_chunks"])
def test_run_sequence_keywords_match_jax(setup, case, encode_batch):
    """run_sequence's keep_images (each chunk's images merged into the
    predictions), merge_overlap=0 (the overlap frames kept twice) and a
    seeded py_rng drawing the two_chunks split, through both drivers,
    against the reference's run_sequence with the same keywords."""
    batch, model, _, jpipe = setup
    kw = {"keep_images": dict(chunk_width=WIDTH, num_overlap=OVERLAP, keep_images=True),
          "merge_overlap_0": dict(chunk_width=WIDTH, num_overlap=OVERLAP, merge_overlap=0),
          "py_rng_two_chunks": dict(sample_mode="two_chunks", chunk_width=WIDTH,
                                    num_overlap=OVERLAP)}[case]
    rng = {}
    if case == "py_rng_two_chunks":  # 8 frames: two chunks of WIDTH, shapes compiled above
        batch = {k: v[:, :2 * WIDTH] for k, v in batch.items()}
        rng = {"py_rng": random.Random(5)}
    want, want_merged = jpipe.run_sequence(batch, **kw, **rng)
    if case == "py_rng_two_chunks":
        rng = {"py_rng": random.Random(5)}
    got, merged = ChunkedPipeline(model, encode_batch=encode_batch).run_sequence(
        batch, **kw, **rng)
    assert got.keys() == want.keys()
    _close(got, want, KEYS)
    for k in want_merged:
        np.testing.assert_array_equal(np.asarray(merged[k]), np.asarray(want_merged[k]),
                                      err_msg=k)
    n = got["pose_enc"].shape[1]
    if case == "keep_images":
        np.testing.assert_array_equal(got["images"].numpy(), batch["images"])
    elif case == "merge_overlap_0":
        assert n == N_FRAMES + 2 * OVERLAP  # 3 chunks, the overlap frames twice
    else:
        assert n == merged["images"].shape[1] and not np.array_equal(
            merged["images"], batch["images"][:, :n])  # a random split, not the first frames
