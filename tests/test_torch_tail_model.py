"""Port parity for the fused block tails through a whole model: a tiny
FeatureAlignedVGGT with mlp_tail="both" over two chunks of ChunkedPipeline,
against vitslam_tpu's pipeline with VITSLAM_MLP_TAIL=1 (the Pallas tail
kernel in interpret mode) and the same weights, in fp32. The frames are
98 x 364 (7 x 26 patches + 5 special tokens = 187 tokens) at chunk width 6,
so every backbone block sees 1,122 >= 1,024 rows and takes both tails."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vitslam_tpu.models import FeatureAlignedVGGT as JaxModel  # noqa: E402
from vitslam_tpu.slam import ChunkedPipeline as JaxPipeline  # noqa: E402
from vitslam_tpu.utils.testing import make_synthetic_batch  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.slam import ChunkedPipeline  # noqa: E402

from torch_weights import jax_variables, seeded, shared_jax_cache  # noqa: E402,F401

torch.set_num_threads(2)

KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
          patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1),
          align_embed_dim=32, align_dec_dim=16, num_memory_tokens=4)
H, W, N_FRAMES, WIDTH, OVERLAP = 98, 364, 11, 6, 1
KEYS = ("pose_enc", "depth", "world_points", "chunk_sim3_enc", "memory_tokens")
# fp32 on both sides through the whole model (the slice's own tolerance)
RTOL = 1e-4


def test_tail_model_matches_jax_fused_tails(monkeypatch):
    batch = make_synthetic_batch(B=1, N=N_FRAMES, H=H, W=W)
    model = seeded(FeatureAlignedVGGT(**KW, dtype=torch.float32, mlp_tail="both"), seed=3)
    jmodel = JaxModel(**KW, dtype=jnp.float32)
    # the two-stage driver compiles the backbone (its interpreted kernels
    # included) once, the sequential one twice; the same outputs
    jpipe = JaxPipeline(jmodel, encode_batch=2)
    images = jnp.asarray(batch["images"][:, :WIDTH])
    jpipe.params = jax_variables(lambda rng: jmodel.init(rng, images, OVERLAP), model)
    monkeypatch.setenv("VITSLAM_MLP_TAIL", "1")
    with pltpu.force_tpu_interpret_mode():
        want, _ = jpipe.run_sequence(batch, chunk_width=WIDTH, num_overlap=OVERLAP)

    sites = []
    real = tl.mlp_tail
    monkeypatch.setattr(tl, "mlp_tail", lambda *a, **k: sites.append(k["ln"]) or real(*a, **k))
    got, _ = ChunkedPipeline(model).run_sequence(batch, chunk_width=WIDTH, num_overlap=OVERLAP)
    n_chunks = got["chunk_sim3_enc"].shape[1]
    assert n_chunks == 2
    # per chunk 1 patch-embed + 2 x 2 aggregator blocks, each with both tails
    blocks = KW["patch_embed_depth"] + 2 * KW["depth"]
    assert sorted(sites) == sorted([False, True] * blocks * n_chunks)
    for k in KEYS:
        a = got[k].numpy()
        b = np.asarray(want[k], np.float32)
        assert a.shape == b.shape, k
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= RTOL, (k, err)
