"""The port's chunk driver and recomputation, on the CPU in fp32
(vitslam_tpu_torch/slam/pipeline.py, ops/attention.py::remat): the host
fetch runs one chunk behind; ``ChunkedPipeline(train=True)`` keeps the
outputs on autograd and equals the inference outputs when the head's
dropout is off; in training the AlignmentHead's blocks are recomputed in
the backward, and ``remat=True`` recomputes the backbone's blocks, with
gradients bit-equal to those without. The parity of the driver's keywords
with the reference's is in test_torch_slice.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_weights import seeded  # noqa: E402
from vitslam_tpu_torch.models import (  # noqa: E402
    FeatureAlignedVGGT,
    PointAlignedVGGT,
    PoseAlignedVGGT,
)
from vitslam_tpu_torch.nn import layers as tl  # noqa: E402
from vitslam_tpu_torch.nn.layers import Block, CrossAttentionBlock  # noqa: E402
from vitslam_tpu_torch.ops import plain_attention_routes  # noqa: E402
from vitslam_tpu_torch.ops import attention as tattn  # noqa: E402
from vitslam_tpu_torch.slam import ChunkedPipeline  # noqa: E402
from vitslam_tpu_torch.utils import make_synthetic_batch  # noqa: E402

torch.set_num_threads(2)
BACKBONE = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=4,
                patch_embed_depth=1, intermediate_layers=(0, 1, 1, 1))
TINY = dict(BACKBONE, num_memory_tokens=4, align_embed_dim=64, align_dec_dim=64)
H, W = 28, 42


def _batch(n: int = 7):
    return make_synthetic_batch(B=1, N=n, H=H, W=W, seed=1)


def _count_calls(model, types) -> dict:
    """name -> list that grows by one per forward call of each submodule
    of ``types`` (a pre-hook: a recomputation stops early, once it has
    recomputed what the backward needs); hooks removed by the caller."""
    calls, handles = {}, []
    for name, mod in model.named_modules():
        if type(mod) in types:
            calls[name] = []
            handles.append(mod.register_forward_pre_hook(
                lambda m, a, name=name: calls[name].append(1)))
    return calls, handles


def test_fetch_runs_one_chunk_behind(monkeypatch):
    """Chunk i's host dict is made only after chunk i + 1 was queued."""
    model = seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu"), 1)
    pipe = ChunkedPipeline(model)
    events = []
    step, wait = pipe.step, pipe._wait
    monkeypatch.setattr(pipe, "step", lambda *a, **k: events.append("step") or step(*a, **k))
    monkeypatch.setattr(pipe, "_wait", lambda f: events.append("wait") or wait(f))
    pipe.run_sequence(_batch(), chunk_width=3, num_overlap=1)
    assert events == ["step", "step", "wait", "step", "wait", "wait"]


def test_train_mode_keeps_autograd_and_matches_inference():
    """train=True (frame dropout off): outputs on autograd, equal to the
    inference driver's within fp32 rounding (rel 1e-6; the recomputed
    blocks change nothing), and a gradient on every trainable tensor that
    the outputs reach, all finite."""
    model = seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu"), 1)
    model.alignment_head.drop_prob_nonoverlap = 0.0
    batch = _batch()
    want, _ = ChunkedPipeline(model).run_sequence(batch, chunk_width=3, num_overlap=1)
    got, _ = ChunkedPipeline(model, train=True).run_sequence(
        batch, chunk_width=3, num_overlap=1, rng=torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    assert got["chunk_sim3_enc"].requires_grad and got["pose_enc"].requires_grad
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    loss = sum(got[k].float().square().mean() for k in ("pose_enc", "depth", "world_points",
                                                        "chunk_sim3_enc"))
    head = dict(model.alignment_head.named_parameters())
    grads = torch.autograd.grad(loss, list(head.values()), allow_unused=True)
    reached = {n: g for n, g in zip(head, grads) if g is not None}
    assert len(reached) > 0.9 * len(head)
    assert all(torch.isfinite(g).all() for g in reached.values())
    assert any(g.abs().sum() > 0 for g in reached.values())


def test_head_blocks_are_recomputed_in_training(monkeypatch):
    """In a training step every frame and temporal block of the head runs
    twice per chunk (forward, then its recomputation in the backward), the
    decoder's blocks once; in inference each runs once. The recomputation
    keeps the forward's attention routes, also outside the block of
    plain_attention_routes the forward ran in."""
    model = seeded(FeatureAlignedVGGT(**TINY, dtype=torch.float32, device="cpu"), 1)
    head = model.alignment_head
    calls, handles = _count_calls(head, (Block, CrossAttentionBlock))
    try:
        batch = _batch(5)
        ChunkedPipeline(model).run_sequence(batch, chunk_width=3, num_overlap=1)
        assert all(len(c) == 2 for c in calls.values())  # 2 chunks, once each
        for c in calls.values():
            c.clear()
        seen = []  # whether the kernels were switched off at each routing
        real = tl.attention_route
        monkeypatch.setattr(tl, "attention_route", lambda *a, **k: seen.append(
            tattn._KERNELS_OFF[0]) or real(*a, **k))
        with plain_attention_routes():
            out, _ = ChunkedPipeline(model, train=True).run_sequence(
                batch, chunk_width=3, num_overlap=1, rng=torch.Generator().manual_seed(0))
        n_fwd = len(seen)
        out["chunk_sim3_enc"].sum().backward()
        assert len(seen) > n_fwd and all(seen), "the recomputation left the plain routes"
    finally:
        for h in handles:
            h.remove()
    recomputed = [n for n in calls if n.startswith(("frame_block_", "temporal_block_"))]
    assert len(recomputed) == 2 * head.depth_aa
    for name, c in calls.items():
        assert len(c) == (4 if name in recomputed else 2), (name, len(c))


@pytest.mark.parametrize("ctor", [FeatureAlignedVGGT, PointAlignedVGGT, PoseAlignedVGGT])
def test_backbone_remat_gives_the_same_gradients(ctor):
    """remat=True on a backbone with gradients on: every patch-embed,
    frame and global block runs twice and the gradient of every parameter
    is bit-equal to remat=False's (fp32, the same forward recomputed);
    without gradients remat changes nothing."""
    kw = dict(TINY) if ctor is FeatureAlignedVGGT else dict(BACKBONE, enable_point=True)
    models = [seeded(ctor(**kw, dtype=torch.float32, device="cpu", remat=r), 2)
              for r in (False, True)]
    images = torch.as_tensor(_batch(3)["images"])
    grads = []
    for remat, model in zip((False, True), models):
        calls, handles = _count_calls(model.core.aggregator, (Block,))
        try:
            raw = model.encode_chunks(images)
            loss = sum(v.float().square().mean() for v in raw.values())
            params = [p for p in model.core.parameters()]
            grads.append(torch.autograd.grad(loss, params, allow_unused=True))
            with torch.no_grad():
                model.encode_chunks(images)
        finally:
            for h in handles:
                h.remove()
        runs = 3 if remat else 2
        assert len(calls) == 1 + 2 * 2 and all(len(c) == runs for c in calls.values())
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
