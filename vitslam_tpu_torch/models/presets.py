"""Model presets (port of vitslam_tpu/models/presets.py).

``flagship()`` is the reference's shipped configuration: a VGGT-1B-scale
backbone (DINOv2-L patch embed: 24 blocks at 1024; 24 frame/global pairs at
1024; taps 4/11/17/23) + an AlignmentHead with 8 memory tokens and temporal
attention; camera, depth and point heads on, track head off, bf16 backbone
projections (``int8=True``: the int8 serving mode). The large-chunk
presets put the same backbone under the training-free point- and
pose-aligned models, which the reference runs at chunk width 75 / overlap
30. The KV merge of the global attention is a keyword override
(``global_merge_pool``, ``global_merge_stride``).

Every preset builds the model on ``device`` (the GPU unless the caller asks
for the CPU) with weights drawn from a ``torch.Generator`` seeded with
``seed``.
"""
from __future__ import annotations

import torch

from ..nn.layers import init_weights
from .feature_aligned import FeatureAlignedVGGT
from .point_aligned import PointAlignedVGGT
from .pose_aligned import PoseAlignedVGGT

FLAGSHIP = dict(
    img_size=518, patch_size=14, embed_dim=1024, depth=24, num_heads=16,
    patch_embed_depth=24, intermediate_layers=(4, 11, 17, 23),
    enable_camera=True, enable_depth=True, enable_point=True,
    enable_track=False, dtype=torch.bfloat16, int8=False,
)

SMALL = dict(
    img_size=224, patch_size=14, embed_dim=384, depth=6, num_heads=6,
    patch_embed_depth=4, intermediate_layers=(1, 2, 4, 5),
    enable_camera=True, enable_depth=True, enable_point=True,
    enable_track=False, dtype=torch.bfloat16, int8=False,
)


def _build(cls, base: dict, overrides: dict, device, seed: int):
    kw = dict(base)
    kw.update(overrides)
    model = cls(**kw, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def _feature(base: dict, overrides: dict, device, seed: int) -> FeatureAlignedVGGT:
    kw = dict(num_memory_tokens=8, temporal_attention=True)
    kw.update(overrides)
    return _build(FeatureAlignedVGGT, base, kw, device, seed)


def flagship(device="cuda", seed: int = 0, **overrides) -> FeatureAlignedVGGT:
    return _feature(FLAGSHIP, overrides, device, seed)


def small_feature_aligned(device="cuda", seed: int = 0,
                          **overrides) -> FeatureAlignedVGGT:
    return _feature(SMALL, overrides, device, seed)


def flagship_point_aligned(device="cuda", seed: int = 0, **overrides) -> PointAlignedVGGT:
    """The point-aligned model at chunk width 75: the DPT head decodes at
    most 16 frames per call (15 at width 75), so the full-resolution conv
    intermediates of all frames are never live at once."""
    kw = dict(enable_depth=False, dpt_frames_chunk=16)
    kw.update(overrides)
    return _build(PointAlignedVGGT, FLAGSHIP, kw, device, seed)


def flagship_pose_aligned(device="cuda", seed: int = 0, **overrides) -> PoseAlignedVGGT:
    kw = dict(enable_point=False, dpt_frames_chunk=16)
    kw.update(overrides)
    return _build(PoseAlignedVGGT, FLAGSHIP, kw, device, seed)


def flagship_pose_only(device="cuda", seed: int = 0, **overrides) -> PoseAlignedVGGT:
    """Trajectory-only serving: the camera head alone, no DPT decode; the
    chunk-and-align math is the pose-aligned model's."""
    kw = dict(enable_depth=False, enable_point=False)
    kw.update(overrides)
    return _build(PoseAlignedVGGT, FLAGSHIP, kw, device, seed)
