"""Model presets (port of vitslam_tpu/models/presets.py).

``flagship()`` is the reference's shipped configuration: a VGGT-1B-scale
backbone (DINOv2-L patch embed: 24 blocks at 1024; 24 frame/global pairs at
1024; taps 4/11/17/23) + an AlignmentHead with 8 memory tokens and temporal
attention; camera, depth and point heads on, track head off. The presets
build the model on ``device`` with weights drawn from a ``torch.Generator``
seeded with ``seed``.
"""
from __future__ import annotations

import torch

from ..nn.layers import init_weights
from .feature_aligned import FeatureAlignedVGGT

FLAGSHIP = dict(
    img_size=518, patch_size=14, embed_dim=1024, depth=24, num_heads=16,
    patch_embed_depth=24, intermediate_layers=(4, 11, 17, 23),
    enable_camera=True, enable_depth=True, enable_point=True,
    enable_track=False, dtype=torch.bfloat16,
)

SMALL = dict(
    img_size=224, patch_size=14, embed_dim=384, depth=6, num_heads=6,
    patch_embed_depth=4, intermediate_layers=(1, 2, 4, 5),
    enable_camera=True, enable_depth=True, enable_point=True,
    enable_track=False, dtype=torch.bfloat16,
)


def _build(base: dict, overrides: dict, device, seed: int) -> FeatureAlignedVGGT:
    kw = dict(base)
    kw.update(overrides)
    kw.setdefault("num_memory_tokens", 8)
    kw.setdefault("temporal_attention", True)
    model = FeatureAlignedVGGT(**kw, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def flagship(device="cpu", seed: int = 0, **overrides) -> FeatureAlignedVGGT:
    return _build(FLAGSHIP, overrides, device, seed)


def small_feature_aligned(device="cpu", seed: int = 0,
                          **overrides) -> FeatureAlignedVGGT:
    return _build(SMALL, overrides, device, seed)
