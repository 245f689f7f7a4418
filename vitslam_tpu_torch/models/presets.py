"""Model presets (port of vitslam_tpu/models/presets.py).

``flagship()`` is the reference's shipped configuration: a VGGT-1B-scale
backbone (DINOv2-L patch embed: 24 blocks at 1024; 24 frame/global pairs at
1024; taps 4/11/17/23) + an AlignmentHead with 8 memory tokens and temporal
attention; camera, depth and point heads on, track head off, bf16 backbone
projections (``int8=True`` or ``VITSLAM_INT8=1``: the int8 serving mode).
The large-chunk presets put the same backbone under the training-free
point- and pose-aligned models, which the reference runs at chunk width 75
/ overlap 30.

The KV merge of the global attention (``global_merge_pool``,
``global_merge_stride``) is opt-in: ``VITSLAM_TOKEN_MERGE="<pool>,<stride>"``
(``"<pool>"`` alone means stride 1, an empty value no merge) sets it on
``flagship``, ``flagship_point_aligned``, ``flagship_pose_aligned`` and
``flagship_pose_only`` (not on ``small_feature_aligned``), read when the
preset is called; explicit keyword overrides win over it.

The reference's two block switches reach every preset, the small one too:
``VITSLAM_MLP_TAIL`` (``1`` = both fused tail sites, ``mlp`` or ``proj``
alone; empty, ``0``, ``off``, ``xla``, ``auto`` and any other value off)
routes the backbone blocks' residual tails through kernel K5, and
``VITSLAM_INT8=1`` (that value alone) runs their projections int8
(``ops.quant``; a block whose projections run int8 takes no fused tail).
Only the patch-embed, frame and global blocks take either; the heads take
neither. ``switch_overrides`` maps them as the reference's ``_tail_sites``
and ``int8_enabled`` do, and an explicit ``mlp_tail`` or ``int8`` keyword
wins. The reference reads both when it traces its layers; the port reads
them when the model is built, so they must be set before the preset (or
``cli.build_from_config``) is called. ``model_switches`` reads back what a
built model runs.

Every preset builds the model on ``device`` (the GPU unless the caller asks
for the CPU) with weights drawn from a ``torch.Generator`` seeded with
``seed``; on the ``meta`` device it holds shapes and dtypes alone.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from ..nn.layers import TAIL_MIN_ROWS, TAIL_SITES, Block, Dense, init_weights
from .aggregator import Aggregator
from .feature_aligned import FeatureAlignedVGGT
from .point_aligned import PointAlignedVGGT
from .pose_aligned import PoseAlignedVGGT

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


def token_merge_overrides(environ: Optional[Mapping[str, str]] = None) -> dict:
    """The KV-merge keywords ``VITSLAM_TOKEN_MERGE`` asks for in
    ``environ`` (default ``os.environ``): ``"<pool>,<stride>"`` (e.g.
    ``"2,5"``), ``"<pool>"`` for stride 1, nothing when unset or empty."""
    env = (os.environ if environ is None else environ).get("VITSLAM_TOKEN_MERGE", "")
    if not env:
        return {}
    pool, stride = (env.split(",") + ["1"])[:2]
    return dict(global_merge_pool=int(pool), global_merge_stride=int(stride))


# VITSLAM_MLP_TAIL -> the blocks' mlp_tail (the reference's _tail_sites;
# any other value is off)
MLP_TAIL_ENV = {"": "off", "0": "off", "off": "off", "xla": "off", "auto": "off",
                "1": "both", "mlp": "mlp", "proj": "proj"}


def mlp_tail_from_env(environ: Optional[Mapping[str, str]] = None) -> str:
    """The fused tail sites ``VITSLAM_MLP_TAIL`` asks for in ``environ``
    (default ``os.environ``): "both", "mlp", "proj" or "off"."""
    env = os.environ if environ is None else environ
    return MLP_TAIL_ENV.get(env.get("VITSLAM_MLP_TAIL", "0"), "off")


def int8_from_env(environ: Optional[Mapping[str, str]] = None) -> bool:
    """The reference's int8 switch: ``VITSLAM_INT8=1`` and nothing else."""
    return (os.environ if environ is None else environ).get("VITSLAM_INT8", "0") == "1"


def switch_overrides(environ: Optional[Mapping[str, str]] = None) -> dict:
    """The ``mlp_tail`` and ``int8`` keywords of the block switches in
    ``environ`` (default ``os.environ``)."""
    return dict(mlp_tail=mlp_tail_from_env(environ), int8=int8_from_env(environ))


def model_switches(model) -> dict:
    """What a built model runs: the tail sites its blocks take from
    ``TAIL_MIN_ROWS`` rows ("off" while their projections run int8),
    whether any projection runs int8, and its global attention's KV merge
    ("<pool>,<stride>" or "off")."""
    sites = frozenset().union(*(m.fused_sites(TAIL_MIN_ROWS) for m in model.modules()
                                if isinstance(m, Block)))
    merge = next(((m.merge_pool, m.merge_stride) for m in model.modules()
                  if isinstance(m, Aggregator)), (0, 1))
    return dict(mlp_tail=next(k for k, v in TAIL_SITES.items() if v == sites),
                int8=any(m.int8 for m in model.modules() if isinstance(m, Dense)),
                token_merge="%d,%d" % merge if merge[0] > 1 else "off")


def _merged(overrides: dict, token_merge: bool = True) -> dict:
    """The block switches' keywords (and ``VITSLAM_TOKEN_MERGE``'s, with
    ``token_merge``) under the explicit ``overrides``."""
    return {**switch_overrides(), **(token_merge_overrides() if token_merge else {}),
            **overrides}


def _build(cls, base: dict, overrides: dict, device, seed: int):
    kw = dict(base)
    kw.update(overrides)
    model = cls(**kw, device=device)
    if torch.device(device).type != "meta":
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def _feature(base: dict, overrides: dict, device, seed: int) -> FeatureAlignedVGGT:
    kw = dict(num_memory_tokens=8, temporal_attention=True)
    kw.update(overrides)
    return _build(FeatureAlignedVGGT, base, kw, device, seed)


def flagship(device="cuda", seed: int = 0, **overrides) -> FeatureAlignedVGGT:
    return _feature(FLAGSHIP, _merged(overrides), device, seed)


def small_feature_aligned(device="cuda", seed: int = 0,
                          **overrides) -> FeatureAlignedVGGT:
    return _feature(SMALL, _merged(overrides, token_merge=False), device, seed)


def flagship_point_aligned(device="cuda", seed: int = 0, **overrides) -> PointAlignedVGGT:
    """The point-aligned model at chunk width 75: the DPT head decodes at
    most 16 frames per call (15 at width 75), so the full-resolution conv
    intermediates of all frames are never live at once."""
    kw = dict(enable_depth=False, dpt_frames_chunk=16)
    kw.update(_merged(overrides))
    return _build(PointAlignedVGGT, FLAGSHIP, kw, device, seed)


def flagship_pose_aligned(device="cuda", seed: int = 0, **overrides) -> PoseAlignedVGGT:
    kw = dict(enable_point=False, dpt_frames_chunk=16)
    kw.update(_merged(overrides))
    return _build(PoseAlignedVGGT, FLAGSHIP, kw, device, seed)


def flagship_pose_only(device="cuda", seed: int = 0, **overrides) -> PoseAlignedVGGT:
    """Trajectory-only serving: the camera head alone, no DPT decode; the
    chunk-and-align math is the pose-aligned model's."""
    kw = dict(enable_depth=False, enable_point=False)
    kw.update(_merged(overrides))
    return _build(PoseAlignedVGGT, FLAGSHIP, kw, device, seed)
