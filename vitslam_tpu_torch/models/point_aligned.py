"""PointAlignedVGGT — the training-free baseline that chains chunks by a
robust Sim(3) between overlapping point maps (port of
vitslam_tpu/models/point_aligned.py).

The current chunk's first ``overlap`` point maps are aligned onto the
previous chunk's last ``overlap`` aligned point maps by IRLS-Umeyama
(confidence sqrt(c1 * c2), median threshold, Huber delta 0.1, 20 fixed
iterations, batched over B); the Sim(3) then moves the chunk's point maps
and w2c poses, and scales its depth.

``seq_group``: the sequence-parallel encode (``parallel/seq.py``), passed to
VGGTCore; the alignment stage runs on the gathered outputs.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..geometry import (
    apply_sim3_on_point_maps,
    apply_sim3_on_w2c,
    extri_intri_to_pose_encoding,
    irls_sim3_umeyama_batched,
    pose_encoding_to_extri_intri,
)
from ..slam.state import PointAlignContext
from .vggt_core import VGGTCore


class PointAlignedVGGT(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_embed_depth: int = 24,
                 intermediate_layers: tuple = (4, 11, 17, 23),
                 enable_camera: bool = True, enable_depth: bool = False,
                 enable_point: bool = True, enable_track: bool = False,
                 dpt_frames_chunk: int = 0, global_merge_pool: int = 0,
                 global_merge_stride: int = 1, dtype=torch.bfloat16, device=None,
                 mlp_tail: str = "off", seq_group=None, remat: bool = False,
                 int8: bool = False):
        super().__init__()
        self.seq_group = seq_group
        if not enable_point:
            raise ValueError("the point-aligned variant needs the point head")
        self.enable_camera, self.enable_depth = enable_camera, enable_depth
        self.core = VGGTCore(
            img_size=img_size, patch_size=patch_size, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, patch_embed_depth=patch_embed_depth,
            intermediate_layers=tuple(intermediate_layers),
            enable_camera=enable_camera, enable_depth=enable_depth,
            enable_point=True, enable_track=enable_track,
            dpt_frames_chunk=dpt_frames_chunk, global_merge_pool=global_merge_pool,
            global_merge_stride=global_merge_stride, dtype=dtype, device=device,
            mlp_tail=mlp_tail, seq_group=seq_group, remat=remat, int8=int8)

    def embed_frames(self, images: torch.Tensor) -> torch.Tensor:
        """Per-frame patch embedding (the pipeline's unique-frame dedup)."""
        return self.core.embed_frames(images)

    def encode_chunks(self, images: torch.Tensor, patch_tokens=None) -> dict:
        """The chunk-independent stage: backbone + decoder heads."""
        taps, psi = self.core.encode(images, patch_tokens)
        raw: dict = {}
        raw["points_raw"], raw["points_conf"] = self.core.decode_point(taps, images, psi)
        if self.enable_camera:
            raw["pose_enc_raw"] = self.core.decode_camera(taps)[-1]
        if self.enable_depth:
            raw["depth_raw"], raw["depth_conf"] = self.core.decode_depth(taps, images, psi)
        return raw

    def forward(self, images: torch.Tensor, num_overlap: int,
                context: Optional[PointAlignContext] = None,
                gt_poses: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """One chunk step: images (B, S, 3, H, W) in [0, 1]. ``gt_poses``,
        ``train`` and ``generator`` are accepted and unused, as in the
        reference. Returns (outputs, PointAlignContext)."""
        raw = self.encode_chunks(images)
        return self.align_chunk(raw, images.shape, num_overlap, context, gt_poses)

    def align_chunk(self, raw: dict, images_shape, num_overlap: int,
                    context: Optional[PointAlignContext] = None,
                    gt_poses: Optional[torch.Tensor] = None):
        """The sequential stage: IRLS Sim(3) onto the previous chunk's
        overlap, applied to points, poses and depth."""
        B, S, _, H, W = images_shape
        pts3d, pts_conf = raw["points_raw"], raw["points_conf"]
        transform = torch.eye(4, device=pts3d.device).repeat(B, 1, 1)
        if context is not None:
            R, t, scales = irls_sim3_umeyama_batched(
                pts3d[:, :num_overlap], context.prev_points,
                pts_conf[:, :num_overlap], context.prev_conf)
            transform[:, :3, :3] = R
            transform[:, :3, 3] = t
        else:
            scales = torch.ones(B, device=pts3d.device)

        pts3d_final = apply_sim3_on_point_maps(pts3d, transform, scales)
        outputs: dict = {"world_points": pts3d_final, "world_points_conf": pts_conf}
        if self.enable_camera:
            extr, intr = pose_encoding_to_extri_intri(raw["pose_enc_raw"], (H, W))
            aligned_extr = apply_sim3_on_w2c(extr, transform, scales)
            outputs["pose_enc"] = extri_intri_to_pose_encoding(
                aligned_extr[..., :3, :4], intr, (H, W))
        if self.enable_depth:
            outputs["depth"] = raw["depth_raw"] * scales[:, None, None, None, None]
            outputs["depth_conf"] = raw["depth_conf"]
        new_state = PointAlignContext(prev_points=pts3d_final[:, -num_overlap:],
                                      prev_conf=pts_conf[:, -num_overlap:])
        return outputs, new_state
