"""FeatureAlignedVGGT — the flagship model: VGGT backbone + AlignmentHead
fusing chunks through feature-level Sim(3)/SE(3) regression (port of
vitslam_tpu/models/feature_aligned.py).

The chunk step is split as in the reference: ``encode_chunks`` is the
chunk-independent (batchable) backbone + decoder-head stage, and
``align_chunk`` is the sequential stage (AlignmentHead + fp32 pose and scale
composition against the previous chunk's context).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..geometry import (
    average_pose_encodings,
    closed_form_inverse_se3,
    extri_intri_to_pose_encoding,
    extri_to_pose_encoding,
    pad_to_4x4,
    pose_encoding_to_extri,
    pose_encoding_to_extri_intri,
)
from ..geometry.se3 import scale_translation
from ..slam.state import FeatureAlignContext
from .alignment_head import AlignmentHead
from .vggt_core import VGGTCore


class FeatureAlignedVGGT(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_embed_depth: int = 24,
                 intermediate_layers: tuple = (4, 11, 17, 23),
                 enable_camera: bool = True, enable_depth: bool = True,
                 enable_point: bool = True, enable_track: bool = False,
                 dpt_frames_chunk: int = 0, num_memory_tokens: int = 8,
                 temporal_attention: bool = True, align_embed_dim: int = 1024,
                 align_dec_dim: int = 512, global_merge_pool: int = 0,
                 global_merge_stride: int = 1, dtype=torch.bfloat16, device=None,
                 mlp_tail: str = "off", remat: bool = False, int8: bool = False):
        super().__init__()
        self.enable_camera, self.enable_depth = enable_camera, enable_depth
        self.enable_point = enable_point
        self.num_memory_tokens = num_memory_tokens
        self.core = VGGTCore(
            img_size=img_size, patch_size=patch_size, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, patch_embed_depth=patch_embed_depth,
            intermediate_layers=tuple(intermediate_layers),
            enable_camera=enable_camera, enable_depth=enable_depth,
            enable_point=enable_point, enable_track=enable_track,
            dpt_frames_chunk=dpt_frames_chunk, global_merge_pool=global_merge_pool,
            global_merge_stride=global_merge_stride, dtype=dtype, device=device,
            mlp_tail=mlp_tail, remat=remat, int8=int8)
        self.alignment_head = AlignmentHead(
            patch_size=patch_size, in_dim=2 * embed_dim, embed_dim=align_embed_dim,
            dec_dim=align_dec_dim, num_memory_tokens=num_memory_tokens,
            temporal_attention=temporal_attention, dtype=dtype, device=device)

    @property
    def enable_memory(self) -> bool:
        return self.num_memory_tokens > 0

    def embed_frames(self, images: torch.Tensor) -> torch.Tensor:
        """Per-frame patch embedding (frame-independent; the pipeline's
        unique-frame dedup)."""
        return self.core.embed_frames(images)

    def encode_chunks(self, images: torch.Tensor, patch_tokens=None) -> dict:
        """The chunk-independent stage: backbone + all decoder heads, raw
        per-chunk outputs plus the last tap for the alignment stage. Chunks
        stacked along B are independent."""
        taps, psi = self.core.encode(images, patch_tokens)
        raw: dict = {"last_tap": taps[-1]}
        if self.enable_camera:
            raw["pose_enc_raw"] = self.core.decode_camera(taps)[-1]
        if self.enable_depth:
            raw["depth_raw"], raw["depth_conf"] = self.core.decode_depth(taps, images, psi)
        if self.enable_point:
            raw["points_raw"], raw["points_conf"] = self.core.decode_point(taps, images, psi)
        return raw

    def forward(self, images: torch.Tensor, num_overlap: int,
                context: Optional[FeatureAlignContext] = None,
                gt_poses: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """One chunk step: images (B, S, 3, H, W) in [0, 1]. Returns (outputs,
        FeatureAlignContext) with pose_enc (B,S,9), depth (B,S,H,W,1),
        depth_conf (B,S,H,W), world_points (B,S,H,W,3), world_points_conf,
        chunk_sim3_enc (B,1,8), frame_se3_enc (B,S-1,7), memory_tokens.
        train: the AlignmentHead's frame dropout, drawn from ``generator``."""
        raw = self.encode_chunks(images)
        return self.align_chunk(raw, images.shape, num_overlap, context, gt_poses, train,
                                generator)

    def align_chunk(self, raw: dict, images_shape, num_overlap: int,
                    context: Optional[FeatureAlignContext] = None,
                    gt_poses: Optional[torch.Tensor] = None, train: bool = False,
                    generator: Optional[torch.Generator] = None, batch_rows=None):
        """The sequential stage: AlignmentHead + fp32 pose/scale composition
        over the raw outputs of :meth:`encode_chunks`. ``batch_rows``: the
        rows of a data-parallel global batch these are (``AlignmentHead``)."""
        B, S, _, H, W = images_shape
        # a remainder chunk can be narrower than the configured overlap
        overlap = num_overlap if S > num_overlap else S - 1
        ctx_tokens = context.overlap_tokens if context is not None else None
        ctx_memory = (context.memory_tokens
                      if (context is not None and self.enable_memory) else None)
        chunk_sim3_enc, frame_se3_enc, memory_tokens, overlap_tokens = self.alignment_head(
            raw["last_tap"], (H, W), overlap, ctx_tokens, ctx_memory, train, generator,
            batch_rows)

        chunk_se3 = pose_encoding_to_extri(chunk_sim3_enc)    # (B,1,4,4)
        chunk_scale = chunk_sim3_enc[..., -1]                 # (B,1)
        frame_se3 = pose_encoding_to_extri(frame_se3_enc)     # (B,S-1,4,4)
        per_frame_se3 = torch.cat([chunk_se3, frame_se3 @ chunk_se3], dim=1)

        outputs: dict = {"chunk_sim3_enc": chunk_sim3_enc, "frame_se3_enc": frame_se3_enc}
        if self.enable_memory:
            outputs["memory_tokens"] = memory_tokens
        point_ident = None
        if self.enable_camera:
            extr, intr = pose_encoding_to_extri_intri(raw["pose_enc_raw"], (H, W))
            extr = pad_to_4x4(extr)
            ident_align = closed_form_inverse_se3(extr[:, 0])
            point_ident = extr[:, 0].detach()
            extr = extr @ ident_align[:, None]
            extr = _scale_t(extr, chunk_scale)
            if context is not None:
                if gt_poses is not None:
                    mean_transform = pad_to_4x4(gt_poses.float())[:, :1]
                else:
                    prev = pose_encoding_to_extri(context.prev_pose_enc[:, -overlap:])
                    cam_t = closed_form_inverse_se3(extr[:, :overlap]) @ prev
                    if overlap > 1:
                        mean_transform = pose_encoding_to_extri(
                            average_pose_encodings(extri_to_pose_encoding(cam_t)))
                    else:
                        mean_transform = cam_t
            else:
                mean_transform = torch.eye(4, device=extr.device).expand(B, 1, 4, 4)
            per_frame_se3 = per_frame_se3 @ mean_transform
            aligned_extr = extr @ per_frame_se3
            outputs["pose_enc"] = extri_intri_to_pose_encoding(
                aligned_extr[..., :3, :4], intr, (H, W))

        if self.enable_depth:
            outputs["depth"] = raw["depth_raw"] * chunk_scale[:, :, None, None, None]
            outputs["depth_conf"] = raw["depth_conf"]

        if self.enable_point:
            pts3d = raw["points_raw"]
            if self.enable_camera:
                if context is not None:
                    point_t = closed_form_inverse_se3(per_frame_se3[:, 0]) @ point_ident
                else:
                    point_t = point_ident
                pts3d = pts3d * chunk_scale[:, :, None, None, None]
                pts3d = (torch.einsum("bij,bshwj->bshwi", point_t[:, :3, :3], pts3d)
                         + point_t[:, None, None, None, :3, 3])
            outputs["world_points"] = pts3d
            outputs["world_points_conf"] = raw["points_conf"]

        new_state = FeatureAlignContext(
            overlap_tokens=overlap_tokens,
            memory_tokens=memory_tokens if self.enable_memory else None,
            prev_pose_enc=(outputs["pose_enc"][:, -num_overlap:] if self.enable_camera
                           else torch.zeros((B, num_overlap, 9), device=chunk_scale.device)),
        )
        return outputs, new_state


def _scale_t(extr: torch.Tensor, chunk_scale: torch.Tensor) -> torch.Tensor:
    """extr (B, S, 4, 4) with its translations multiplied by chunk_scale (B, 1)."""
    return scale_translation(extr, chunk_scale)
