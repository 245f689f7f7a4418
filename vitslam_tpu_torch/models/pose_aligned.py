"""PoseAlignedVGGT — the training-free baseline that chains chunks by
averaging the relative poses over the overlap (port of
vitslam_tpu/models/pose_aligned.py).

The camera head's first pose is made the identity; with GT poses the
chunk's translations take a least-squares scale against the GT's
first-frame-centred positions; the inter-chunk SE(3) is the mean over the
overlap of inv(current) @ previous (Markley quaternion averaging for more
than one overlap frame); point maps follow the first frame's pose.

``seq_group``: the sequence-parallel encode (``parallel/seq.py``), passed to
VGGTCore; the alignment stage runs on the gathered outputs.
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
from ..slam.state import PoseAlignContext
from .feature_aligned import _scale_t
from .vggt_core import VGGTCore


def _batched_scale_lse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|sum(x*y) / sum(x^2)| per batch element over all trailing dims."""
    dims = tuple(range(1, x.ndim))
    return ((x * y).sum(dim=dims) / (x * x).sum(dim=dims).clamp_min(1e-12)).abs()


class PoseAlignedVGGT(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_embed_depth: int = 24,
                 intermediate_layers: tuple = (4, 11, 17, 23),
                 enable_camera: bool = True, enable_depth: bool = True,
                 enable_point: bool = False, enable_track: bool = False,
                 dpt_frames_chunk: int = 0, global_merge_pool: int = 0,
                 global_merge_stride: int = 1, dtype=torch.bfloat16, device=None,
                 mlp_tail: str = "off", seq_group=None, remat: bool = False,
                 int8: bool = False):
        super().__init__()
        self.seq_group = seq_group
        if not enable_camera:
            raise ValueError("the pose-aligned variant needs the camera head")
        self.enable_depth, self.enable_point = enable_depth, enable_point
        self.core = VGGTCore(
            img_size=img_size, patch_size=patch_size, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, patch_embed_depth=patch_embed_depth,
            intermediate_layers=tuple(intermediate_layers),
            enable_camera=True, enable_depth=enable_depth,
            enable_point=enable_point, enable_track=enable_track,
            dpt_frames_chunk=dpt_frames_chunk, global_merge_pool=global_merge_pool,
            global_merge_stride=global_merge_stride, dtype=dtype, device=device,
            mlp_tail=mlp_tail, seq_group=seq_group, remat=remat, int8=int8)

    def embed_frames(self, images: torch.Tensor) -> torch.Tensor:
        """Per-frame patch embedding (the pipeline's unique-frame dedup)."""
        return self.core.embed_frames(images)

    def encode_chunks(self, images: torch.Tensor, patch_tokens=None) -> dict:
        """The chunk-independent stage: backbone + decoder heads."""
        taps, psi = self.core.encode(images, patch_tokens)
        raw: dict = {"pose_enc_raw": self.core.decode_camera(taps)[-1]}
        if self.enable_depth:
            raw["depth_raw"], raw["depth_conf"] = self.core.decode_depth(taps, images, psi)
        if self.enable_point:
            raw["points_raw"], raw["points_conf"] = self.core.decode_point(taps, images, psi)
        return raw

    def forward(self, images: torch.Tensor, num_overlap: int,
                context: Optional[PoseAlignContext] = None,
                gt_poses: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """One chunk step: images (B, S, 3, H, W) in [0, 1]; gt_poses
        (B, S, 3|4, 4) chunk GT w2c for GT-scale alignment and chunk_gt
        mode, or None; ``train`` and ``generator`` are accepted and unused,
        as in the reference. Returns (outputs, PoseAlignContext)."""
        raw = self.encode_chunks(images)
        return self.align_chunk(raw, images.shape, num_overlap, context, gt_poses)

    def align_chunk(self, raw: dict, images_shape, num_overlap: int,
                    context: Optional[PoseAlignContext] = None,
                    gt_poses: Optional[torch.Tensor] = None):
        """The sequential stage: pose averaging over the overlap."""
        B, S, _, H, W = images_shape
        extr, intr = pose_encoding_to_extri_intri(raw["pose_enc_raw"], (H, W))
        extr = pad_to_4x4(extr)
        ident_align = closed_form_inverse_se3(extr[:, 0])
        point_ident = extr[:, 0].detach()
        extr = extr @ ident_align[:, None]

        scales = torch.ones(B, device=extr.device)
        if gt_poses is not None and S > 1:
            gt = pad_to_4x4(gt_poses.float())
            gt_centered = gt @ closed_form_inverse_se3(gt[:, 0])[:, None]
            scales = _batched_scale_lse(extr[..., :3, 3], gt_centered[..., :3, 3])
            extr = _scale_t(extr, scales[:, None])

        if context is None:
            mean_transform = torch.eye(4, device=extr.device).expand(B, 1, 4, 4)
        elif gt_poses is not None:
            mean_transform = pad_to_4x4(gt_poses.float())[:, :1]
        else:
            prev = pose_encoding_to_extri(context.prev_pose_enc[:, -num_overlap:])
            cam_t = closed_form_inverse_se3(extr[:, :num_overlap]) @ prev
            if num_overlap > 1:
                mean_transform = pose_encoding_to_extri(
                    average_pose_encodings(extri_to_pose_encoding(cam_t)))
            else:
                mean_transform = cam_t

        aligned_extr = extr @ mean_transform
        outputs: dict = {"pose_enc": extri_intri_to_pose_encoding(
            aligned_extr[..., :3, :4], intr, (H, W))}
        if self.enable_depth:
            outputs["depth"] = raw["depth_raw"] * scales[:, None, None, None, None]
            outputs["depth_conf"] = raw["depth_conf"]
        if self.enable_point:
            pts3d = raw["points_raw"] * scales[:, None, None, None, None]
            if context is not None:
                point_t = closed_form_inverse_se3(mean_transform[:, 0]) @ point_ident
            else:
                point_t = point_ident
            outputs["world_points"] = (
                torch.einsum("bij,bshwj->bshwi", point_t[:, :3, :3], pts3d)
                + point_t[:, None, None, None, :3, 3])
            outputs["world_points_conf"] = raw["points_conf"]
        return outputs, PoseAlignContext(prev_pose_enc=outputs["pose_enc"][:, -num_overlap:])
