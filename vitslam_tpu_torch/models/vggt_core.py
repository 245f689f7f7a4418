"""VGGTCore — the backbone + decoder-head stack shared by the aligned model
variants (port of vitslam_tpu/models/vggt_core.py): an Aggregator plus
optional CameraHead / DPTHead(depth) / DPTHead(point) / TrackHead (every
reference config disables the last; ``decode_track`` runs it).
``mlp_tail`` picks the backbone blocks' fused tail sites
(``nn.layers.Block``) and ``int8`` switches the backbone's projections to
int8 (``ops.quant``); the heads take neither.

``seq_group`` (sequence parallelism, ``parallel/seq.py``): the encode runs
on this rank's slice of the chunk's frames. The backbone gathers keys and
values in its global blocks; the camera head, which attends across frames,
gathers the S camera tokens, runs replicated and returns the local frames,
so every output of the encode is the local frame slice."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import all_gather
from .aggregator import Aggregator
from .camera_head import CameraHead
from .dpt_head import DPTHead
from .track_head import TrackHead


class VGGTCore(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_embed_depth: int = 24, patch_embed_heads: int = 16,
                 intermediate_layers: Sequence[int] = (4, 11, 17, 23),
                 enable_camera: bool = True, enable_depth: bool = True,
                 enable_point: bool = True, enable_track: bool = False,
                 dpt_features: int = 256,
                 dpt_out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 dpt_frames_chunk: int = 0, camera_trunk_depth: int = 4,
                 global_merge_pool: int = 0, global_merge_stride: int = 1,
                 dtype=torch.bfloat16, device=None, mlp_tail: str = "off",
                 seq_group=None, remat: bool = False, int8: bool = False):
        super().__init__()
        self.dpt_frames_chunk = dpt_frames_chunk
        self.seq_group = seq_group
        self.aggregator = Aggregator(
            img_size=img_size, patch_size=patch_size, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, patch_embed_depth=patch_embed_depth,
            patch_embed_heads=patch_embed_heads,
            intermediate_layers=intermediate_layers, merge_pool=global_merge_pool,
            merge_stride=global_merge_stride, dtype=dtype, device=device,
            mlp_tail=mlp_tail, seq_group=seq_group, remat=remat, int8=int8)
        dim_in = 2 * embed_dim
        dpt = dict(dim_in=dim_in, features=dpt_features,
                   out_channels=tuple(dpt_out_channels), patch_size=patch_size,
                   dtype=dtype, device=device)
        self.camera_head = (CameraHead(dim_in=dim_in, trunk_depth=camera_trunk_depth,
                                       num_heads=num_heads, dtype=dtype, device=device)
                            if enable_camera else None)
        self.depth_head = (DPTHead(output_dim=2, activation="exp",
                                   conf_activation="expp1", **dpt)
                           if enable_depth else None)
        self.point_head = (DPTHead(output_dim=4, activation="inv_log",
                                   conf_activation="expp1", **dpt)
                           if enable_point else None)
        self.track_head = (TrackHead(dim_in=dim_in, patch_size=patch_size, dtype=dtype,
                                     device=device)
                           if enable_track else None)

    def encode(self, images, patch_tokens=None):
        """images (B, S, 3, H, W) -> (taps list, patch_start_idx)."""
        return self.aggregator(images, patch_tokens)

    def embed_frames(self, images):
        """Per-frame patch embedding only: (B, S, 3, H, W) -> (B, S, P, C)."""
        return self.aggregator.embed(images)

    def decode_camera(self, taps) -> list[torch.Tensor]:
        """-> list over refinement iterations of (B, S, 9) fp32 encodings."""
        camera_tokens = taps[-1][:, :, 0, :]
        if self.seq_group is None:
            return self.camera_head(camera_tokens)
        s = camera_tokens.shape[1]
        i = dist.get_rank(self.seq_group)
        encs = self.camera_head(all_gather(camera_tokens, self.seq_group, dim=1))
        return [e[:, i * s:(i + 1) * s] for e in encs]

    def decode_depth(self, taps, images, patch_start_idx):
        return self._decode_dpt(self.depth_head, taps, images, patch_start_idx)

    def decode_point(self, taps, images, patch_start_idx):
        return self._decode_dpt(self.point_head, taps, images, patch_start_idx)

    def _decode_dpt(self, head, taps, images, patch_start_idx):
        """Run a DPT head over at most ``dpt_frames_chunk`` frames at a time,
        so each group's full-resolution intermediates die before the next."""
        S = images.shape[1]
        fc = self.dpt_frames_chunk
        if not fc or S <= fc:
            return head(taps, images, patch_start_idx)
        fc = max(d for d in range(1, fc + 1) if S % d == 0)
        outs = [head([t[:, s0:s0 + fc] for t in taps], images[:, s0:s0 + fc],
                     patch_start_idx) for s0 in range(0, S, fc)]
        return (torch.cat([o[0] for o in outs], dim=1),
                torch.cat([o[1] for o in outs], dim=1))

    def decode_track(self, taps, images, patch_start_idx, query_points):
        """-> tracks (B, S, N, 2) pixels, visibility, confidence (B, S, N)
        of query_points (B, N, 2), pixels of frame 0."""
        return self.track_head(taps, images, patch_start_idx, query_points)

    def forward(self, images):
        """Plain single-chunk forward: the raw predictions dict."""
        taps, psi = self.encode(images)
        out = {}
        if self.camera_head is not None:
            out["pose_enc_list"] = self.decode_camera(taps)
        if self.depth_head is not None:
            out["depth"], out["depth_conf"] = self.decode_depth(taps, images, psi)
        if self.point_head is not None:
            out["world_points"], out["world_points_conf"] = self.decode_point(
                taps, images, psi)
        return out
