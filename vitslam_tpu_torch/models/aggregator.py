"""Aggregator — the VGGT-style backbone (port of
vitslam_tpu/models/aggregator.py).

* DINOv2 ViT patch embedding (patch 14, cls + register tokens, its own
  transformer depth), giving per-frame patch tokens;
* 1 camera token + ``num_register_tokens`` register tokens per frame, with
  separate learned variants for the first frame and the rest;
* ``depth`` pairs of frame attention (within a frame, batched (B*S, T, C))
  and global attention (over the chunk's S*T tokens, batched (B, S*T, C)),
  both with 2-D RoPE (base 100), special tokens at grid position (0, 0);
* each pair's output is concat(frame_out, global_out) -> (B, S, T, 2C); only
  the tapped layers are kept;
* ``mlp_tail`` ("off" | "mlp" | "proj" | "both"): the fused block tails
  (K5) of every patch-embed, frame and global block, as the reference's
  ``fused_tail=True`` blocks under ``VITSLAM_MLP_TAIL``;
* ``int8``: every patch-embed, frame and global block is built with
  ``quant=True`` (as the reference's), and this switches their projections
  to int8 (``nn.layers.set_int8``; the fused tails are then off);
* optional KV merge of the global attention (``merge_pool`` p > 1 and
  ``merge_stride`` s): anchor frames (every s-th, frame 0 included) give all
  their tokens as keys/values, every other frame its special tokens plus its
  patch tokens average-pooled p x p; queries stay at full resolution;
* ``seq_group`` (sequence parallelism, ``parallel/seq.py``): the S frames
  are split over the group, so this rank holds frames
  [rank * S, (rank + 1) * S) of the chunk; the global blocks gather their
  keys and values over it, the first-frame token variant goes to global
  frame 0 only, and the KV merge is off.

The reference's ``lax.scan`` stacks are ``nn.ModuleList``s here.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Block, Conv2d, LayerNorm, _param, set_int8
from ..nn.rope import patch_grid_positions, rope_cache_2d
from ..ops.attention import remat
from ..ops.resize import bicubic_matrix, resize_matmul
from ..ops.transfer import to_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def expand_frame_tokens(param: torch.Tensor, B: int, S: int,
                        frame_offset: int = 0) -> torch.Tensor:
    """(2, K, C) learned tokens -> (B*S, K, C): frame 0 takes variant 0,
    every later frame variant 1. ``frame_offset`` is the global index of
    local frame 0 (nonzero only on a sequence-parallel rank past the first)."""
    idx = (torch.arange(S, device=param.device) + frame_offset).clamp(max=1)
    tokens = param[idx]  # (S, K, C)
    return tokens[None].expand((B,) + tokens.shape).reshape(B * S, *param.shape[1:])


class PatchEmbedViT(nn.Module):
    """DINOv2 patch embedding: conv projection, cls token + bicubically
    resized pos embedding, register tokens after the cls token (no pos
    embedding), transformer blocks over all tokens, final LayerNorm;
    returns the normed patch tokens only."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, init_values: float = 1.0,
                 num_register_tokens: int = 4, dtype=torch.bfloat16, device=None,
                 mlp_tail: str = "off", remat: bool = False):
        super().__init__()
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.num_register_tokens, self.dtype, self.remat = num_register_tokens, dtype, remat
        ng = img_size // patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size,
                           dtype=dtype, device=device)
        self.pos_embed = _param(1, 1 + ng * ng, embed_dim, device=device)
        self.cls_token = _param(1, 1, embed_dim, device=device)
        self.register_tokens = (_param(1, num_register_tokens, embed_dim, device=device)
                                if num_register_tokens else None)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qk_norm=False,
                  init_values=init_values, dtype=dtype, device=device, mlp_tail=mlp_tail,
                  quant=True)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, dtype, device=device)

    def init_params(self, g):
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=g)
        nn.init.normal_(self.cls_token, 0.0, 1e-6, generator=g)
        if self.register_tokens is not None:
            nn.init.normal_(self.register_tokens, 0.0, 1e-6, generator=g)

    def _patch_pos(self, gh: int, gw: int) -> torch.Tensor:
        """(1, gh*gw, C) pos embedding: the native ng x ng grid resized with
        jax.image.resize's antialiased bicubic, as two matmuls."""
        ng = self.img_size // self.patch_size
        patch_pos = self.pos_embed[:, 1:]
        if (gh, gw) == (ng, ng):
            return patch_pos
        grid = patch_pos.reshape(ng, ng, self.embed_dim).permute(2, 0, 1)  # (C, ng, ng)
        grid = resize_matmul(grid, bicubic_matrix(gh, ng), bicubic_matrix(gw, ng))
        return grid.permute(1, 2, 0).reshape(1, gh * gw, self.embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, 3, H, W) (normalised) -> (N, P, embed_dim)."""
        n = images.shape[0]
        x = self.proj(images)  # (n, C, gh, gw)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)  # (n, gh*gw, C)
        x = x + self._patch_pos(gh, gw).to(self.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(self.dtype).expand(n, 1, -1)
        parts = [cls]
        if self.register_tokens is not None:
            parts.append(self.register_tokens.to(self.dtype).expand(n, -1, -1))
        x = torch.cat(parts + [x], dim=1)
        for blk in self.blocks:
            x = remat(self.remat, blk, x)
        x = self.norm(x)
        return x[:, 1 + self.num_register_tokens:]


class AggregatorLayer(nn.Module):
    """One frame-attention + global-attention pair."""

    def __init__(self, dim, num_heads, mlp_ratio, qk_norm, init_values,
                 rope_base, dtype, device=None, mlp_tail: str = "off", seq_group=None,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        kw = dict(mlp_ratio=mlp_ratio, qk_norm=qk_norm, init_values=init_values,
                  rope="2d", rope_base=rope_base, dtype=dtype, device=device,
                  mlp_tail=mlp_tail, quant=True)
        self.frame_block = Block(dim, num_heads, **kw)
        self.global_block = Block(dim, num_heads, **kw, seq_group=seq_group)

    def forward(self, x, pos_frame, pos_global, B: int, S: int, merge=None):
        """x (B*S, T, C) -> (x', concat(frame_out, global_out) (B, S, T, 2C)).
        ``merge``: None, or (merged_kv, pos_kv) for the KV-merged global
        attention, merged_kv mapping the frame attention's output to the
        key/value token set whose RoPE cache is pos_kv."""
        T, C = x.shape[1:]
        x = remat(self.remat, self.frame_block, x, pos_frame)
        frame_out = x
        xg = x.reshape(B, S * T, C)
        if merge is None:
            xg = remat(self.remat, self.global_block, xg, pos_global)
        else:
            merged_kv, pos_kv = merge
            xg = remat(self.remat, self.global_block, xg, pos_global, kv=merged_kv(x),
                       pos_kv=pos_kv)
        x = xg.reshape(B * S, T, C)
        return x, torch.cat([frame_out, x], dim=-1).reshape(B, S, T, 2 * C)


def _pool_grid(x: torch.Tensor, pool: int) -> torch.Tensor:
    """(N, C, gh, gw) -> (N, C, ceil(gh/pool), ceil(gw/pool)): edge-replicated
    to a pool multiple, then pool x pool means."""
    gh, gw = x.shape[-2:]
    x = F.pad(x, (0, (-gw) % pool, 0, (-gh) % pool), mode="replicate")
    return F.avg_pool2d(x, pool, pool)


class Aggregator(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 4,
                 rope_base: float = 100.0, patch_embed_depth: int = 24,
                 patch_embed_heads: int = 16, qk_norm: bool = True,
                 init_values: float = 0.01, dtype=torch.bfloat16,
                 intermediate_layers: Sequence[int] = (4, 11, 17, 23),
                 merge_pool: int = 0, merge_stride: int = 1, device=None,
                 mlp_tail: str = "off", seq_group=None, remat: bool = False,
                 int8: bool = False):
        """remat: the patch embedding's and the layers' blocks are
        recomputed in the backward (``ops.attention.remat``) when gradients
        are on. int8: the blocks' projections run int8."""
        super().__init__()
        self.merge_pool, self.merge_stride = merge_pool, merge_stride
        self.seq_group = seq_group
        self.patch_size, self.embed_dim, self.num_heads = patch_size, embed_dim, num_heads
        self.num_register_tokens, self.rope_base = num_register_tokens, rope_base
        self.dtype, self.depth = dtype, depth
        self.intermediate_layers = tuple(intermediate_layers)
        self.patch_embed = PatchEmbedViT(
            img_size=img_size, patch_size=patch_size, embed_dim=embed_dim,
            depth=patch_embed_depth, num_heads=patch_embed_heads, dtype=dtype,
            device=device, mlp_tail=mlp_tail, remat=remat)
        self.camera_token = _param(2, 1, embed_dim, device=device)
        self.register_token = _param(2, num_register_tokens, embed_dim, device=device)
        self.layers = nn.ModuleList(
            AggregatorLayer(embed_dim, num_heads, mlp_ratio, qk_norm, init_values,
                            rope_base, dtype, device, mlp_tail, seq_group, remat)
            for _ in range(depth))
        set_int8(self, int8)

    def init_params(self, g):
        nn.init.normal_(self.camera_token, 0.0, 1e-6, generator=g)
        nn.init.normal_(self.register_token, 0.0, 1e-6, generator=g)

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    def _merge_frames(self, S: int):
        anchors = list(range(0, S, self.merge_stride))
        return anchors, [i for i in range(S) if i % self.merge_stride]

    def _merged_kv(self, x: torch.Tensor, B: int, S: int, gh: int, gw: int) -> torch.Tensor:
        """(B*S, T, C) frame-attention output -> (B, Nk, C) KV token set:
        the anchor frames' tokens, then per other frame its special tokens
        and its pooled patch tokens."""
        T, C = x.shape[1:]
        psi = self.patch_start_idx
        anchors, non = self._merge_frames(S)
        x_bs = x.reshape(B, S, T, C)
        anchor_tok = x_bs[:, anchors].reshape(B, len(anchors) * T, C)
        if not non:
            return anchor_tok
        xn = x_bs[:, non]
        patches = xn[:, :, psi:].reshape(B * len(non), gh, gw, C).permute(0, 3, 1, 2)
        pooled = _pool_grid(patches, self.merge_pool).flatten(2).transpose(1, 2)
        pooled = pooled.reshape(B, len(non), -1, C)
        non_tok = torch.cat([xn[:, :, :psi], pooled], dim=2).reshape(B, -1, C)
        return torch.cat([anchor_tok, non_tok], dim=1)

    def _merged_kv_rope(self, S: int, gh: int, gw: int, device):
        """RoPE cache (1, Nk, head_dim) of the merged KV set: anchor frames
        keep their grid positions; a pooled token sits at the mean position
        of its pooling window (pooled as its content is, so fractional, and
        built in float)."""
        anchors, non = self._merge_frames(S)
        psi = self.patch_start_idx
        frame_pos = patch_grid_positions(1, gh, gw, psi, device).float()  # (1, T, 2)
        grid = frame_pos[0, psi:].T.reshape(1, 2, gh, gw)
        pooled = _pool_grid(grid, self.merge_pool).flatten(2).transpose(1, 2)  # (1, P2, 2)
        non_pos = torch.cat([torch.zeros((1, psi, 2), device=device), pooled], dim=1)
        pos_kv = torch.cat([frame_pos.repeat(1, len(anchors), 1),
                            non_pos.repeat(1, len(non), 1)], dim=1)
        return rope_cache_2d(pos_kv, self.embed_dim // self.num_heads, self.rope_base)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, S, 3, H, W) in [0, 1] -> patch tokens (B, S, P, C)."""
        B, S, C, H, W = images.shape
        mean = to_device(IMAGENET_MEAN, images.device).reshape(1, 1, 3, 1, 1)
        std = to_device(IMAGENET_STD, images.device).reshape(1, 1, 3, 1, 1)
        images_n = (images.float() - mean) / std
        tok = self.patch_embed(images_n.reshape(B * S, C, H, W))
        return tok.reshape(B, S, tok.shape[1], self.embed_dim)

    def forward(self, images: torch.Tensor, patch_tokens=None):
        """images (B, S, 3, H, W) in [0, 1]; ``patch_tokens`` (B, S, P, C)
        from ``embed`` skips the patch embedding (the pipeline embeds each
        unique frame once). Returns (list of tapped (B, S, T, 2C) outputs,
        one per ``intermediate_layers`` entry, patch_start_idx)."""
        B, S, _, H, W = images.shape
        if patch_tokens is None:
            patch_tokens = self.embed(images)
        x = patch_tokens.reshape(B * S, patch_tokens.shape[2], self.embed_dim).to(self.dtype)
        gh, gw = H // self.patch_size, W // self.patch_size
        sp = self.seq_group is not None
        offset = dist.get_rank(self.seq_group) * S if sp else 0
        cam = expand_frame_tokens(self.camera_token, B, S, offset).to(self.dtype)
        reg = expand_frame_tokens(self.register_token, B, S, offset).to(self.dtype)
        x = torch.cat([cam, reg, x], dim=1)  # (B*S, T, C)
        T = x.shape[1]

        # RoPE caches, hoisted out of the layer loop and cast to the compute
        # dtype as the reference does (its caches are head-tiled; the values
        # are the same)
        head_dim = self.embed_dim // self.num_heads
        pos_frame = patch_grid_positions(B * S, gh, gw, self.patch_start_idx, x.device)
        pos_global = pos_frame.reshape(B, S * T, 2)
        cos_f, sin_f, nsplit = rope_cache_2d(pos_frame, head_dim, self.rope_base)
        cos_g, sin_g, _ = rope_cache_2d(pos_global, head_dim, self.rope_base)
        rope_f = (cos_f.to(self.dtype), sin_f.to(self.dtype), nsplit)
        rope_g = (cos_g.to(self.dtype), sin_g.to(self.dtype), nsplit)
        merge = None
        if self.merge_pool > 1 and not sp and S > self.merge_stride:
            cos_kv, sin_kv, _ = self._merged_kv_rope(S, gh, gw, x.device)
            merge = (lambda y: self._merged_kv(y, B, S, gh, gw),
                     (cos_kv.to(self.dtype), sin_kv.to(self.dtype), nsplit))

        wanted = set(self.intermediate_layers)
        taps = {}
        for i, layer in enumerate(self.layers):
            x, concat = layer(x, rope_f, rope_g, B, S, merge)
            if i in wanted:
                taps[i] = concat
        return [taps[i] for i in self.intermediate_layers], self.patch_start_idx
