"""TrackHead — CoTracker-style point tracking with the VGGT-1B module tree
(port of vitslam_tpu/models/track_head.py).

A DPT ``feature_extractor`` in feature-only mode gives channels-last feature
maps at 1/``stride`` of the image, in the model's dtype; the ``tracker``
(BaseTrackerPredictor) runs in fp32: a LayerNormed correlation pyramid of
``corr_levels`` 2x2-average-pooled levels sampled in a (2r+1)^2 window
around each track, the correlation MLP, an EfficientUpdateFormer with
factored time / space (+ virtual track) attention, and the feature,
visibility and confidence updates, ``iters`` times. Module and parameter
names follow the reference's (``time_blocks.<i>`` for its
``time_blocks_<i>``, ``ffeat_updater.0`` for ``ffeat_updater_0``,
``updateformer.virual_tracks`` — cotracker's typo, kept: the checkpoint key
is the contract; ``io.from_jax.port_name`` maps them).

LayerNorms and the GroupNorm(1) over (M, C) rows (a LayerNorm over C) use
eps 1e-6, the gelus are exact-erf, and the attention divides its fp32 logits
by sqrt(head dim), as the reference does.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..nn.layers import Dense, LayerNorm, Mlp, _param
from .dpt_head import DPTHead


def bilinear_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (N, H, W, C) features at (N, M, 2) float (x, y) pixel coords,
    with the reference's gather rules: coordinates are clipped to
    [0, size - 1.001], and a flat index y * W + x below 0 wraps numpy-style
    (index -1 reads the last pixel) while one still out of range reads NaN.
    On a level one pixel tall (or wide) the clip gives -0.001, so y0 (x0)
    is -1 and the index wraps; an empty level reads NaN everywhere."""
    N, H, W, C = feat.shape
    if H * W == 0:
        return feat.new_full((N, coords.shape[1], C), float("nan"))
    x = coords[..., 0].clamp(0.0, W - 1.001)
    y = coords[..., 1].clamp(0.0, H - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = (x0 + 1).clamp(0, W - 1), (y0 + 1).clamp(0, H - 1)
    wx, wy = (x - x0f)[..., None], (y - y0f)[..., None]
    flat = feat.reshape(N, H * W, C)
    rows = torch.arange(N, device=feat.device)[:, None]

    def gather(yy, xx):
        idx = yy * W + xx
        idx = torch.where(idx < 0, idx + H * W, idx)
        bad = (idx < 0) | (idx >= H * W)
        out = flat[rows, idx.clamp(0, H * W - 1)]
        return out.masked_fill(bad[..., None], float("nan"))

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def get_2d_embedding(xy: torch.Tensor, dim: int) -> torch.Tensor:
    """The reference's 2-D sin/cos flow embedding: (..., 2) -> (..., 2*dim),
    ``dim/2`` frequencies 2^k per coordinate, [sin x, cos x, sin y, cos y]."""
    freqs = 2.0 ** torch.arange(dim // 2, dtype=torch.float32, device=xy.device)
    angx = xy[..., 0:1] * freqs
    angy = xy[..., 1:2] * freqs
    return torch.cat([torch.sin(angx), torch.cos(angx), torch.sin(angy), torch.cos(angy)],
                     dim=-1)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling with stride 2 of (N, H, W, C), odd edges dropped
    (flax's VALID avg_pool), summed in the window's row-major order."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    return (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) / 4


class _TrackAttention(nn.Module):
    """cotracker Attention (to_q / to_kv / to_out); no context gives
    self-attention. fp32, logits divided by sqrt(head dim)."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.to_q = Dense(dim, dim, device=device)
        self.to_kv = Dense(dim, 2 * dim, device=device)
        self.to_out = Dense(dim, dim, device=device)

    def forward(self, x, context=None):
        context = x if context is None else context
        B, N, _ = x.shape
        h = self.num_heads
        dh = self.dim // h
        kv = self.to_kv(context)
        split = lambda t: t.reshape(B, t.shape[1], h, dh).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.to_q(x)), split(kv[..., :self.dim]), split(kv[..., self.dim:])
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
        return self.to_out((p @ v).transpose(1, 2).reshape(B, N, self.dim))


class _AttnBlock(nn.Module):
    """Pre-norm self-attention + MLP."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.norm1 = LayerNorm(hidden, device=device)
        self.attn = _TrackAttention(hidden, num_heads, device)
        self.norm2 = LayerNorm(hidden, device=device)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), hidden, device=device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _CrossAttnBlock(nn.Module):
    """Pre-norm cross-attention (norm1 on x, norm_context on the context)
    + MLP."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.norm1 = LayerNorm(hidden, device=device)
        self.norm_context = LayerNorm(hidden, device=device)
        self.cross_attn = _TrackAttention(hidden, num_heads, device)
        self.norm2 = LayerNorm(hidden, device=device)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), hidden, device=device)

    def forward(self, x, context):
        x = x + self.cross_attn(self.norm1(x), context=self.norm_context(context))
        return x + self.mlp(self.norm2(x))


class EfficientUpdateFormer(nn.Module):
    """Factored time / space transformer over (B, N, S, C) track tokens with
    learned virtual tracks (cotracker-2's, ``tracker.updateformer`` in the
    VGGT-1B checkpoint). A space stage (point -> virtual cross-attention,
    virtual self-attention, virtual -> point cross-attention) follows every
    ``time_depth // space_depth``-th time block, at most ``space_depth``."""

    def __init__(self, input_dim: int, hidden_size: int, output_dim: int,
                 time_depth: int = 6, space_depth: int = 6, num_heads: int = 8,
                 num_virtual_tracks: int = 64, add_space_attn: bool = True, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.input_transform = Dense(input_dim, hidden_size, device=device)
        self.virual_tracks = (_param(1, num_virtual_tracks, 1, hidden_size, device=device)
                              if add_space_attn else None)
        self.every = max(1, time_depth // max(space_depth, 1))
        n_space = min(space_depth, len(range(0, time_depth, self.every))) if add_space_attn else 0
        blocks = lambda n, cls: nn.ModuleList(  # noqa: E731
            cls(hidden_size, num_heads, device=device) for _ in range(n))
        self.time_blocks = blocks(time_depth, _AttnBlock)
        self.space_point2virtual_blocks = blocks(n_space, _CrossAttnBlock)
        self.space_virtual_blocks = blocks(n_space, _AttnBlock)
        self.space_virtual2point_blocks = blocks(n_space, _CrossAttnBlock)
        self.flow_head = Dense(hidden_size, output_dim, device=device)

    def init_params(self, g):
        if self.virual_tracks is not None:
            nn.init.normal_(self.virual_tracks, 0.0, 1.0, generator=g)
        self.flow_head.weight.zero_()

    def forward(self, x):
        B, N, S, _ = x.shape
        hid = self.hidden_size
        tokens = self.input_transform(x)
        if self.virual_tracks is not None:
            virtual = self.virual_tracks.expand(B, -1, S, hid)
            tokens = torch.cat([tokens, virtual], dim=1)
        n_tot = tokens.shape[1]
        j = 0
        for i, block in enumerate(self.time_blocks):
            tokens = block(tokens.reshape(B * n_tot, S, hid)).reshape(B, n_tot, S, hid)
            if j < len(self.space_virtual_blocks) and i % self.every == 0:
                s = tokens.transpose(1, 2).reshape(B * S, n_tot, hid)
                pts, virt = s[:, :N], s[:, N:]
                virt = self.space_point2virtual_blocks[j](virt, pts)
                virt = self.space_virtual_blocks[j](virt)
                pts = self.space_virtual2point_blocks[j](pts, virt)
                s = torch.cat([pts, virt], dim=1)
                tokens = s.reshape(B, S, n_tot, hid).transpose(1, 2)
                j += 1
        return self.flow_head(tokens[:, :N])


class BaseTrackerPredictor(nn.Module):
    """Iterative CoTracker predictor over 1/stride feature maps
    (``track_head.tracker`` in the VGGT-1B checkpoint), fp32."""

    def __init__(self, latent_dim: int = 128, stride: int = 2, corr_levels: int = 7,
                 corr_radius: int = 4, hidden_size: int = 384, updater_depth: int = 6,
                 iters: int = 4, num_heads: int = 8, max_scale: float = 518.0, device=None):
        super().__init__()
        self.latent_dim, self.stride, self.corr_levels = latent_dim, stride, corr_levels
        self.corr_radius, self.iters, self.max_scale = corr_radius, iters, max_scale
        K = (2 * corr_radius + 1) ** 2
        femb = latent_dim // 2
        tf_dim = 256 + (2 * femb + 4) + latent_dim
        self.pad = (-tf_dim) % num_heads
        tf_dim += self.pad
        self.fmap_norm = LayerNorm(latent_dim, device=device)
        self.corr_mlp = Mlp(corr_levels * K, 384, 256, device=device)
        self.query_ref_token = _param(1, 2, tf_dim, device=device)
        self.updateformer = EfficientUpdateFormer(
            tf_dim, hidden_size, latent_dim + 2, time_depth=updater_depth,
            space_depth=updater_depth, num_heads=num_heads, device=device)
        # the reference's GroupNorm(num_groups=1) on (M, C) rows
        self.ffeat_norm = LayerNorm(latent_dim, device=device)
        self.ffeat_updater = nn.Sequential(Dense(latent_dim, latent_dim, device=device),
                                           nn.GELU())
        self.vis_predictor = nn.Sequential(Dense(latent_dim, 1, device=device))
        self.conf_predictor = nn.Sequential(Dense(latent_dim, 1, device=device))

    def init_params(self, g):
        nn.init.normal_(self.query_ref_token, 0.0, 1.0, generator=g)

    def _window_offsets(self, device) -> torch.Tensor:
        """(K, 2) (x, y) offsets of the (2r+1)^2 window, x fastest."""
        r = torch.arange(-self.corr_radius, self.corr_radius + 1, dtype=torch.float32,
                         device=device)
        gx, gy = torch.meshgrid(r, r, indexing="xy")
        return torch.stack([gx, gy], dim=-1).reshape(-1, 2)

    def forward(self, fmaps: torch.Tensor, query_points: torch.Tensor):
        """fmaps (B, S, H2, W2, C) fp32 at 1/stride resolution, query_points
        (B, N, 2) (x, y) pixels of frame 0 at full resolution. Returns
        (tracks (B, S, N, 2) pixels, vis logits, conf logits (B, S, N))."""
        B, S, H2, W2, C = fmaps.shape
        fmaps = self.fmap_norm(fmaps)
        q = query_points.float() / self.stride
        N = q.shape[1]
        track_feat0 = bilinear_sample(fmaps[:, 0], q)
        pyramid = [fmaps.reshape(B * S, H2, W2, C)]
        for _ in range(self.corr_levels - 1):
            pyramid.append(_pool2(pyramid[-1]))
        offs = self._window_offsets(fmaps.device)
        K = offs.shape[0]
        femb = self.latent_dim // 2
        first = (torch.arange(S, device=fmaps.device) == 0)[None, :, None, None]
        ref = torch.where(first, self.query_ref_token[:, 0][:, None, None],
                          self.query_ref_token[:, 1][:, None, None])

        coords = q[:, None].expand(B, S, N, 2)
        track_feat = track_feat0[:, None].expand(B, S, N, C)
        for _ in range(self.iters):
            coords = coords.detach()
            tf_flat = track_feat.reshape(B * S, N, C, 1)
            corrs = []
            for lvl, f_l in enumerate(pyramid):
                win = coords.reshape(B * S, N, 1, 2) / (2.0 ** lvl) + offs
                sampled = bilinear_sample(f_l, win.reshape(B * S, N * K, 2))
                corr = (sampled.reshape(B * S, N, K, C) @ tf_flat)[..., 0]
                corrs.append(corr / math.sqrt(C))
            corr_emb = self.corr_mlp(torch.cat(corrs, dim=-1).reshape(
                B, S, N, self.corr_levels * K))
            flows = (coords - coords[:, :1]) / self.max_scale
            x = torch.cat([get_2d_embedding(flows, femb), flows, flows, corr_emb, track_feat],
                          dim=-1)
            if self.pad:
                x = nn.functional.pad(x, (0, self.pad))
            delta = self.updateformer((x + ref).transpose(1, 2)).transpose(1, 2)
            coords = coords + delta[..., :2]
            dfeat = self.ffeat_norm(delta[..., 2:].reshape(-1, C)).reshape(B, S, N, C)
            track_feat = track_feat + self.ffeat_updater(dfeat)
        vis = self.vis_predictor(track_feat)[..., 0]
        conf = self.conf_predictor(track_feat)[..., 0]
        return coords * self.stride, vis, conf


class TrackHead(nn.Module):
    """DPT feature extractor (feature-only, 1/stride, no pos embedding) in
    ``dtype`` + the fp32 tracker."""

    def __init__(self, dim_in: int = 2048, patch_size: int = 14, features: int = 128,
                 stride: int = 2, iters: int = 4, corr_levels: int = 7, corr_radius: int = 4,
                 hidden_size: int = 384, updater_depth: int = 6, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.feature_extractor = DPTHead(
            dim_in=dim_in, features=features,
            out_channels=(features, features * 2, features * 4, features * 4),
            patch_size=patch_size, pos_embed=False, feature_only=True, down_ratio=stride,
            dtype=dtype, device=device)
        self.tracker = BaseTrackerPredictor(
            latent_dim=features, stride=stride, corr_levels=corr_levels,
            corr_radius=corr_radius, hidden_size=hidden_size, updater_depth=updater_depth,
            iters=iters, device=device)

    def forward(self, token_list: Sequence[torch.Tensor], images: torch.Tensor,
                patch_start_idx: int, query_points: torch.Tensor):
        """token_list: the 4 taps (B, S, T, dim_in); images (B, S, 3, H, W);
        query_points (B, N, 2) (x, y) pixels of frame 0. Returns tracks
        (B, S, N, 2) pixels, visibility and confidence (B, S, N), the last
        two through a sigmoid."""
        fmaps = self.feature_extractor(token_list, images, patch_start_idx)
        tracks, vis, conf = self.tracker(fmaps.float(), query_points)
        return tracks, torch.sigmoid(vis), torch.sigmoid(conf)
