"""DPTHead — dense depth / point-map decoder over the tapped layers (port of
vitslam_tpu/models/dpt_head.py), in NCHW.

Four taps are projected to a channel pyramid (``project_i``), resampled by
learned layers (``resize_layer_0/1``: k=s transposed convs 4x / 2x,
``resize_layer_3``: strided 3x3 conv), reduced by 3x3 convs (``scratch_i``),
fused top-down through residual conv units (``fusion_3..0``, each upsampling
with align-corners bilinear), then decoded at full pixel resolution. Convs
run in the compute dtype, the final 1x1 conv and activations in fp32.
``feature_only`` (the TrackHead's feature extractor) stops after a 3x3
``head_conv1`` at ``features`` channels and returns that map resized to
1/``down_ratio`` of the image, channels last.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d, _param, lecun_normal_
from ..ops.resize import resize_bilinear_nchw
from ..ops.transfer import to_device


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return resize_bilinear_nchw(x, h, w, align_corners=True)


@functools.lru_cache(maxsize=32)
def _dpt_pos_embed(ph: int, pw: int, dim: int, img_w: int, img_h: int,
                   ratio: float = 0.1, omega_0: float = 100.0) -> np.ndarray:
    """Fixed 2-D sin-cos embedding over an aspect-corrected uv grid in
    [-1, 1], scaled by ``ratio``; (dim, ph, pw) fp32."""
    aspect = img_w / img_h
    diag = float(np.hypot(aspect, 1.0))
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = np.linspace(-span_x * (pw - 1) / pw, span_x * (pw - 1) / pw, pw)
    ys = np.linspace(-span_y * (ph - 1) / ph, span_y * (ph - 1) / ph, ph)

    def sincos(pos: np.ndarray, d: int) -> np.ndarray:
        omega = 1.0 / omega_0 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = pos.reshape(-1)[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    uu, vv = np.meshgrid(xs, ys)
    emb = np.concatenate([sincos(uu, dim // 2), sincos(vv, dim // 2)], axis=-1)
    emb = ratio * emb.reshape(ph, pw, dim)
    return np.ascontiguousarray(emb.transpose(2, 0, 1)).astype(np.float32)


class StridedUpsample(nn.Module):
    """k=s transposed conv (torch ConvTranspose2d(cin, features, k, stride=k),
    padding 0). The weight keeps the exported (features, cin, k, k) layout of
    the reference's (k, k, cin, features) kernel."""

    def __init__(self, cin: int, features: int, factor: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.factor, self.dtype = factor, dtype
        self.weight = _param(features, cin, factor, factor, device=device)
        self.bias = _param(features, device=device)

    def init_params(self, g):
        # flax lecun_normal on the (k, k, cin, out) kernel: fan_in = k*k*cin
        lecun_normal_(self.weight, self.weight[0].numel(), g)
        self.bias.zero_()

    def forward(self, x):
        w = self.weight.transpose(0, 1).to(self.dtype)  # ConvTranspose: (cin, out, k, k)
        return F.conv_transpose2d(x.to(self.dtype), w, self.bias.to(self.dtype),
                                  stride=self.factor)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, dtype=dtype, device=device)
        self.conv2 = Conv2d(features, features, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """Skip-add through rcu1 (when a skip input exists), refine with rcu2,
    upsample (2x or to ``out_hw``) with align-corners bilinear, 1x1 out_conv."""

    def __init__(self, features: int, has_skip: bool, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.rcu1 = ResidualConvUnit(features, dtype, device) if has_skip else None
        self.rcu2 = ResidualConvUnit(features, dtype, device)
        self.out_conv = Conv2d(features, features, 1, dtype=dtype, device=device)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if out_hw is None:
            out_hw = (2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(_resize(x, *out_hw))


class DPTHead(nn.Module):
    def __init__(self, dim_in: int = 2048, output_dim: int = 4, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 activation: str = "inv_log", conf_activation: str = "expp1",
                 patch_size: int = 14, pos_embed: bool = True,
                 feature_only: bool = False, down_ratio: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if activation not in ("exp", "inv_log", "linear"):
            raise ValueError(f"unknown activation {activation!r}")
        if conf_activation not in ("expp1", "sigmoid"):
            raise ValueError(f"unknown conf_activation {conf_activation!r}")
        self.dim_in, self.output_dim, self.patch_size = dim_in, output_dim, patch_size
        self.activation, self.conf_activation = activation, conf_activation
        self.use_pos_embed, self.out_channels, self.dtype = pos_embed, tuple(out_channels), dtype
        self.feature_only, self.down_ratio, self.features = feature_only, down_ratio, features
        oc = self.out_channels
        kw = dict(dtype=dtype, device=device)
        for i in range(4):
            self.add_module(f"project_{i}", Conv2d(dim_in, oc[i], 1, **kw))
        self.resize_layer_0 = StridedUpsample(oc[0], oc[0], 4, **kw)
        self.resize_layer_1 = StridedUpsample(oc[1], oc[1], 2, **kw)
        self.resize_layer_3 = Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **kw)
        for i in range(4):
            self.add_module(f"scratch_{i}", Conv2d(oc[i], features, 3, padding=1,
                                                   bias=False, **kw))
        self.fusion_3 = FeatureFusionBlock(features, False, **kw)
        self.fusion_2 = FeatureFusionBlock(features, True, **kw)
        self.fusion_1 = FeatureFusionBlock(features, True, **kw)
        self.fusion_0 = FeatureFusionBlock(features, True, **kw)
        if feature_only:
            self.head_conv1 = Conv2d(features, features, 3, padding=1, **kw)
            return
        self.head_conv1 = Conv2d(features, features // 2, 3, padding=1, **kw)
        self.head_conv2 = Conv2d(features // 2, 32, 3, padding=1, **kw)
        self.head_out = Conv2d(32, output_dim, 1, dtype=torch.float32, device=device)

    def forward(self, token_list, images: torch.Tensor, patch_start_idx: int):
        """token_list: 4 taps (B, S, T, dim_in), shallow -> deep; images
        (B, S, 3, H, W), for the output size. Returns (map (B, S, H, W,
        output_dim-1), conf (B, S, H, W)), fp32; in feature_only mode one
        (B, S, H/dr, W/dr, features) map in the compute dtype."""
        B, S, _, H, W = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        if len(token_list) != 4:
            raise ValueError("DPTHead expects 4 tapped layers")
        feats = []
        for i, tokens in enumerate(token_list):
            t = tokens[:, :, patch_start_idx:].to(self.dtype)
            t = t.reshape(B * S, gh, gw, self.dim_in).permute(0, 3, 1, 2)
            t = getattr(self, f"project_{i}")(t)
            if self.use_pos_embed:
                pe = _dpt_pos_embed(gh, gw, self.out_channels[i], W, H)
                t = t + to_device(pe, t.device).to(self.dtype)
            if i == 0:
                t = self.resize_layer_0(t)
            elif i == 1:
                t = self.resize_layer_1(t)
            elif i == 3:
                t = self.resize_layer_3(t)
            feats.append(getattr(self, f"scratch_{i}")(t))

        f0, f1, f2, f3 = feats  # f0 finest (4x), f3 coarsest (0.5x)
        y = self.fusion_3(f3, out_hw=f2.shape[-2:])
        y = self.fusion_2(y, skip=f2, out_hw=f1.shape[-2:])
        y = self.fusion_1(y, skip=f1, out_hw=f0.shape[-2:])
        y = self.fusion_0(y, skip=f0)
        y = self.head_conv1(y)
        if self.feature_only:
            h, w = H // self.down_ratio, W // self.down_ratio
            y = _resize(y, h, w)
            return y.reshape(B, S, self.features, h, w).permute(0, 1, 3, 4, 2)
        y = _resize(y, H, W)
        y = F.relu(self.head_conv2(y))
        y = self.head_out(y)  # fp32
        y = y.reshape(B, S, self.output_dim, H, W).permute(0, 1, 3, 4, 2)

        raw_map, raw_conf = y[..., :-1], y[..., -1]
        if self.activation == "exp":
            out_map = torch.exp(raw_map.clamp(-30.0, 30.0))
        elif self.activation == "inv_log":
            out_map = torch.sign(raw_map) * torch.expm1(raw_map.abs().clamp(max=30.0))
        else:
            out_map = raw_map
        if self.conf_activation == "expp1":
            conf = 1.0 + torch.exp(raw_conf.clamp(-30.0, 30.0))
        else:
            conf = torch.sigmoid(raw_conf)
        return out_map, conf
