"""Resizes as matmuls (port of vitslam_tpu/ops/resize.py).

A bilinear or bicubic resize is a linear map, so resizing (..., C, H, W) to
(..., C, H', W') is ``W_h @ x @ W_w^T`` with two precomputed row-stochastic
matrices. The matrices are built in numpy with the reference's exact
conventions; ``F.interpolate`` is not used, because its bicubic kernel
(a = -0.75) and its antialias rules differ from ``jax.image.resize``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .transfer import to_device


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(out_size: int, in_size: int,
                     align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear weights.

    align_corners=False: half-pixel centres with antialiasing on downscale
    (the triangle widened to the scale), jax.image.resize's convention.
    align_corners=True: endpoint-pinned grid, no antialias, the convention of
    the DPT fusion upsampling."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    j = np.arange(in_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = np.arange(out_size, dtype=np.float64) * scale
        width = 1.0
    else:
        scale = in_size / out_size
        width = max(scale, 1.0)
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(src[:, None] - j[None, :]) / width)
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a = -0.5 (jax.image's "bicubic")."""
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                   ((1.5 * x - 2.5) * x) * x + 1.0)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=16)
def bicubic_matrix(out_size: int, in_size: int,
                   antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) weights of ``jax.image.resize(..., "bicubic",
    antialias=antialias)`` along one axis: half-pixel centres, the kernel
    widened by the inverse scale on downscale, rows renormalised to sum 1,
    and samples outside the input range zeroed."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None])
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize_matmul(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray) -> torch.Tensor:
    """Apply (H', H) and (W', W) weight matrices to the last two dims of x,
    in x's dtype."""
    wh_t = to_device(wh, x.device, x.dtype)
    ww_t = to_device(ww, x.device, x.dtype)
    return torch.matmul(torch.matmul(wh_t, x), ww_t.transpose(0, 1))


def resize_bilinear_nchw(x: torch.Tensor, out_h: int, out_w: int,
                         align_corners: bool = False) -> torch.Tensor:
    """Resize (..., C, H, W) to (..., C, out_h, out_w) bilinearly."""
    h, w = x.shape[-2], x.shape[-1]
    if h == out_h and w == out_w:
        return x
    return resize_matmul(x, _bilinear_matrix(out_h, h, align_corners),
                         _bilinear_matrix(out_w, w, align_corners))
