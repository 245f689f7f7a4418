"""Rotary position embeddings, 1-D and 2-D (port of vitslam_tpu/nn/rope.py).

For head dim D there are D/2 bands ``1 / base**(2i/D)``, duplicated across
both halves; the rotation is the half-split ``(-x2, x1)`` form:

    out = x * cos(theta) + [-x2, x1] * sin(theta)

2-D RoPE rotates the first half of the head dim by the row positions and the
second half by the column positions. A cache is a ``(cos, sin, nsplit)``
triple; ``nsplit`` says into how many independently rotated blocks the last
dim splits (1 for 1-D, 2 for 2-D).
"""
from __future__ import annotations

import torch


def _rope_angles(positions: torch.Tensor, dim: int, base: float):
    """cos/sin of shape positions.shape + (dim,) with duplicated bands."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=positions.device) / dim
    inv_freq = 1.0 / (base ** exponents)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rotate_half_multi(x: torch.Tensor, nsplit: int) -> torch.Tensor:
    """Half-rotation applied independently within each of ``nsplit``
    contiguous blocks of the last dim."""
    if nsplit == 1:
        return _rotate_half(x)
    d = x.shape[-1]
    xs = x.reshape(x.shape[:-1] + (nsplit, d // nsplit))
    return _rotate_half(xs).reshape(x.shape)


def apply_rope_1d(tokens: torch.Tensor, positions: torch.Tensor,
                  base: float = 100.0) -> torch.Tensor:
    """tokens (B, H, N, D), positions (B, N) -> (B, H, N, D); fp32 math,
    cast back to tokens.dtype."""
    cos, sin = _rope_angles(positions, tokens.shape[-1], base)
    x = tokens.float()
    out = x * cos[:, None] + _rotate_half(x) * sin[:, None]
    return out.to(tokens.dtype)


def apply_rope_2d(tokens: torch.Tensor, positions: torch.Tensor,
                  base: float = 100.0) -> torch.Tensor:
    """tokens (B, H, N, D) with D % 4 == 0, positions (B, N, 2) (row, col)."""
    d = tokens.shape[-1]
    if d % 4:
        raise ValueError(f"2-D RoPE needs head dim divisible by 4, got {d}")
    half = d // 2
    x = tokens.float()
    y_part, x_part = x[..., :half], x[..., half:]
    cos_y, sin_y = _rope_angles(positions[..., 0], half, base)
    cos_x, sin_x = _rope_angles(positions[..., 1], half, base)
    y_out = y_part * cos_y[:, None] + _rotate_half(y_part) * sin_y[:, None]
    x_out = x_part * cos_x[:, None] + _rotate_half(x_part) * sin_x[:, None]
    return torch.cat([y_out, x_out], dim=-1).to(tokens.dtype)


def rope_cache_1d(positions: torch.Tensor, dim: int, base: float = 100.0):
    """(cos, sin, 1) for 1-D RoPE, hoisted out of hot loops."""
    cos, sin = _rope_angles(positions, dim, base)
    return cos, sin, 1


def rope_cache_2d(positions: torch.Tensor, dim: int, base: float = 100.0):
    """(cos, sin, 2) for 2-D RoPE: row bands in the first half of the head
    dim, column bands in the second."""
    half = dim // 2
    cos_y, sin_y = _rope_angles(positions[..., 0], half, base)
    cos_x, sin_x = _rope_angles(positions[..., 1], half, base)
    return (torch.cat([cos_y, cos_x], dim=-1),
            torch.cat([sin_y, sin_x], dim=-1), 2)


def apply_rope_cached(tokens: torch.Tensor, cache) -> torch.Tensor:
    """tokens (B, H, N, D); cache cos/sin (B, N, D)."""
    cos, sin, nsplit = cache
    x = tokens.float()
    out = x * cos[:, None] + rotate_half_multi(x, nsplit) * sin[:, None]
    return out.to(tokens.dtype)


def apply_rope_flat(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    num_heads: int, nsplit: int) -> torch.Tensor:
    """RoPE in the flat (B, N, num_heads*head_dim) layout; cos/sin are
    (B, N, head_dim) or head-tiled (B, N, C). Computed in x.dtype, as the
    reference's lane-permutation form is."""
    B, N, C = x.shape
    dh = C // num_heads
    cos = cos[..., :dh].to(x.dtype)
    sin = sin[..., :dh].to(x.dtype)
    xh = x.reshape(B, N, num_heads, dh)
    out = xh * cos[:, :, None] + rotate_half_multi(xh, nsplit) * sin[:, :, None]
    return out.reshape(B, N, C)


def patch_grid_positions(batch: int, grid_h: int, grid_w: int,
                         num_special: int, device=None) -> torch.Tensor:
    """(B, num_special + grid_h*grid_w, 2) int positions: special tokens at
    (0, 0), patch tokens on the (row+1, col+1) grid."""
    rows = torch.arange(1, grid_h + 1, device=device).repeat_interleave(grid_w)
    cols = torch.arange(1, grid_w + 1, device=device).repeat(grid_h)
    grid = torch.stack([rows, cols], dim=-1)
    special = torch.zeros((num_special, 2), dtype=grid.dtype, device=device)
    pos = torch.cat([special, grid], dim=0)
    return pos.expand((batch,) + pos.shape)
