"""Camera projection and unprojection in fp32 (port of
vitslam_tpu/geometry/projection.py)."""
from __future__ import annotations

import torch

from .se3 import closed_form_inverse_se3


def generate_pixel_grid(H: int, W: int, device=None) -> torch.Tensor:
    """(H, W, 3) homogeneous pixel coordinates (u, v, 1), u along the width."""
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)


def unproject_depth_to_points(depth_map: torch.Tensor, extrinsics: torch.Tensor,
                              intrinsics: torch.Tensor) -> torch.Tensor:
    """World-space point maps (B, S, H, W, 3) from camera-space depths
    (B, S, H, W[, 1]), world-to-camera extrinsics (B, S, 3|4, 4) and
    intrinsics (B, S, 3, 3)."""
    if depth_map.ndim == 5:
        depth_map = depth_map[..., 0]
    depth_map = depth_map.float()
    B, S, H, W = depth_map.shape
    pix = generate_pixel_grid(H, W, depth_map.device).reshape(-1, 3)
    k_inv = torch.linalg.inv(intrinsics.float())
    rays = torch.einsum("bsij,nj->bsni", k_inv, pix)
    cam = rays * depth_map.reshape(B, S, -1, 1)
    c2w = closed_form_inverse_se3(extrinsics.float())
    world = torch.einsum("bsij,bsnj->bsni", c2w[..., :3, :3], cam) + c2w[..., None, :3, 3]
    return world.reshape(B, S, H, W, 3)


def project_points_to_pixels(world_points: torch.Tensor, extrinsics: torch.Tensor,
                             intrinsics: torch.Tensor):
    """Project world points (B, S, H, W, 3) with w2c extrinsics (B, S, 3|4, 4)
    and intrinsics (B, S, 3, 3). Returns pixels (B, S, H, W, 3) as (u, v,
    signed w) with u, v divided by |w| where valid, and the valid mask
    (B, S, H, W) of 1e-8 < |w| < 100."""
    wp = world_points.float()
    e = extrinsics.float()
    cam = torch.einsum("bsij,bshwj->bshwi", e[..., :3, :3], wp) + e[..., None, None, :3, 3]
    pix = torch.einsum("bsij,bshwj->bshwi", intrinsics.float(), cam)
    absw = pix[..., 2].abs()
    valid = (absw > 1e-8) & (absw < 100.0)
    denom = torch.where(valid, absw, torch.ones_like(absw))[..., None]
    pix = torch.where(valid[..., None], pix / denom, pix)
    return pix, valid
