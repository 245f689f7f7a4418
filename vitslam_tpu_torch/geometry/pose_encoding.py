"""Camera pose encodings, fp32 (port of vitslam_tpu/geometry/pose_encoding.py).

* 7-d ``[t(3), quat_xyzw(4)]`` — AlignmentHead outputs, overlap averaging.
* 9-d absT_quaR_FoV ``[t(3), quat_xyzw(4), fov_h, fov_w]`` — CameraHead.
"""
from __future__ import annotations

import torch

from .rotations import average_quaternions, mat_to_quat, normalize_quat, quat_to_mat
from .se3 import pad_to_4x4


def extri_to_pose_encoding(extrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 3|4, 4) w2c -> (..., 7) [t, quat_xyzw]."""
    e = extrinsics.float()
    quat = normalize_quat(mat_to_quat(e[..., :3, :3]))
    return torch.cat([e[..., :3, 3], quat], dim=-1)


def pose_encoding_to_extri(pose_encoding: torch.Tensor) -> torch.Tensor:
    """(..., 7) [t, quat_xyzw] -> (..., 4, 4) homogeneous w2c."""
    pe = pose_encoding.float()
    R = quat_to_mat(normalize_quat(pe[..., 3:7]))
    return pad_to_4x4(torch.cat([R, pe[..., :3, None]], dim=-1))


def extri_intri_to_pose_encoding(extrinsics: torch.Tensor,
                                 intrinsics: torch.Tensor | None,
                                 image_size_hw: tuple[int, int] | None = None
                                 ) -> torch.Tensor:
    """(B, S, 3, 4) w2c + (B, S, 3, 3) K -> (B, S, 9) absT_quaR_FoV; the FoV
    slots are zero without intrinsics."""
    e = extrinsics.float()
    quat = normalize_quat(mat_to_quat(e[..., :3, :3]))
    if intrinsics is None:
        fov = torch.zeros(e.shape[:-2] + (2,), dtype=torch.float32,
                          device=e.device)
    else:
        k = intrinsics.float()
        H, W = image_size_hw
        fov_h = 2.0 * torch.arctan((H / 2.0) / k[..., 1, 1])
        fov_w = 2.0 * torch.arctan((W / 2.0) / k[..., 0, 0])
        fov = torch.stack([fov_h, fov_w], dim=-1)
    return torch.cat([e[..., :3, 3], quat, fov], dim=-1)


def pose_encoding_to_extri_intri(pose_encoding: torch.Tensor,
                                 image_size_hw: tuple[int, int],
                                 build_intrinsics: bool = True):
    """(B, S, 9) -> ((B, S, 3, 4) w2c, (B, S, 3, 3) K or None); principal
    point at the image centre."""
    pe = pose_encoding.float()
    R = quat_to_mat(normalize_quat(pe[..., 3:7]))
    extr = torch.cat([R, pe[..., :3, None]], dim=-1)
    intr = None
    if build_intrinsics:
        H, W = image_size_hw
        fy = (H / 2.0) / torch.tan(pe[..., 7] / 2.0).clamp_min(1e-6)
        fx = (W / 2.0) / torch.tan(pe[..., 8] / 2.0).clamp_min(1e-6)
        zeros = torch.zeros_like(fx)
        ones = torch.ones_like(fx)
        intr = torch.stack(
            [
                torch.stack([fx, zeros, torch.full_like(fx, W / 2.0)], dim=-1),
                torch.stack([zeros, fy, torch.full_like(fy, H / 2.0)], dim=-1),
                torch.stack([zeros, zeros, ones], dim=-1),
            ],
            dim=-2,
        )
    return extr, intr


def average_pose_encodings(pose_encodings: torch.Tensor) -> torch.Tensor:
    """(B, N, 7) -> (B, 1, 7): mean translation + Markley quaternion mean."""
    pe = pose_encodings.float()
    avg_t = pe[..., :3].mean(dim=1, keepdim=True)
    avg_q = average_quaternions(pe[..., 3:7])[:, None, :]
    return torch.cat([avg_t, avg_q], dim=-1)
