"""Quaternion / rotation-matrix math (port of vitslam_tpu/geometry/rotations.py).

Quaternions are **xyzw** (scalar last). Everything is fp32 and batched over
leading dims.
"""
from __future__ import annotations

import torch


def quat_to_mat(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) xyzw -> rotation matrices (..., 3, 3)."""
    quat = quat.float()
    x, y, z, w = quat.unbind(-1)
    n2 = x * x + y * y + z * z + w * w
    s = 2.0 / n2.clamp_min(1e-12)
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    m = torch.stack(
        [
            1.0 - (yy + zz), xy - wz, xz + wy,
            xy + wz, 1.0 - (xx + zz), yz - wx,
            xz - wy, yz + wx, 1.0 - (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero gradient where x <= 0: the sqrt is only
    evaluated on positive entries (sqrt(clamp(x, 0)) would give an infinite
    derivative at 0, and 0 * inf = NaN in the backward)."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def mat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) xyzw, w >= 0.

    Branchless candidate selection: the candidate with the largest diagonal
    trace term wins."""
    m = matrix.float()
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = _sqrt_positive_part(torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    ))
    # candidate quaternions in wxyz order; row k assumes q_abs[k] is largest
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs.argmax(dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    quat_wxyz = torch.gather(quat_candidates, -2, idx)[..., 0, :]
    quat_wxyz = quat_wxyz / quat_wxyz.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    quat = torch.cat([quat_wxyz[..., 1:], quat_wxyz[..., :1]], dim=-1)
    return torch.where(quat[..., 3:4] < 0, -quat, quat)


def normalize_quat(quat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return quat / quat.norm(dim=-1, keepdim=True).clamp_min(eps)


def average_quaternions(quats: torch.Tensor,
                        weights: torch.Tensor | None = None) -> torch.Tensor:
    """Markley quaternion mean: the dominant eigenvector of
    M = sum_i w_i q_i q_i^T. quats (..., N, 4) xyzw -> (..., 4), unit, with
    the arbitrary global sign ``eigh`` returns."""
    q = normalize_quat(quats.float())
    n = q.shape[-2]
    if weights is None:
        weights = torch.full(q.shape[:-1], 1.0 / n, dtype=torch.float32,
                             device=q.device)
    else:
        weights = weights.float()
        weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    m = torch.einsum("...n,...ni,...nj->...ij", weights, q, q)
    _, eigvecs = torch.linalg.eigh(m)
    avg = eigvecs[..., -1]  # eigenvector of the largest eigenvalue
    return avg / avg.norm(dim=-1, keepdim=True).clamp_min(1e-8)


def rotation_angle(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle (radians) of rotation matrices (..., 3, 3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0 + eps, 1.0 - eps))
