"""SE(3) / Sim(3) transform utilities, fp32 (port of vitslam_tpu/geometry/se3.py)."""
from __future__ import annotations

import torch


def pad_to_4x4(mats: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> homogeneous (..., 4, 4); (..., 4, 4) passes through."""
    if mats.shape[-2] == 4:
        return mats
    bottom = torch.zeros(mats.shape[:-2] + (1, 4), dtype=mats.dtype,
                         device=mats.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([mats, bottom], dim=-2)


def closed_form_inverse_se3(se3: torch.Tensor) -> torch.Tensor:
    """inv([R t]) = [R^T  -R^T t]; (..., 3|4, 4) -> (..., 4, 4)."""
    se3 = se3.float()
    R = se3[..., :3, :3]
    t = se3[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    return pad_to_4x4(torch.cat([Rt, -Rt @ t], dim=-1))


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return pad_to_4x4(a) @ pad_to_4x4(b)


def compute_relative_poses(extrinsics: torch.Tensor, offset: int = 1,
                           to_next: bool = True) -> torch.Tensor:
    """(B, S, 3|4, 4) w2c -> (B, S-offset, 3, 4) relative transforms."""
    w2c = pad_to_4x4(extrinsics.float())
    c2w = closed_form_inverse_se3(w2c)
    if to_next:
        rel = w2c[:, offset:] @ c2w[:, :-offset]
    else:
        rel = w2c[:, :-offset] @ c2w[:, offset:]
    return rel[..., :3, :4]


def scale_translation(mats: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(..., 3|4, 4) transforms with their translation column multiplied by
    ``scale`` (broadcast over the leading dims), out of place, so autograd
    can differentiate through both."""
    t = mats[..., :3, 3:] * scale[..., None, None]
    top = torch.cat([mats[..., :3, :3], t], dim=-1)
    return torch.cat([top, mats[..., 3:, :]], dim=-2)


def apply_sim3_on_c2w(poses: torch.Tensor, transform: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Scale the translations of c2w poses (B, S, 3|4, 4), then left-multiply
    by the rigid transform (B, 4, 4)."""
    poses = pad_to_4x4(poses.float())
    B = poses.shape[0]
    poses = scale_translation(poses, scale.reshape(B, 1))
    return transform[:, None].float() @ poses


def apply_sim3_on_w2c(extr: torch.Tensor, transform: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """w2c' = inv(T @ scale(c2w)); returns (B, S, 4, 4)."""
    c2w = closed_form_inverse_se3(pad_to_4x4(extr.float()))
    return closed_form_inverse_se3(apply_sim3_on_c2w(c2w, transform, scale))


def apply_sim3_on_point_maps(point_maps: torch.Tensor, transform: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Point maps (B, S, H, W, 3): scale, then rigid transform."""
    pts = point_maps.float()
    B = pts.shape[0]
    bshape = (B,) + (1,) * (pts.ndim - 2)
    pts = pts * scale.reshape(bshape + (1,))
    R = transform[:, :3, :3].float()
    t = transform[:, :3, 3].float()
    return torch.einsum("bij,b...j->b...i", R, pts) + t.reshape(bshape + (3,))
