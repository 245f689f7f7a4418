"""Ground-truth alignment (port of vitslam_tpu/slam/gt_alignment.py): after
the chunked predictions are merged, resolve the global scale / Sim(3)
ambiguity against GT before losses and metrics. The seven types:
per_frame_scale_from_poses, per_chunk_scale_from_poses (applied per chunk
before the merge), scale_from_poses, scale_from_fc_poses,
scale_from_depths, sim3_from_poses and sim3_from_points, and ``none``.

Every solver is batched over B in fp32; prediction dicts are transformed
out of place. Gradients flow through every alignment except
``scale_from_depths``, whose scales are detached, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..geometry import (
    apply_sim3_on_point_maps,
    apply_sim3_on_w2c,
    closed_form_inverse_se3,
    depth_scale_weights,
    extri_intri_to_pose_encoding,
    pad_to_4x4,
    pose_encoding_to_extri_intri,
    umeyama,
    weighted_median_scale,
)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).float()


def _apply_scales(pred: dict, scales: torch.Tensor) -> dict:
    """Scale pose translations, depths and world points by per-batch scales."""
    out = dict(pred)
    B = scales.shape[0]
    if "pose_enc" in out:
        pe = out["pose_enc"]
        out["pose_enc"] = torch.cat([pe[..., :3] * scales[:, None, None], pe[..., 3:]], dim=-1)
    for key in ("depth", "world_points"):
        if key in out:
            out[key] = out[key] * scales.reshape(B, 1, 1, 1, 1)
    out["alignment_scales"] = scales
    return out


def _lse_scale(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|sum(x*y) / sum(x^2)| over all but the leading batch axis."""
    dims = tuple(range(1, x.ndim))
    return ((x * y).sum(dim=dims) / (x * x).sum(dim=dims).clamp_min(1e-12)).abs()


def scale_from_poses(pred: dict, batch: dict, seq_width: int = -1) -> dict:
    """One least-squares scale per batch element from the w2c positions."""
    pred_pos = pred["pose_enc"][..., :3].float()
    gt_pos = _f32(batch["extrinsics"], pred_pos.device)[..., :3, 3]
    if seq_width > 0:
        gt_pos, pred_pos = gt_pos[:, :seq_width], pred_pos[:, :seq_width]
    return _apply_scales(pred, _lse_scale(pred_pos, gt_pos))


def per_frame_scale_from_poses(pred: dict, batch: dict) -> dict:
    """One least-squares scale per frame; frame 0 keeps scale 1."""
    pe = pred["pose_enc"].float()
    gt_pos = _f32(batch["extrinsics"], pe.device)[..., :3, 3]
    pred_pos = pe[..., :3]
    scales = ((pred_pos * gt_pos).sum(-1) / (pred_pos * pred_pos).sum(-1).clamp_min(1e-12)).abs()
    scales = torch.cat([torch.ones_like(scales[:, :1]), scales[:, 1:]], dim=1)  # (B, S)
    out = dict(pred)
    out["pose_enc"] = torch.cat([pe[..., :3] * scales[..., None], pe[..., 3:]], dim=-1)
    for key in ("depth", "world_points"):
        if key in out:
            out[key] = out[key] * scales[:, :, None, None, None]
    out["alignment_scales"] = scales
    return out


def per_chunk_scale_from_poses(chunk_preds: list, chunk_batches: list) -> list:
    """One least-squares scale per chunk, applied before merging."""
    out = []
    for cp, cb in zip(chunk_preds, chunk_batches):
        pred_pos = cp["pose_enc"][..., :3].float()
        gt_pos = _f32(cb["extrinsics"], pred_pos.device)[..., :3, 3]
        out.append(_apply_scales(cp, _lse_scale(pred_pos, gt_pos)))
    return out


def scale_from_depths(pred: dict, batch: dict) -> dict:
    """Robust L1-optimal scale per batch element: the weighted median over
    S*H*W pixels with weights mask * confidence * clamped inverse GT depth.
    The scales are detached."""
    d_pred = pred["depth"].float()
    dev = d_pred.device
    B = d_pred.shape[0]
    x = d_pred.reshape(B, -1)
    y = _f32(batch["depths"], dev).reshape(B, -1)
    m = _f32(batch["point_masks"], dev).reshape(B, -1)
    w = depth_scale_weights(y, m, pred["depth_conf"].float().reshape(B, -1))
    return _apply_scales(pred, weighted_median_scale(x, y, w).detach())


def _sim3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=torch.float32, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def sim3_from_poses(pred: dict, batch: dict, seq_width: int,
                    image_size_hw: tuple[int, int]) -> dict:
    """Umeyama Sim(3) on the c2w camera positions of frames [:seq_width]
    (the reference's slice, so -1 leaves out the last frame)."""
    pe = pred["pose_enc"]
    gt_c2w = closed_form_inverse_se3(
        pad_to_4x4(_f32(batch["extrinsics"], pe.device)[:, :seq_width]))
    pred_extr, _ = pose_encoding_to_extri_intri(pe[:, :seq_width], image_size_hw)
    pred_c2w = closed_form_inverse_se3(pad_to_4x4(pred_extr))
    R, t, s = umeyama(pred_c2w[..., :3, 3], gt_c2w[..., :3, 3])
    return apply_sim3_on_dict(pred, image_size_hw, _sim3(R, t), s)


def sim3_from_points(pred: dict, batch: dict, seq_width: int,
                     image_size_hw: tuple[int, int],
                     confidence_threshold: float = 50.0) -> dict:
    """Umeyama Sim(3) on point maps: points with a valid GT mask, a predicted
    confidence at or above its per-batch ``confidence_threshold``
    percentile (linear interpolation) and above 1e-5 weigh 1, the rest 0."""
    pp = pred["world_points"][:, :seq_width].float()
    dev = pp.device
    B = pp.shape[0]
    pc = pred["world_points_conf"][:, :seq_width].float().reshape(B, -1)
    tp = _f32(batch["world_points"], dev)[:, :seq_width].reshape(B, -1, 3)
    tm = _f32(batch["point_masks"], dev)[:, :seq_width].reshape(B, -1)
    thresh = torch.quantile(pc, confidence_threshold / 100.0, dim=-1, keepdim=True)
    w = ((tm > 0) & (pc >= thresh) & (pc > 1e-5)).float()
    R, t, s = umeyama(pp.reshape(B, -1, 3), tp, w)
    return apply_sim3_on_dict(pred, image_size_hw, _sim3(R, t), s)


def apply_sim3_on_dict(pred: dict, image_size_hw, transforms: torch.Tensor,
                       scales: torch.Tensor) -> dict:
    """Apply a per-batch Sim(3) to pose encodings, point maps and depths
    (depths only scale: the rigid part cancels for unprojected maps)."""
    out = dict(pred)
    B = transforms.shape[0]
    if "pose_enc" in out:
        extr, intr = pose_encoding_to_extri_intri(out["pose_enc"], image_size_hw)
        extr = apply_sim3_on_w2c(extr, transforms, scales)
        out["pose_enc"] = extri_intri_to_pose_encoding(extr[..., :3, :4], intr, image_size_hw)
    if "world_points" in out:
        out["world_points"] = apply_sim3_on_point_maps(out["world_points"], transforms, scales)
    if "depth" in out:
        out["depth"] = out["depth"] * scales.reshape(B, 1, 1, 1, 1)
    out["alignment_transforms"] = transforms
    out["alignment_scales"] = scales
    return out


def align_outputs(pred: dict, batch: dict, alignment_type: Optional[str],
                  seq_width: int = -1,
                  image_size_hw: Optional[tuple[int, int]] = None) -> dict:
    """Dispatch over merged predictions (torch tensors) and a merged GT
    batch (numpy or torch). ``per_chunk_scale_from_poses`` is applied by the
    pipeline before merging, so here it, like ``none``, passes through."""
    if alignment_type in (None, "none", "per_chunk_scale_from_poses"):
        return pred
    if image_size_hw is None and "images" in batch:
        image_size_hw = tuple(batch["images"].shape[-2:])
    if alignment_type == "scale_from_fc_poses":
        return scale_from_poses(pred, batch, seq_width)
    if alignment_type == "scale_from_poses":
        return scale_from_poses(pred, batch)
    if alignment_type == "per_frame_scale_from_poses":
        return per_frame_scale_from_poses(pred, batch)
    if alignment_type == "scale_from_depths":
        if "depth" not in pred:
            raise ValueError("scale_from_depths needs the depth head enabled")
        return scale_from_depths(pred, batch)
    if alignment_type == "sim3_from_poses":
        return sim3_from_poses(pred, batch, seq_width, image_size_hw)
    if alignment_type == "sim3_from_points":
        if "world_points" not in pred:
            raise ValueError("sim3_from_points needs the point head enabled")
        return sim3_from_points(pred, batch, seq_width, image_size_hw)
    raise ValueError(f"unknown alignment type: {alignment_type!r}")
