"""Metric data preparation (port of vitslam_tpu/eval/prepare.py): pose
encodings -> c2w matrices, the prediction mask at a confidence quantile,
image-space subsampling for ICP, and the pred -> GT ICP alignment.

Points prefer unprojected depths over point maps; the prediction mask keeps
confidences above the ``"nearest"`` quantile (the kth value at
round(q (n - 1)), the reference's torch_quantile, not interpolation); the
GT mask is subsampled by the smallest integer stride (exponential, then
binary search) whose bilinear (align_corners=False, no antialias) resize
keeps <= ``max_points_icp`` points, thresholded at 0.5. Everything runs in
torch on ``device``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..geometry import (
    closed_form_inverse_se3,
    pose_encoding_to_extri,
    pose_encoding_to_extri_intri,
    unproject_depth_to_points,
)
from .icp import iterative_closest_point
from .trajectory import _t


def _resize_bshw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of (B, S, H, W, C) over H and W, align_corners=False
    and no antialias (the reference's F.interpolate, which does not low-pass
    when it downsamples; jax.image.resize 'linear' with antialias=False)."""
    b, s, H, W, c = x.shape
    y = F.interpolate(x.float().reshape(b * s, H, W, c).permute(0, 3, 1, 2), size=(h, w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(b, s, h, w, c)


def find_subsample_factor(gt_mask: torch.Tensor, max_points: int) -> int:
    """The smallest integer stride whose bilinearly downsampled GT mask
    (B, S, H, W) keeps <= max_points valid points (exponential, then binary
    search)."""
    B, S, H, W = gt_mask.shape
    m = gt_mask.reshape(B, S, H, W, 1).float()

    def count(factor: int) -> int:
        return int((_resize_bshw(m, max(1, H // factor), max(1, W // factor)) > 0.5).sum())

    valid = int(gt_mask.sum())
    if valid <= max_points:
        return 1
    factor = max(1, math.ceil(math.sqrt(valid / max_points)))
    last = 0
    while valid > max_points:
        if last > 0:
            last = factor
            factor *= 2
        else:
            last = factor
        if factor > max(H, W):
            break
        valid = count(factor)
    if last != factor:
        while last + 1 < factor:
            mid = (last + factor) // 2
            if count(mid) <= max_points:
                factor = mid
            else:
                last = mid
    return factor


def prepare_poses(pred_dict: dict, gt_dict: dict, image_size_hw: tuple[int, int], device=None):
    """Pose encodings (9-d or 7-d) -> (pred c2w, gt c2w, pred w2c, pred K)."""
    pe = _t(pred_dict["pose_enc"], device)
    if pe.shape[-1] == 9:
        pred_extr, pred_intr = pose_encoding_to_extri_intri(pe, image_size_hw)
    elif pe.shape[-1] == 7:
        pred_extr = pose_encoding_to_extri(pe)[..., :3, :4]
        pred_intr = _t(gt_dict["intrinsics"], pe.device)
    else:
        raise ValueError(f"unknown pose encoding width {pe.shape[-1]}")
    gt_extr = _t(gt_dict["extrinsics"], pe.device)
    return closed_form_inverse_se3(pred_extr), closed_form_inverse_se3(gt_extr), pred_extr, \
        pred_intr


def _nearest_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.quantile(x, q, method='nearest') over all of x."""
    flat = x.reshape(-1)
    return flat.kthvalue(round(q * (flat.numel() - 1)) + 1).values


def prepare_data_for_metrics(pred_dict: dict, gt_dict: dict, valid_point_quantile: float = 0.25,
                             max_points_icp: Optional[int] = None, want_points: bool = True,
                             want_poses: bool = True, icp_iterations: int = 30, device=None):
    """Returns (pred_poses (B, S, 4, 4), gt_poses, pred_points [(Ni, 3)],
    gt_points [(Mi, 3)]), the points ICP-aligned pred -> GT, all tensors on
    ``device`` (default: where the predicted pose encodings lie)."""
    if device is None:
        device = _t(pred_dict["pose_enc"]).device
    pred_poses = gt_poses = pred_extr = pred_intr = None
    size_key = "images" if "images" in gt_dict else "depths"
    if want_poses:
        image_size_hw = tuple(gt_dict[size_key].shape[-2:])
        pred_poses, gt_poses, pred_extr, pred_intr = prepare_poses(pred_dict, gt_dict,
                                                                   image_size_hw, device)
    if not want_points:
        return pred_poses, gt_poses, None, None

    put = lambda k, d: _t(d[k], device)  # noqa: E731
    if "depth" in pred_dict and pred_extr is not None:
        pred_points = unproject_depth_to_points(put("depth", pred_dict), pred_extr, pred_intr)
        conf = put("depth_conf", pred_dict)
    else:
        pred_points = put("world_points", pred_dict)
        conf = put("world_points_conf", pred_dict)
    pred_mask = conf > _nearest_quantile(conf, valid_point_quantile)
    gt_points = put("world_points", gt_dict)
    gt_mask = put("point_masks", gt_dict) > 0.5
    B, S, H, W = gt_mask.shape

    if max_points_icp and int(gt_mask.sum()) > max_points_icp:
        f = find_subsample_factor(gt_mask, max_points_icp)
        h, w = max(1, H // f), max(1, W // f)
        pred_points = _resize_bshw(pred_points, h, w)
        gt_points = _resize_bshw(gt_points, h, w)
        pred_mask = _resize_bshw(pred_mask[..., None].float(), h, w)[..., 0] > 0.5
        gt_mask = _resize_bshw(gt_mask[..., None].float(), h, w)[..., 0] > 0.5

    pred_list, gt_list = [], []
    for b in range(B):
        p = pred_points[b][pred_mask[b] & gt_mask[b]]
        g = gt_points[b][gt_mask[b]]
        if len(p) >= 3 and len(g) >= 3:
            p = iterative_closest_point(p, g, iterations=icp_iterations).transformed
        pred_list.append(p)
        gt_list.append(g)
    return pred_poses, gt_poses, pred_list, gt_list
