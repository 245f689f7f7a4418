"""Multi-task training loss with per-loss warmup (port of
vitslam_tpu/train/losses.py): a weighted sum of the absolute camera pose
loss, the relative pose loss (consecutive frames plus one random large
offset in [S/2, S)), the confidence-weighted log-depth loss with an
optional quantile filter, and the per-frame / per-chunk regularisers that
pull the alignment outputs toward identity.

Everything is static-shape as in the reference: the valid-frame and
<100-point gates are multiplications, masked means replace boolean
indexing, the quantile filter takes the nearest order statistic at index
round(q * (n_valid - 1)), and the large offset gathers with a validity mask.
The large offset is drawn from the ``torch.Generator`` the caller passes, or
given as ``large_offset`` in the relative-pose config.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..geometry import (
    extri_intri_to_pose_encoding,
    mat_to_quat,
    pad_to_4x4,
    pose_encoding_to_extri_intri,
)
from ..slam.chunking import check_and_fix_inf_nan


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).float()


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return (x * m).sum() / m.sum().clamp_min(1.0)


def _masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile of x over mask == 1 (invalid entries sort last as +inf): the
    order statistic at 0-based index round(q * (n_valid - 1)), the nearest
    rank of the reference's kthvalue-based quantile."""
    flat = torch.where(mask.bool().reshape(-1), x.reshape(-1),
                       torch.full_like(x.reshape(-1), math.inf))
    order = torch.sort(flat).values
    n_valid = mask.sum().to(torch.int64)
    idx = torch.round(q * (n_valid - 1).float()).to(torch.int64).clamp(0, flat.shape[0] - 1)
    return order[idx]


def _quantile_filter_mask(loss: torch.Tensor, mask: torch.Tensor, valid_range: float,
                          min_elements: int = 1000, hard_max: float = 100.0):
    """Clamp elements at hard_max and drop those at or above the
    ``valid_range`` quantile, but only when more than ``min_elements`` are
    valid before and after filtering. Returns (clamped loss, mask)."""
    n_valid = mask.sum()
    clamped = loss.clamp(max=hard_max)
    thresh = _masked_quantile(clamped, mask, valid_range).clamp(max=hard_max)
    strict = mask * (clamped < thresh).float()
    apply = (n_valid > min_elements) & (strict.sum() > min_elements)
    out_mask = torch.where(apply, strict, mask)
    out_loss = torch.where(n_valid > min_elements, clamped, loss)
    return out_loss, out_mask


def compute_warmup_weight(cfg: dict, current_step, total_steps: int,
                          warmup_exp: float = 2.0) -> float:
    """The scheduled weight of one loss at ``current_step`` (a Python number
    or a 0-d tensor): from warmup_start_weight at warmup_start_percent of
    total_steps to ``weight`` over warmup_percent of them, linear or
    ``exp`` (frac ** warmup_exp); 0 before the start."""
    end_weight = cfg["weight"]
    warmup_steps = math.floor(total_steps * cfg.get("warmup_percent", 0.0))
    start_step = math.floor(total_steps * cfg.get("warmup_start_percent", 0.0))
    start_weight = cfg.get("warmup_start_weight", 0.0)
    warmup_type = cfg.get("warmup_type", "exp")
    if warmup_steps <= 0:
        return float(end_weight)
    step = float(current_step)
    frac = min(max((step - start_step) / float(warmup_steps), 0.0), 1.0)
    if warmup_type == "exp":
        factor = frac ** warmup_exp
    elif warmup_type == "linear":
        factor = frac
    else:
        raise ValueError(f"invalid warmup type {warmup_type!r}")
    if step < start_step:
        return 0.0
    if step > start_step + warmup_steps:
        return float(end_weight)
    return start_weight + (end_weight - start_weight) * factor


def _valid_frame_gate(batch: dict, device) -> torch.Tensor:
    """1.0 when any frame of batch element 0 has more than 100 valid points."""
    pm = _t(batch["point_masks"], device)
    return ((pm[:, 0].sum(dim=(-1, -2)) > 100).sum() > 0).float()


def camera_pose_loss(pred: dict, batch: dict, loss_type: str = "l1", **_):
    pe = pred["pose_enc"].float()
    dev = pe.device
    image_hw = tuple(batch["images"].shape[-2:])
    gt_pe = extri_intri_to_pose_encoding(_t(batch["extrinsics"], dev),
                                         _t(batch["intrinsics"], dev), image_hw)
    gate = _valid_frame_gate(batch, dev)
    if loss_type == "l1":
        loss_t = (pe[..., :3] - gt_pe[..., :3]).abs()
        loss_r = (pe[..., 3:7] - gt_pe[..., 3:7]).abs()
    elif loss_type == "l2":
        loss_t = torch.linalg.vector_norm(pe[..., :3] - gt_pe[..., :3], dim=-1)
        loss_r = torch.linalg.vector_norm(pe[..., 3:7] - gt_pe[..., 3:7], dim=-1)
    else:
        raise ValueError(f"unknown loss type {loss_type!r}")
    loss_t = check_and_fix_inf_nan(loss_t).clamp(max=100.0).mean() * gate
    loss_r = check_and_fix_inf_nan(loss_r).mean() * gate
    return {"loss_camera": loss_t + loss_r, "loss_T": loss_t, "loss_R": loss_r}


def _relative_poses_masked(extr4: torch.Tensor, offset: int):
    """rel_i = w2c[min(i + offset, S - 1)] @ c2w[i], valid where i + offset < S."""
    S = extr4.shape[1]
    idx = torch.arange(S, device=extr4.device)
    j = (idx + offset).clamp(0, S - 1)
    return extr4[:, j] @ torch.linalg.inv(extr4), (idx + offset) < S


def relative_pose_loss(pred: dict, batch: dict, generator: Optional[torch.Generator] = None,
                       loss_type: str = "l1", weight_trans: float = 1.0,
                       weight_rot: float = 1.0, scale_agnostic: bool = False,
                       large_offset=None, **_):
    pe = pred["pose_enc"].float()
    dev = pe.device
    pred_extr, _ = pose_encoding_to_extri_intri(pe, (1, 1), build_intrinsics=False)
    pred4 = pad_to_4x4(pred_extr)
    gt4 = pad_to_4x4(_t(batch["extrinsics"], dev))
    S = gt4.shape[1]
    gate = _valid_frame_gate(batch, dev)
    if large_offset is None:
        hi = max(S // 2 + 1, S)
        large = int(torch.randint(S // 2, hi, (), generator=generator,
                                  device=generator.device if generator is not None else "cpu"))
    else:
        large = int(large_offset)
    losses_t, losses_r, masks = [], [], []
    for off in (1, large):
        gt_rel, valid = _relative_poses_masked(gt4, off)
        pr_rel, _ = _relative_poses_masked(pred4, off)
        gt_q = mat_to_quat(gt_rel[..., :3, :3])
        pr_q = mat_to_quat(pr_rel[..., :3, :3])
        gt_t = gt_rel[..., :3, 3]
        pr_t = pr_rel[..., :3, 3]
        if scale_agnostic:
            gt_t = gt_t / torch.linalg.vector_norm(gt_t, dim=-1, keepdim=True).clamp_min(1e-8)
            pr_t = pr_t / torch.linalg.vector_norm(pr_t, dim=-1, keepdim=True).clamp_min(1e-8)
        if loss_type == "l1":
            lt = (pr_t - gt_t).abs().mean(-1)
            lr = (pr_q - gt_q).abs().mean(-1)
        else:
            lt = torch.linalg.vector_norm(pr_t - gt_t, dim=-1)
            lr = torch.linalg.vector_norm(pr_q - gt_q, dim=-1)
        losses_t.append(check_and_fix_inf_nan(lt).clamp(max=100.0))
        losses_r.append(check_and_fix_inf_nan(lr))
        masks.append(valid[None].expand(lt.shape))
    mask = torch.cat(masks, 1)
    lt = _masked_mean(torch.cat(losses_t, 1), mask) * gate
    lr = _masked_mean(torch.cat(losses_r, 1), mask) * gate
    return {"loss_camera_rel": weight_trans * lt + weight_rot * lr,
            "loss_T_rel": lt, "loss_R_rel": lr}


def depth_loss(pred: dict, batch: dict, valid_range: float = -1.0, **_):
    d_pred = pred["depth"].float()[..., 0]
    dev = d_pred.device
    conf = pred["depth_conf"].float()
    d_gt = check_and_fix_inf_nan(_t(batch["depths"], dev))
    mask = _t(batch["point_masks"], dev)
    gate = (mask.sum() >= 100).float()
    conf = conf / conf.amax(dim=(2, 3), keepdim=True).clamp_min(1e-8)
    loss = (torch.log(d_pred.clamp_min(1e-8)) - torch.log(d_gt.clamp_min(1e-8))).abs() * conf
    if valid_range > 0:
        loss, mask = _quantile_filter_mask(loss, mask, valid_range)
    loss = check_and_fix_inf_nan(loss)
    return {"loss_depth": _masked_mean(loss, mask) * gate}


def _identity_terms(enc: torch.Tensor):
    t = enc[..., :3]
    q = enc[..., 3:7]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-8)
    loss_t = check_and_fix_inf_nan(torch.linalg.vector_norm(t, dim=-1))
    loss_r = check_and_fix_inf_nan((1.0 - q[..., -1] ** 2).abs())
    return loss_t.clamp(max=100.0).mean() + loss_r.mean()


def per_frame_regularization_loss(pred: dict, **_):
    return {"loss_per_frame_reg": _identity_terms(pred["frame_se3_enc"].float().reshape(-1, 7))}


def per_chunk_regularization_loss(pred: dict, **_):
    enc = pred["chunk_sim3_enc"].float()
    loss = _identity_terms(enc)
    if enc.shape[-1] == 8:
        loss = loss + check_and_fix_inf_nan(torch.log(enc[..., 7].clamp_min(1e-6)) ** 2).mean()
    return {"loss_per_chunk_reg": loss}


class MultitaskLoss:
    """Callable (predictions, batch, step, generator) -> loss dict with
    'objective'; the configuration dicts mirror the reference YAML keys."""

    def __init__(self, perFrameReg=None, perChunkReg=None, depth=None,
                 cameraPose=None, cameraPoseRel=None, total_steps: int = 1, **_):
        self.perFrameReg = perFrameReg
        self.perChunkReg = perChunkReg
        self.depth = depth
        self.cameraPose = cameraPose
        self.cameraPoseRel = cameraPoseRel
        self.total_steps = total_steps

    def setup_scheduling(self, total_steps: int):
        self.total_steps = total_steps

    def __call__(self, predictions: dict, batch: dict, current_step,
                 generator: Optional[torch.Generator] = None) -> dict:
        out: dict = {}
        total = None

        def add(d: dict, key: str, cfg: dict):
            nonlocal total
            term = d[key] * compute_warmup_weight(cfg, current_step, self.total_steps)
            total = term if total is None else total + term
            out.update(d)

        if "frame_se3_enc" in predictions and self.perFrameReg is not None:
            add(per_frame_regularization_loss(predictions), "loss_per_frame_reg",
                self.perFrameReg)
        if "chunk_sim3_enc" in predictions and self.perChunkReg is not None:
            add(per_chunk_regularization_loss(predictions), "loss_per_chunk_reg",
                self.perChunkReg)
        if "depth" in predictions and self.depth is not None:
            add(depth_loss(predictions, batch, **self.depth), "loss_depth", self.depth)
        if "pose_enc" in predictions and self.cameraPose is not None:
            add(camera_pose_loss(predictions, batch, **self.cameraPose), "loss_camera",
                self.cameraPose)
        if "pose_enc" in predictions and self.cameraPoseRel is not None:
            add(relative_pose_loss(predictions, batch, generator, **self.cameraPoseRel),
                "loss_camera_rel", self.cameraPoseRel)
        if total is None:
            dev = next(iter(predictions.values())).device
            total = torch.zeros((), dtype=torch.float32, device=dev)
        out["objective"] = total
        return out
