"""Trajectory metrics: ATE, RPE, scale consistency (port of
vitslam_tpu/eval/trajectory.py).

The errors are computed in fp32 torch on the device the poses lie on; the
metric states accumulate numpy arrays on the host and, in a run of several
processes, are gathered before ``compute`` (the ``gather_fn`` hook, which
``eval.Metrics`` sets in a gang).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..geometry import rotation_angle


def _median(x: np.ndarray) -> float:
    """torch.median semantics: the lower of the two middle values on an even
    count (np.median would average them)."""
    return float(np.sort(np.ravel(x))[(x.size - 1) // 2])


def _t(x, device=None) -> torch.Tensor:
    """x as an fp32 tensor on ``device`` (default: where a tensor lies; a
    numpy array is copied to the CPU)."""
    t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
    return t.float().to(device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Metric:
    """Numpy list states on the host + an optional cross-process gather at
    compute time."""

    def __init__(self, gather_fn: Optional[Callable] = None):
        self._gather = gather_fn
        self.reset()

    def reset(self):
        raise NotImplementedError

    def _cat(self, xs: list) -> np.ndarray:
        if not xs:
            return np.zeros((0,), np.float32)
        x = np.concatenate([v.reshape(len(v), -1) if v.ndim > 1 else v for v in xs], axis=0)
        if self._gather is not None:
            x = self._gather(x)
        return x


def ate_errors(pred: torch.Tensor, target: torch.Tensor):
    """pred/target (N, 4, 4) c2w -> (translation error (N,), per-dim (N, 3))."""
    delta = pred[:, :3, 3] - target[:, :3, 3]
    return torch.linalg.vector_norm(delta, dim=-1), delta


def rpe_errors(pred: torch.Tensor, target: torch.Tensor, delta: int = 1):
    """Relative pose errors at frame offset ``delta``: err = inv(gt_rel) @
    pred_rel; translation norm and geodesic angle (radians)."""
    pred_rel = torch.linalg.inv(pred[:-delta]) @ pred[delta:]
    gt_rel = torch.linalg.inv(target[:-delta]) @ target[delta:]
    err = torch.linalg.inv(gt_rel) @ pred_rel
    return torch.linalg.vector_norm(err[:, :3, 3], dim=-1), rotation_angle(err[:, :3, :3])


def scale_factors(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-frame LSE scale factors (the first frame, at zero translation,
    omitted)."""
    p = pred[1:, :3, 3]
    g = target[1:, :3, 3]
    return (g * p).sum(-1) / (p * p).sum(-1).clamp_min(1e-8)


class AbsoluteTrajectoryError(Metric):
    """RMSE of positional deltas; optional detailed stats and per-dim RMSE."""

    def __init__(self, detailed: bool = False, **kw):
        self.detailed = detailed
        super().__init__(**kw)

    def reset(self):
        self.errors: list = []
        self.per_dim: list = []

    def update(self, preds, target):
        e, pd = ate_errors(_t(preds), _t(target))
        self.errors.append(_np(e))
        self.per_dim.append(_np(pd))

    def compute(self) -> dict:
        e = self._cat(self.errors)
        pd = self._cat(self.per_dim).reshape(-1, 3)
        out = {"ate_rmse": float(np.sqrt(np.mean(e ** 2))) if e.size else 0.0}
        if self.detailed and e.size:
            out.update(
                ate_mean=float(e.mean()), ate_median=_median(e),
                ate_std=float(e.std(ddof=1)) if e.size > 1 else 0.0,
                ate_min=float(e.min()), ate_max=float(e.max()),
                ate_rmse_per_dim=np.sqrt((pd ** 2).mean(axis=0)).tolist())
        return out

    def plot(self, preds, target, title=None, outpath=None):
        e, pd = ate_errors(_t(preds), _t(target))
        rmse = float(torch.sqrt((e ** 2).mean()))
        path = None
        if outpath:
            from ..viz.plots import plot_ate

            per_dim = np.sqrt((_np(pd) ** 2).mean(axis=0))
            path = plot_ate(_np(preds)[:, :3, 3], _np(target)[:, :3, 3], rmse, per_dim,
                            title, outpath)
        return {"ate_rmse": rmse}, path


class RelativePoseError(Metric):
    """RMSE of relative-pose translation (m) and rotation (deg) at offset
    ``delta``."""

    def __init__(self, delta: int = 1, detailed: bool = False, **kw):
        self.delta = delta
        self.detailed = detailed
        super().__init__(**kw)

    def reset(self):
        self.trans: list = []
        self.rot: list = []

    def update(self, preds, target):
        if preds.shape[0] <= self.delta:
            return
        t, r = rpe_errors(_t(preds), _t(target), self.delta)
        self.trans.append(_np(t))
        self.rot.append(_np(r))

    def compute(self) -> dict:
        t = self._cat(self.trans)
        r = self._cat(self.rot)
        out = {
            "rpe_trans_rmse": float(np.sqrt(np.mean(t ** 2))) if t.size else 0.0,
            "rpe_rot_rmse": float(np.degrees(np.sqrt(np.mean(r ** 2)))) if r.size else 0.0,
        }
        if self.detailed and t.size:
            out.update(
                rpe_trans_mean=float(t.mean()), rpe_trans_median=_median(t),
                rpe_trans_std=float(t.std(ddof=1)) if t.size > 1 else 0.0,
                rpe_trans_min=float(t.min()), rpe_trans_max=float(t.max()),
                rpe_rot_mean=float(np.degrees(r.mean())),
                rpe_rot_median=float(np.degrees(_median(r))),
                rpe_rot_std=float(np.degrees(r.std(ddof=1))) if r.size > 1 else 0.0,
                rpe_rot_min=float(np.degrees(r.min())),
                rpe_rot_max=float(np.degrees(r.max())))
        return out

    def plot(self, preds, target, title=None, outpath=None):
        t, r = rpe_errors(_t(preds), _t(target), self.delta)
        t, r = _np(t), _np(r)
        trans_rmse = float(np.sqrt((t ** 2).mean()))
        rot_rmse = float(np.degrees(np.sqrt((r ** 2).mean())))
        path = None
        if outpath:
            from ..viz.plots import plot_rpe

            path = plot_rpe(t, np.degrees(r), trans_rmse, rot_rmse, title, outpath)
        return {"rpe_trans_rmse": trans_rmse, "rpe_rot_rmse": rot_rmse}, path


class ScaleConsistency(Metric):
    """Mean (over trajectories) variance of the per-frame LSE scale factors."""

    def reset(self):
        self.var_sum = 0.0
        self.count = 0

    def update(self, preds, target):
        self.var_sum += float(_np(scale_factors(_t(preds), _t(target))).var())
        self.count += 1

    def compute(self) -> dict:
        return {"scale_var": self.var_sum / self.count if self.count else 0.0}

    def plot(self, preds, target, title=None, outpath=None):
        sf = _np(scale_factors(_t(preds), _t(target)))
        var = float(sf.var())
        path = None
        if outpath:
            from ..viz.plots import plot_scale_consistency

            path = plot_scale_consistency(sf, var, title, outpath)
        return {"scale_var": var}, path
