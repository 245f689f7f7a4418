"""Reconstruction metrics: Chamfer distance, accuracy and completion (port
of vitslam_tpu/eval/reconstruction.py): bidirectional nearest-neighbour
distances (squared for norm 2, as PyTorch3D's knn returns them) from the
tiled ``ops.knn`` search on the points' device, an optional ``max_dist``
clamp, the RMSE (sqrt of the mean of the squared values) or mean variants,
chamfer = (accuracy + completion) / 2.
"""
from __future__ import annotations

import numpy as np

from ..ops.knn import nn_dists
from .trajectory import Metric, _np, _t


class ChamferDistanceMetrics(Metric):
    def __init__(self, norm: int = 2, max_dist: float | None = None, rmse: bool = True, **kw):
        self.norm = norm
        self.max_dist = max_dist
        self.rmse = rmse
        super().__init__(**kw)

    def reset(self):
        self.pred_to_gt: list = []
        self.gt_to_pred: list = []

    def _dists(self, preds, target):
        p = _t(preds)
        g = _t(target, p.device)
        d_pg = nn_dists(p, g, norm=self.norm)
        d_gp = nn_dists(g, p, norm=self.norm)
        if self.max_dist is not None:
            d_pg = d_pg.clamp_max(self.max_dist)
            d_gp = d_gp.clamp_max(self.max_dist)
        return _np(d_pg), _np(d_gp)

    def _result(self, pg: np.ndarray, gp: np.ndarray) -> dict:
        if self.rmse:
            acc = float(np.sqrt((pg ** 2).mean())) if pg.size else 0.0
            comp = float(np.sqrt((gp ** 2).mean())) if gp.size else 0.0
            return {"chamfer_distance_rmse": 0.5 * acc + 0.5 * comp,
                    "accuracy_rmse": acc, "completion_rmse": comp}
        acc = float(pg.mean()) if pg.size else 0.0
        comp = float(gp.mean()) if gp.size else 0.0
        return {"chamfer_distance": 0.5 * acc + 0.5 * comp, "accuracy": acc,
                "completion": comp}

    def update(self, preds, target):
        """preds (Np, 3), target (Ng, 3) point clouds."""
        d_pg, d_gp = self._dists(preds, target)
        self.pred_to_gt.append(d_pg)
        self.gt_to_pred.append(d_gp)

    def compute(self) -> dict:
        return self._result(self._cat(self.pred_to_gt), self._cat(self.gt_to_pred))

    def plot(self, preds, target, title=None, outpath=None):
        d_pg, d_gp = self._dists(preds, target)
        res = self._result(d_pg, d_gp)
        path = None
        if outpath:
            from ..viz.plots import plot_chamfer_hist

            path = plot_chamfer_hist(d_pg, d_gp, res, title, outpath)
        return res, path
