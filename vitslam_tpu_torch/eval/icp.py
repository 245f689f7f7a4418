"""Iterative closest point on the device (port of vitslam_tpu/eval/icp.py;
the reference replaces PyTorch3D's ``iterative_closest_point``, used to
align the predicted cloud onto GT before Chamfer, 30 iterations, rigid by
default).

A fixed iteration count, correspondences from the tiled brute-force
``ops.knn.nn_search``, and per iteration a weighted rigid Kabsch (or a
similarity Umeyama with ``estimate_scale``) from the source onto its
matches; weights of 0 mask padded points out.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.solvers import umeyama
from ..ops.knn import nn_search


class ICPResult(NamedTuple):
    transformed: torch.Tensor  # (N, 3) src after alignment
    R: torch.Tensor            # (3, 3)
    t: torch.Tensor            # (3,)
    s: torch.Tensor            # ()
    rmse: torch.Tensor         # () correspondence RMSE of the last iteration


def iterative_closest_point(src: torch.Tensor, dst: torch.Tensor,
                            src_weights: Optional[torch.Tensor] = None,
                            iterations: int = 30, estimate_scale: bool = False) -> ICPResult:
    """Align src (N, 3) onto dst (M, 3), on src's device. ``src_weights``
    (N,): 0 masks a point out; ``estimate_scale`` solves Sim(3) instead of
    SE(3)."""
    src = src.float()
    dst = dst.float().to(src.device)
    w = (torch.ones(src.shape[0], device=src.device) if src_weights is None
         else src_weights.float().to(src.device))
    R = torch.eye(3, device=src.device)
    t = torch.zeros(3, device=src.device)
    s = torch.ones((), device=src.device)
    rmse = torch.zeros((), device=src.device)
    for _ in range(iterations):
        d2, idx = nn_search(s * (src @ R.T) + t, dst)
        matched = dst[idx]
        R, t, s = (umeyama if estimate_scale else _kabsch_rigid)(src, matched, w)
        rmse = torch.sqrt((d2 * w).sum() / w.sum().clamp_min(1e-12))
    return ICPResult(s * (src @ R.T) + t, R, t, s, rmse)


def _kabsch_rigid(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Weighted rigid Kabsch: R, t minimising sum w ||y - (R x + t)||^2."""
    wn = w / w.sum().clamp_min(1e-12)
    mu_x = wn @ x
    mu_y = wn @ y
    sigma = torch.einsum("n,ni,nj->ij", wn, y - mu_y, x - mu_x)
    u, _, vh = torch.linalg.svd(sigma)
    s_diag = torch.ones(3, device=x.device)
    s_diag[-1] = torch.sign(torch.linalg.det(u) * torch.linalg.det(vh))
    R = (u * s_diag[None]) @ vh
    return R, mu_y - R @ mu_x, torch.ones((), device=x.device)
