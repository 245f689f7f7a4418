"""Brute-force nearest-neighbour search, tiled (port of
vitslam_tpu/ops/knn.py; the reference replaces PyTorch3D's ``knn_points``).

Stock torch, on whatever device the points lie on: the |p|^2 + |q|^2 - 2 p.q
expansion for norm 2, the sum of absolute differences for norm 1, over
tiles of ``tile_p`` x ``tile_q`` distances with a running min / argmin, so
the full N x M matrix is never formed (one fp32 tile of the defaults is
256 MB; the eval's ~340k x 340k points would be ~460 GB). q is padded with
+inf points, NaN and +inf distances become +inf, and squared norm-2
distances are clamped at 0.
"""
from __future__ import annotations

import torch


def nn_search(p: torch.Tensor, q: torch.Tensor, tile_p: int = 1024, tile_q: int = 65536,
              norm: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """For every point of p (N, d), the distance to and index of its nearest
    neighbour in q (M, d). Returns (dists (N,) fp32, indices (N,) int64);
    dists are squared for norm 2 (PyTorch3D's knn_points.dists)."""
    if norm not in (1, 2):
        raise ValueError(f"norm must be 1 or 2, got {norm}")
    p = p.float()
    q = q.float()
    n, m = p.shape[0], q.shape[0]
    # a tile larger than the cloud only adds +inf padding
    tile_p, tile_q = min(tile_p, max(n, 1)), min(tile_q, max(m, 1))
    m_pad = -(-m // tile_q) * tile_q
    if m_pad != m:
        q = torch.cat([q, q.new_full((m_pad - m, q.shape[1]), float("inf"))])
    q2 = (q * q).sum(-1)
    dists = torch.empty(n, dtype=torch.float32, device=p.device)
    idx = torch.empty(n, dtype=torch.int64, device=p.device)
    for i in range(0, n, tile_p):
        pt = p[i:i + tile_p]
        p2 = (pt * pt).sum(-1, keepdim=True)
        best_d = torch.full((pt.shape[0],), float("inf"), device=p.device)
        best_i = torch.zeros(pt.shape[0], dtype=torch.int64, device=p.device)
        for j in range(0, m_pad, tile_q):
            qt = q[j:j + tile_q]
            if norm == 2:  # (|p|^2 + |q|^2) - 2 p.q, the reference's order
                d = torch.add(p2, q2[j:j + tile_q][None]).addmm_(pt, qt.t(), alpha=-2.0)
            else:
                d = (pt[:, None, :] - qt[None, :, :]).abs().sum(-1)
            d = torch.nan_to_num_(d, nan=float("inf"), posinf=float("inf"))
            tile_d, tile_i = d.min(dim=1)
            take = tile_d < best_d
            best_d = torch.where(take, tile_d, best_d)
            best_i = torch.where(take, tile_i + j, best_i)
        dists[i:i + tile_p] = best_d
        idx[i:i + tile_p] = best_i
    if norm == 2:
        dists = dists.clamp_min(0.0)  # fp cancellation noise
    return dists, idx


def nn_dists(p: torch.Tensor, q: torch.Tensor, norm: int = 2) -> torch.Tensor:
    """Nearest-neighbour distances only (squared for norm 2)."""
    return nn_search(p, q, norm=norm)[0]
