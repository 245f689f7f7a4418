"""Closed-form alignment solvers in fp32 (port of
vitslam_tpu/geometry/solvers.py): Umeyama, Huber IRLS over Umeyama, Horn,
least-squares and weighted-median scale, depth-scale weights.

Every solver is batched over leading dims and static-shape: points below
the confidence threshold get weight zero instead of being removed, and the
IRLS runs its fixed iteration count with a branchless freeze, so a chunk's
alignment stays on the device with no host round trip per iteration.
"""
from __future__ import annotations

import torch


def median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim; for an even count the mean of the two
    middle order statistics (numpy's and jnp.median's rule; torch.median
    would return the lower one)."""
    s = x.sort(dim=-1).values
    n = x.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def umeyama(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor | None = None):
    """(Weighted) Umeyama Sim(m): (R, t, s) minimising
    sum_i w_i ||y_i - (s R x_i + t)||^2.

    x, y: (..., N, m) source and reference points; weights: (..., N) or None.
    Returns R (..., m, m), t (..., m), s (...,)."""
    x = x.float()
    y = y.float()
    n, m = x.shape[-2], x.shape[-1]
    if weights is None:
        w = torch.full(x.shape[:-1], 1.0 / n, dtype=torch.float32, device=x.device)
    else:
        w = weights.float()
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    mu_x = torch.einsum("...n,...nm->...m", w, x)
    mu_y = torch.einsum("...n,...nm->...m", w, y)
    xc = x - mu_x[..., None, :]
    yc = y - mu_y[..., None, :]
    # covariance E_w[(y - mu_y)(x - mu_x)^T], (m, m)
    sigma = torch.einsum("...ni,...nj->...ij", w[..., None] * yc, xc)
    var_x = torch.einsum("...n,...nm->...", w, xc * xc)
    u, d, vh = torch.linalg.svd(sigma)
    det_sign = torch.sign(torch.linalg.det(u) * torch.linalg.det(vh))
    s_diag = torch.ones(x.shape[:-2] + (m,), dtype=torch.float32, device=x.device)
    s_diag[..., -1] = det_sign
    R = torch.einsum("...ik,...k,...kj->...ij", u, s_diag, vh)
    s = (d * s_diag).sum(dim=-1) / var_x.clamp_min(1e-12)
    t = mu_y - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_x)
    return R, t, s


def huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber IRLS multiplicative weights: 1 for r <= delta, else delta / r."""
    return torch.where(r <= delta, torch.ones_like(r), delta / r.clamp_min(1e-12))


def irls_sim3_umeyama_batched(src, dst, conf_src=None, conf_dst=None,
                              conf_threshold_factor: float = 0.5, delta: float = 0.1,
                              max_iters: int = 20, tol: float = 1e-9):
    """Robust Sim(3) per batch element: src/dst (B, ...) with 3-vectors in
    the last dim, confidences (B, ...) or None. Points whose combined
    confidence sqrt(c_src * c_dst) is below ``conf_threshold_factor`` times
    its median get weight 0; then ``max_iters`` Huber reweightings, each
    element frozen once its update falls below ``tol``. Returns R (B, 3, 3),
    t (B, 3), s (B,)."""
    B = src.shape[0]
    src = src.reshape(B, -1, 3).float()
    dst = dst.reshape(B, -1, 3).float()
    if conf_src is None:
        combined = torch.ones(src.shape[:2], dtype=torch.float32, device=src.device)
    else:
        combined = torch.sqrt(conf_src.reshape(B, -1).float() * conf_dst.reshape(B, -1).float())
    thresh = conf_threshold_factor * median(combined)
    base_w = torch.where(combined >= thresh[:, None], combined, torch.zeros_like(combined))

    R, t, s = umeyama(src, dst, base_w)
    done = torch.zeros(B, dtype=torch.bool, device=src.device)
    for _ in range(max_iters):
        transformed = s[:, None, None] * (src @ R.transpose(-1, -2)) + t[:, None]
        residuals = torch.linalg.vector_norm(transformed - dst, dim=-1)
        Rn, tn, sn = umeyama(src, dst, base_w * huber_weights(residuals, delta))
        converged = ((torch.linalg.matrix_norm(Rn - R) < tol)
                     & (torch.linalg.vector_norm(tn - t, dim=-1) < tol)
                     & ((sn - s).abs() < tol))
        R = torch.where(done[:, None, None], R, Rn)
        t = torch.where(done[:, None], t, tn)
        s = torch.where(done, s, sn)
        done = done | converged
    return R, t, s


def irls_sim3_umeyama(src, dst, conf_src=None, conf_dst=None,
                      conf_threshold_factor: float = 0.5, delta: float = 0.1,
                      max_iters: int = 20, tol: float = 1e-9):
    """One robust Sim(3): src/dst reshapeable to (-1, 3), matching
    confidences or None. Returns R (3, 3), t (3,), s ()."""
    R, t, s = irls_sim3_umeyama_batched(
        src.reshape(1, -1, 3), dst.reshape(1, -1, 3),
        None if conf_src is None else conf_src.reshape(1, -1),
        None if conf_dst is None else conf_dst.reshape(1, -1),
        conf_threshold_factor, delta, max_iters, tol)
    return R[0], t[0], s[0]


def method_of_horn(model: torch.Tensor, data: torch.Tensor, align_scale: bool = True):
    """Horn's closed-form trajectory alignment: model, data (N, 3); returns
    R (3, 3), t (3,), s () with aligned = s * R @ model + t."""
    model = model.float()
    data = data.float()
    mu_m = model.mean(dim=0)
    mu_d = data.mean(dim=0)
    mzc = model - mu_m
    dzc = data - mu_d
    u, _, vh = torch.linalg.svd((mzc.T @ dzc).T)
    s_diag = torch.ones(3, dtype=torch.float32, device=model.device)
    s_diag[-1] = torch.sign(torch.linalg.det(u) * torch.linalg.det(vh))
    R = (u * s_diag[None, :]) @ vh
    if align_scale:
        s = (dzc * (mzc @ R.T)).sum() / (mzc * mzc).sum().clamp_min(1e-12)
    else:
        s = torch.ones((), dtype=torch.float32, device=model.device)
    t = mu_d - s * (R @ mu_m)
    return R, t, s


def scale_lse_solver(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Least-squares scale |sum(x*y) / sum(x^2)| over all elements."""
    x = x.float()
    y = y.float()
    return ((x * y).sum() / (x * x).sum().clamp_min(1e-12)).abs()


def weighted_median_scale(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """L1-optimal scale argmin_a sum_i w_i |a x_i - y_i| over the last dim:
    the weighted median of the ratios y_i / x_i with weights w_i |x_i|.
    x, y, weights: (..., N). Returns (...,) positive scales."""
    x = x.float()
    y = y.float()
    w = weights.float()
    sign = torch.where(torch.sign(x) == 0, torch.ones_like(x), torch.sign(x))
    x_pos = x * sign
    r = (y * sign) / x_pos.clamp_min(1e-6)
    order = torch.argsort(r, dim=-1)
    r_sorted = torch.take_along_dim(r, order, dim=-1)
    # the running sum on the host: CUDA's fp32 cumsum is a parallel scan
    # whose partial sums meet in an order that changes from run to run, and
    # its last bits move the median's index (and the scale) between runs
    cumsum = torch.cumsum(torch.take_along_dim(w * x_pos, order, dim=-1).cpu(), dim=-1)
    target = 0.5 * cumsum[..., -1:]
    # first index where cumsum >= target (searchsorted 'left')
    idx = (cumsum < target).sum(dim=-1, keepdim=True).clamp(0, x.shape[-1] - 1).to(r.device)
    scales = torch.take_along_dim(r_sorted, idx, dim=-1)[..., 0]
    return torch.where(scales <= 0, -scales, scales)


def depth_scale_weights(d_gt: torch.Tensor, mask: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    """mask * confidence / GT depth, with GT depth clamped from below at 0.1x
    its masked mean; all (..., N)."""
    m = mask.float()
    mean_depth = (d_gt * m).sum(dim=-1, keepdim=True) / m.sum(dim=-1, keepdim=True).clamp_min(1.0)
    y_clamped = torch.maximum(d_gt, 0.1 * mean_depth)
    return m * conf * (1.0 / y_clamped.clamp_min(1e-6))
