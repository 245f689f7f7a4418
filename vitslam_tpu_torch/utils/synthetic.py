"""A geometrically consistent synthetic GT batch (the port's copy of
vitslam_tpu/utils/testing.py::make_synthetic_batch, which the CPU tests and
chip_smoke.py use in place of a dataset)."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.projection import unproject_depth_to_points


def make_synthetic_batch(B=1, N=8, H=28, W=42, seed=0, f=30.0) -> dict:
    """Numpy arrays shaped like the dataset output: a camera translating
    along +z with a slight yaw through a random-depth scene; images
    (B, N, 3, H, W) in [0, 1], w2c extrinsics (B, N, 3, 4), intrinsics
    (B, N, 3, 3), depths, world points and point masks. The same seed gives
    the same arrays as the JAX package's helper."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, size=(B, N, 3, H, W)).astype(np.float32)
    extr = np.zeros((B, N, 3, 4), np.float32)
    for s in range(N):
        a = 0.02 * s
        extr[:, s, :3, :3] = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
        extr[:, s, :3, 3] = np.array([0.05 * s, 0.0, -0.5 * s], np.float32)
    K = np.zeros((B, N, 3, 3), np.float32)
    K[:, :, 0, 0] = f
    K[:, :, 1, 1] = f
    K[:, :, 0, 2] = W / 2
    K[:, :, 1, 2] = H / 2
    K[:, :, 2, 2] = 1.0
    depths = rng.uniform(2.0, 20.0, size=(B, N, H, W)).astype(np.float32)
    world_points = unproject_depth_to_points(torch.from_numpy(depths), torch.from_numpy(extr),
                                             torch.from_numpy(K)).numpy()
    point_masks = rng.uniform(size=(B, N, H, W)) > 0.1
    return {"images": images, "extrinsics": extr, "intrinsics": K, "depths": depths,
            "world_points": world_points, "point_masks": point_masks.astype(np.float32)}
