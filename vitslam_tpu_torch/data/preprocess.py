"""Host-side image/depth preprocessing (port of
vitslam_tpu/data/preprocess.py): resize/crop to a patch-multiple target
shape, rescale intrinsics, derive camera/world points and the validity mask
from the depth map.

All of it runs on the host in numpy (and OpenCV, imported inside the
functions that read or resize, so the package imports without it); images
come out as float32 (3, H, W) in [0, 1].
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def read_image_cv2(path: str) -> np.ndarray:
    """BGR imread -> RGB uint8 (H, W, 3)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def threshold_depth_map(
    depth: np.ndarray,
    max_depth: float = -1,
    min_depth: float = -1,
    max_percentile: float = -1,
    min_percentile: float = -1,
) -> np.ndarray:
    """Zero out depths outside absolute/percentile bounds (invalid = 0)."""
    depth = depth.astype(np.float32).copy()
    depth[~np.isfinite(depth)] = 0.0
    valid = depth > 0
    if max_percentile > 0 and valid.any():
        depth[depth > np.percentile(depth[valid], max_percentile)] = 0.0
    if min_percentile > 0 and valid.any():
        depth[depth < np.percentile(depth[valid], min_percentile)] = 0.0
    if max_depth > 0:
        depth[depth > max_depth] = 0.0
    if min_depth > 0:
        depth[depth < min_depth] = 0.0
    return depth


def round_to_multiple(x: float, m: int) -> int:
    return max(m, int(round(x / m)) * m)


def get_target_shape(aspect_ratio: float, img_size: int = 518,
                     patch_size: int = 14) -> np.ndarray:
    """Target (H, W): width pinned to img_size, height from the aspect
    ratio rounded to a patch multiple.

    Convention: aspect = H / W (VGGT's landscape convention — its training
    aspects span ~0.33..1.0 and every reference test config pins
    ``fix_aspect_ratio: 0.3`` ~= VKITTI's native 375/1242, i.e. 518x154 —
    test_featureAlignedVGGT_vkitti.yaml:28)."""
    h = round_to_multiple(img_size * aspect_ratio, patch_size)
    return np.array([h, img_size], dtype=np.int64)


def resize_crop_image(
    image: np.ndarray,
    depth: Optional[np.ndarray],
    intrinsics: np.ndarray,
    target_hw: np.ndarray,
):
    """Resize so width matches, then center-crop/pad height; rescale K.

    Args:
        image: (H, W, 3) uint8/float.
        depth: (H, W) or None.
        intrinsics: (3, 3).
    Returns:
        (image (h, w, 3), depth (h, w) or None, K (3, 3)).
    """
    import cv2

    th, tw = int(target_hw[0]), int(target_hw[1])
    h0, w0 = image.shape[:2]
    scale = tw / w0
    rh = max(1, int(round(h0 * scale)))
    image = cv2.resize(image, (tw, rh), interpolation=cv2.INTER_LINEAR)
    if depth is not None:
        depth = cv2.resize(depth, (tw, rh), interpolation=cv2.INTER_NEAREST)

    K = intrinsics.astype(np.float64).copy()
    K[0] *= scale
    K[1] *= scale

    if rh >= th:  # center crop
        top = (rh - th) // 2
        image = image[top: top + th]
        if depth is not None:
            depth = depth[top: top + th]
        K[1, 2] -= top
    else:  # pad bottom/top evenly with zeros (invalid depth)
        top = (th - rh) // 2
        pad_img = np.zeros((th, tw, 3), dtype=image.dtype)
        pad_img[top: top + rh] = image
        image = pad_img
        if depth is not None:
            pad_d = np.zeros((th, tw), dtype=depth.dtype)
            pad_d[top: top + rh] = depth
            depth = pad_d
        K[1, 2] += top
    return image, depth, K


def depth_to_points(depth: np.ndarray, extrinsics: np.ndarray,
                    intrinsics: np.ndarray):
    """Depth (H, W) + w2c (3, 4) + K -> (world (H,W,3), cam (H,W,3),
    mask (H,W)): the native C++ kernel when its route is on
    (``vitslam_tpu_torch.native``), numpy otherwise, as the reference."""
    from ..native import depth_to_points_native

    native = depth_to_points_native(depth.astype(np.float32), extrinsics, intrinsics)
    if native is not None:
        return native
    h, w = depth.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3).astype(np.float64)
    rays = pix @ np.linalg.inv(intrinsics).T
    cam = rays * depth.reshape(-1, 1)
    R = extrinsics[:3, :3]
    t = extrinsics[:3, 3]
    # c2w: x_w = R^T (x_c - t)
    world = (cam - t) @ R
    mask = (depth > 0) & np.isfinite(depth)
    return (
        world.reshape(h, w, 3).astype(np.float32),
        cam.reshape(h, w, 3).astype(np.float32),
        mask,
    )


def process_one_image(
    image: np.ndarray,
    depth: Optional[np.ndarray],
    extri_opencv: np.ndarray,
    intri_opencv: np.ndarray,
    original_size: np.ndarray,
    target_image_shape: np.ndarray,
    filepath: str = "",
):
    """Full per-frame pipeline (vggt BaseDataset.process_one_image parity):
    resize/crop to the patch-multiple target, fix K, depth -> cam & world
    points + validity mask.

    Returns (image (3,h,w) float32 [0,1], depth (h,w), extri (3,4),
    intri (3,3), world_points (h,w,3), cam_points (h,w,3), mask (h,w),
    filepath)."""
    image, depth, K = resize_crop_image(image, depth, intri_opencv,
                                        target_image_shape)
    img = image.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    img = np.transpose(img, (2, 0, 1))
    extri = extri_opencv[:3, :4].astype(np.float32)
    if depth is None:
        h, w = img.shape[1:]
        depth = np.ones((h, w), np.float32)
        world = np.zeros((h, w, 3), np.float32)
        cam = np.zeros((h, w, 3), np.float32)
        mask = np.zeros((h, w), bool)
    else:
        world, cam, mask = depth_to_points(depth, extri, K)
    return (img, depth.astype(np.float32), extri, K.astype(np.float32),
            world, cam, mask, filepath)
