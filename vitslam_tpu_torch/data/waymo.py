"""Waymo Open dataset, preprocessed layout (port of
vitslam_tpu/data/waymo.py): 5 cameras; per sequence ``poses.npy`` (car
poses) and ``calibration.pkl`` (per-camera extrinsics, normalised
projection matrices, image dims); the model <-> Waymo axis conversion; the
intrinsics denormalised; LiDAR rasterised to depth by a vectorised
bilinear 4-neighbour splat with a scatter-min z-buffer and an
order-independent epsilon-window average (``lidar_to_depth``: the native
C++ splat when its route is on, ``vitslam_tpu_torch.native``, else numpy, as
the reference). OpenCV is imported where a frame is read.
"""
from __future__ import annotations

import glob
import logging
import os.path as osp
import pickle
from typing import Optional, Sequence

import numpy as np

from .base import BaseDataset, CommonConfig
from .preprocess import read_image_cv2, threshold_depth_map

CAMERAS = ["cam_01", "cam_02", "cam_03", "cam_04", "cam_05"]

# +z forward, +y down, +x right  ->  +z up, +y left, +x forward
MODEL_AXIS_TO_WAYMO_AXIS = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64
)


def lidar_to_depth(points_h: np.ndarray, intrinsics: np.ndarray,
                   extrinsics: np.ndarray, image_size: tuple,
                   eps: float = 0.05) -> np.ndarray:
    """Project points, splat each bilinearly into its 4 neighbouring pixels
    with a scatter-min z-buffer, then average every contribution within
    ``eps`` of the pixel's minimum depth (all of them, whatever their order).

    Args:
        points_h: (4, N) homogeneous LiDAR points.
        intrinsics: (3, 3). extrinsics: (3, 4) w2c. image_size: (H, W).
    Returns:
        (H, W) float32 depth map (0 = no return).
    """
    from ..native import lidar_splat_depth_native

    native = lidar_splat_depth_native(np.ascontiguousarray(points_h[:3].T), intrinsics,
                                      extrinsics, image_size, eps)
    if native is not None:
        return native
    H, W = int(image_size[0]), int(image_size[1])
    cam = (intrinsics @ (extrinsics @ points_h)).T  # (N, 3)
    cam = cam[cam[:, 2] > 0]
    pix = cam[:, :2] / cam[:, 2:]
    ok = (pix[:, 0] >= 0) & (pix[:, 0] < W) & (pix[:, 1] >= 0) & (pix[:, 1] < H)
    pix = pix[ok]
    z = cam[ok][:, 2].astype(np.float32)
    if len(z) == 0:
        return np.zeros((H, W), np.float32)

    j = np.floor(pix[:, 0]).astype(np.int64)
    i = np.floor(pix[:, 1]).astype(np.int64)
    du = (pix[:, 0] - j).astype(np.float32)
    dv = (pix[:, 1] - i).astype(np.float32)

    rows_all, cols_all, w_all, z_all = [], [], [], []
    for di, dj, w in ((0, 0, (1 - du) * (1 - dv)), (0, 1, du * (1 - dv)),
                      (1, 0, (1 - du) * dv), (1, 1, du * dv)):
        r = i + di
        c = j + dj
        m = (r >= 0) & (r < H) & (c >= 0) & (c < W) & (w > 0)
        rows_all.append(r[m])
        cols_all.append(c[m])
        w_all.append(w[m])
        z_all.append(z[m])
    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    wts = np.concatenate(w_all)
    zs = np.concatenate(z_all)
    flat = rows * W + cols

    zbuf = np.full(H * W, np.inf, np.float32)
    np.minimum.at(zbuf, flat, zs)

    near = zs <= zbuf[flat] + eps
    wz = np.zeros(H * W, np.float32)
    ws = np.zeros(H * W, np.float32)
    np.add.at(wz, flat[near], (wts * zs)[near])
    np.add.at(ws, flat[near], wts[near])
    depth = np.where(ws > 0, wz / np.maximum(ws, 1e-12), 0.0)
    return depth.reshape(H, W).astype(np.float32)


class WaymoDataset(BaseDataset):
    def __init__(
        self,
        common_conf: CommonConfig,
        split: str = "train",
        Waymo_DIR: Optional[str] = None,
        sequence_ids: Optional[Sequence[str]] = None,
        exclude_ids: bool = True,
        cameras: Sequence[str] = tuple(CAMERAS),
        len_train: int = 100000,
        len_test: int = 10000,
    ):
        super().__init__(common_conf)
        if Waymo_DIR is None:
            raise ValueError("Waymo_DIR must be specified")
        self.root = Waymo_DIR
        split_str = {"train": "training", "val": "validation",
                     "test": "testing"}[split]
        self.len_train = len_train if split == "train" else len_test
        self.depth_max = 80.0

        def rel(paths):
            return sorted(osp.relpath(p, self.root) for p in paths)

        all_seqs = []
        for cam in cameras:
            all_seqs += rel(glob.glob(
                osp.join(self.root, f"{split_str}/*/frames/{cam}")
            ))
        if sequence_ids is not None:
            listed = []
            for sid in sequence_ids:
                for cam in cameras:
                    listed += rel(glob.glob(osp.join(
                        self.root, f"{split_str}/{sid}*/frames/{cam}"
                    )))
            listed = set(listed)
            if exclude_ids:
                all_seqs = [s for s in all_seqs if s not in listed]
            else:
                all_seqs = sorted(listed)
        self.sequence_list = sorted(all_seqs)
        self.sequence_list_len = len(self.sequence_list)
        self.seq_frame_num = [
            self.adjust_frame_num(
                len(glob.glob(osp.join(self.root, seq, "*.jpg")))
            )
            for seq in self.sequence_list
        ]
        logging.info(
            "Waymo: %d sequences, dataset length %d",
            self.sequence_list_len, len(self),
        )

    def get_seq_name(self, seq_index: int) -> str:
        parts = self.sequence_list[seq_index].split("/")
        return "_".join([parts[1], parts[-1]])

    def get_data(self, seq_index=None, img_per_seq=None, seq_name=None,
                 ids=None, aspect_ratio: float = 1.0, rng=None) -> dict:
        rng = rng or np.random.default_rng()
        if self.inside_random and ids is None:
            seq_index = int(rng.integers(0, self.sequence_list_len))
        if seq_name is None:
            seq_name = self.sequence_list[seq_index]
        camera_id = int(seq_name[-1])

        seq_dir = osp.join(self.root, *seq_name.split("/")[:2])
        car_poses = np.load(osp.join(seq_dir, "poses.npy"))
        # the calibration file is the dataset's own preprocessing output
        with open(osp.join(seq_dir, "calibration.pkl"), "rb") as f:
            calib = pickle.load(f)
        image_size = calib["dims"]

        M = MODEL_AXIS_TO_WAYMO_AXIS
        camera_poses = (M.T @ car_poses @ M) @ (M.T @ calib["extrinsics"][camera_id])
        camera_extr_full = np.linalg.inv(camera_poses)
        camera_extr = np.linalg.inv(calib["extrinsics"][camera_id])[:3, :4]

        K = np.array(calib["proj_mats"][camera_id], np.float64).copy()
        K[0, 2] += image_size[1] / 2
        K[1, 2] += image_size[0] / 2
        K[0, 0] *= image_size[1] / 2
        K[1, 1] *= image_size[0] / 2

        frame_num = self.seq_frame_num[seq_index] if seq_index is not None \
            else self.adjust_frame_num(len(car_poses))
        img_per_seq, aspect_ratio = self.resolve_sampling(img_per_seq, aspect_ratio)
        if ids is None:
            ids = self.sample_ids(frame_num, img_per_seq, rng)
        elif self.subsampling_step > 1:
            ids = np.asarray(ids) * self.subsampling_step
        target_shape = self.get_target_shape(aspect_ratio)

        lidar_dir = osp.join(
            self.root, "/".join(seq_name.split("/")[:3]).replace("/frames", "/lidar")
        )
        frames = {k: [] for k in
                  ("images", "depths", "extrinsics", "intrinsics",
                   "cam_points", "world_points", "point_masks",
                   "original_sizes")}
        for image_idx in np.asarray(ids, int):
            image = read_image_cv2(
                osp.join(self.root, seq_name, f"{image_idx:010d}.jpg")
            )
            original_size = np.array(image.shape[:2])
            lidar = np.load(osp.join(lidar_dir, f"{image_idx:010d}.npy"))
            pts_h = np.concatenate(
                [lidar, np.ones((lidar.shape[0], 1))], axis=-1
            ).T
            depth = lidar_to_depth(pts_h, K, camera_extr, image_size)
            depth = threshold_depth_map(depth, max_depth=self.depth_max)

            img, d, e, k, world, cam, mask, _ = self.process_one_image(
                image, depth, camera_extr_full[image_idx][:3, :4], K,
                original_size, target_shape,
            )
            frames["images"].append(img)
            frames["depths"].append(d)
            frames["extrinsics"].append(e)
            frames["intrinsics"].append(k)
            frames["cam_points"].append(cam)
            frames["world_points"].append(world)
            frames["point_masks"].append(mask)
            frames["original_sizes"].append(original_size)
        return self.stack_batch("waymo_" + seq_name, ids, frames)
