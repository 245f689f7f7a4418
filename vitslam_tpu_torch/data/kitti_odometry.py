"""KITTI Odometry dataset (port of vitslam_tpu/data/kitti_odometry.py):
sequences 00-10; ``poses/<seq>.txt`` rows are c2w (3, 4), converted to
w2c; the intrinsics come from the P2 projection matrix of ``calib.txt``;
there is no GT depth, so a constant-ones placeholder flows through the
pipeline (trajectory metrics only). OpenCV is imported where a frame is
read; K is taken from P2 by scipy's RQ decomposition, not cv2's.
"""
from __future__ import annotations

import glob
import logging
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from .base import BaseDataset, CommonConfig
from .preprocess import read_image_cv2

SEQUENCES = [f"{i:02d}" for i in range(11)]


def decompose_projection(P: np.ndarray) -> np.ndarray:
    """K of a 3x4 projection matrix P = K [R | t]: the RQ decomposition of
    P[:, :3] with the signs chosen so that K's diagonal is positive, divided
    by K[2, 2] (``cv2.decomposeProjectionMatrix``'s K for a camera whose
    P[:, :3] has a positive determinant)."""
    import scipy.linalg

    K, _ = scipy.linalg.rq(np.asarray(P, np.float64)[:, :3])
    K = K * np.sign(np.diag(K))
    return K / K[2, 2]


class KITTIOdometryDataset(BaseDataset):
    def __init__(
        self,
        common_conf: CommonConfig,
        split: str = "train",
        KITTIOD_DIR: Optional[str] = None,
        sequence_ids: Optional[Sequence[str]] = None,
        len_train: int = 100000,
        len_test: int = 10000,
    ):
        super().__init__(common_conf)
        if KITTIOD_DIR is None:
            raise ValueError("KITTIOD_DIR must be specified")
        self.root = KITTIOD_DIR
        self.len_train = len_train if split == "train" else len_test

        seq_ids = sequence_ids if sequence_ids is not None else SEQUENCES
        sequence_list = []
        for sid in seq_ids:
            for p in glob.glob(osp.join(self.root, f"sequences/{sid}/image_2")):
                sequence_list.append(osp.relpath(p, self.root))
        self.sequence_list = sorted(sequence_list)
        self.sequence_list_len = len(self.sequence_list)
        self.seq_frame_num = [
            self.adjust_frame_num(
                len(glob.glob(osp.join(self.root, seq, "*.jpg")))
                or len(glob.glob(osp.join(self.root, seq, "*.png")))
            )
            for seq in self.sequence_list
        ]
        logging.info(
            "KITTI-Odometry: %d sequences, dataset length %d",
            self.sequence_list_len, len(self),
        )

    def get_seq_name(self, seq_index: int) -> str:
        return self.sequence_list[seq_index].split("/")[1]

    def get_data(self, seq_index=None, img_per_seq=None, seq_name=None,
                 ids=None, aspect_ratio: float = 1.0, rng=None) -> dict:
        rng = rng or np.random.default_rng()
        if self.inside_random and ids is None:
            seq_index = int(rng.integers(0, self.sequence_list_len))
        if seq_name is None:
            seq_name = self.sequence_list[seq_index]
        seq_id = seq_name.split("/")[1]

        poses_c2w = np.loadtxt(
            osp.join(self.root, "poses", f"{seq_id}.txt")
        ).reshape(-1, 3, 4)
        poses_h = np.concatenate(
            [poses_c2w,
             np.tile(np.array([[[0, 0, 0, 1.0]]]), (len(poses_c2w), 1, 1))],
            axis=1,
        )
        w2c = np.linalg.inv(poses_h)[:, :3, :4]

        calib_path = osp.join(self.root, osp.dirname(seq_name), "calib.txt")
        P2 = None
        with open(calib_path) as f:
            for line in f:
                if line.startswith("P2:"):
                    P2 = np.array(
                        [float(x) for x in line.split()[1:]]
                    ).reshape(3, 4)
        if P2 is None:
            raise ValueError(f"no P2 entry in {calib_path}")
        K = decompose_projection(P2)

        frame_num = self.seq_frame_num[seq_index] if seq_index is not None \
            else self.adjust_frame_num(len(w2c))
        img_per_seq, aspect_ratio = self.resolve_sampling(img_per_seq, aspect_ratio)
        if ids is None:
            ids = self.sample_ids(frame_num, img_per_seq, rng)
        elif self.subsampling_step > 1:
            ids = np.asarray(ids) * self.subsampling_step
        target_shape = self.get_target_shape(aspect_ratio)

        frames = {k: [] for k in
                  ("images", "depths", "extrinsics", "intrinsics",
                   "cam_points", "world_points", "point_masks",
                   "original_sizes")}
        for image_idx in np.asarray(ids, int):
            path_jpg = osp.join(self.root, seq_name, f"{image_idx:06d}.jpg")
            path = path_jpg if osp.exists(path_jpg) else \
                osp.join(self.root, seq_name, f"{image_idx:06d}.png")
            image = read_image_cv2(path)
            original_size = np.array(image.shape[:2])
            # no GT depth for KITTI odometry: a ones placeholder
            depth = np.ones(image.shape[:2], np.float32)

            img, d, e, k, world, cam, mask, _ = self.process_one_image(
                image, depth, w2c[image_idx], K, original_size, target_shape
            )
            frames["images"].append(img)
            frames["depths"].append(d)
            frames["extrinsics"].append(e)
            frames["intrinsics"].append(k)
            frames["cam_points"].append(cam)
            frames["world_points"].append(world)
            frames["point_masks"].append(mask)
            frames["original_sizes"].append(original_size)
        return self.stack_batch("kittiOd_" + seq_name, ids, frames)
