"""Virtual KITTI 2 dataset (port of vitslam_tpu/data/vkitti.py): scenes
01/02/06/18/20 x 10 weather/viewpoint settings; sequence dirs
``Scene<id>/<setting>/frames/rgb/Camera_<k>``; extrinsic/intrinsic txt
parsing filtered by camera id; depth PNGs in centimeters (/100 -> meters)
capped at 80 m. OpenCV is imported where a frame is read.
"""
from __future__ import annotations

import glob
import logging
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from .base import BaseDataset, CommonConfig
from .preprocess import read_image_cv2, threshold_depth_map

SCENES = ["01", "02", "06", "18", "20"]
SETTINGS = [
    "15-deg-left", "15-deg-right", "30-deg-left", "30-deg-right", "clone",
    "fog", "morning", "overcast", "rain", "sunset",
]


class VKittiDataset(BaseDataset):
    def __init__(
        self,
        common_conf: CommonConfig,
        split: str = "train",
        VKitti_DIR: Optional[str] = None,
        sequence_ids: Optional[Sequence[str]] = None,
        settings: Sequence[str] = tuple(SETTINGS),
        len_train: int = 100000,
        len_test: int = 10000,
    ):
        super().__init__(common_conf)
        if VKitti_DIR is None:
            raise ValueError("VKitti_DIR must be specified")
        self.root = VKitti_DIR
        self.len_train = len_train if split == "train" else len_test
        self.depth_max = 80.0

        sequence_list: list[str] = []
        scene_glob = (
            [f"Scene{sid}/{s}/*/rgb/*" for sid in sequence_ids for s in settings]
            if sequence_ids is not None
            else [f"*/{s}/*/rgb/*" for s in settings]
        )
        for pattern in scene_glob:
            for p in glob.glob(osp.join(self.root, pattern)):
                sequence_list.append(osp.relpath(p, self.root))
        self.sequence_list = sorted(sequence_list)
        self.sequence_list_len = len(self.sequence_list)

        self.seq_frame_num = [
            self.adjust_frame_num(
                len(glob.glob(osp.join(self.root, seq, "rgb_*.jpg")))
            )
            for seq in self.sequence_list
        ]
        logging.info(
            "VKitti: %d sequences, dataset length %d",
            self.sequence_list_len, len(self),
        )

    def get_seq_name(self, seq_index: int) -> str:
        return "_".join(self.sequence_list[seq_index].split("/")[:2])

    def get_data(self, seq_index=None, img_per_seq=None, seq_name=None,
                 ids=None, aspect_ratio: float = 1.0, rng=None) -> dict:
        import numpy as _np

        rng = rng or _np.random.default_rng()
        if self.inside_random and ids is None:
            seq_index = int(rng.integers(0, self.sequence_list_len))
        if seq_name is None:
            seq_name = self.sequence_list[seq_index]
        camera_id = int(seq_name[-1])

        scene_dir = osp.join(self.root, *seq_name.split("/")[:2])
        extr_rows = np.loadtxt(osp.join(scene_dir, "extrinsic.txt"),
                               delimiter=" ", skiprows=1)
        extr_rows = extr_rows[extr_rows[:, 1] == camera_id]
        intr_rows = np.loadtxt(osp.join(scene_dir, "intrinsic.txt"),
                               delimiter=" ", skiprows=1)
        intr_rows = intr_rows[intr_rows[:, 1] == camera_id]

        frame_num = self.seq_frame_num[seq_index] if seq_index is not None \
            else self.adjust_frame_num(len(extr_rows))
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
            extri = extr_rows[image_idx][2:].reshape(4, 4)[:3]
            intri = np.eye(3)
            intri[0, 0] = intr_rows[image_idx][-4]
            intri[1, 1] = intr_rows[image_idx][-3]
            intri[0, 2] = intr_rows[image_idx][-2]
            intri[1, 2] = intr_rows[image_idx][-1]

            image = read_image_cv2(
                osp.join(self.root, seq_name, f"rgb_{image_idx:05d}.jpg")
            )
            original_size = np.array(image.shape[:2])
            import cv2
            depth = cv2.imread(
                osp.join(self.root, seq_name.replace("/rgb", "/depth"),
                         f"depth_{image_idx:05d}.png"),
                cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH,
            )
            depth = threshold_depth_map(depth / 100.0, max_depth=self.depth_max)

            img, d, e, k, world, cam, mask, _ = self.process_one_image(
                image, depth, extri, intri, original_size, target_shape
            )
            frames["images"].append(img)
            frames["depths"].append(d)
            frames["extrinsics"].append(e)
            frames["intrinsics"].append(k)
            frames["cam_points"].append(cam)
            frames["world_points"].append(world)
            frames["point_masks"].append(mask)
            frames["original_sizes"].append(original_size)
        return self.stack_batch("vkitti_" + seq_name, ids, frames)
