"""Dataset readers (port of vitslam_tpu/data): the common config and base
dataset, the dynamic batcher and the Virtual KITTI 2 reader. The KITTI
odometry and Waymo readers are not ported yet (ROADMAP queue 1)."""
from .base import BaseDataset, CommonConfig
from .dynamic import ComposedDataset, DynamicDataset, collate
from .preprocess import (
    depth_to_points,
    get_target_shape,
    process_one_image,
    read_image_cv2,
    resize_crop_image,
    threshold_depth_map,
)
from .vkitti import VKittiDataset

__all__ = [
    "BaseDataset", "CommonConfig", "depth_to_points", "get_target_shape",
    "process_one_image", "read_image_cv2", "resize_crop_image",
    "threshold_depth_map", "VKittiDataset", "ComposedDataset", "DynamicDataset",
    "collate",
]
