"""Dataset readers (port of vitslam_tpu/data): the common config and base
dataset, the dynamic batcher, and the Virtual KITTI 2, KITTI Odometry and
Waymo readers."""
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
from .kitti_odometry import KITTIOdometryDataset
from .vkitti import VKittiDataset
from .waymo import WaymoDataset

__all__ = [
    "BaseDataset", "CommonConfig", "depth_to_points", "get_target_shape",
    "process_one_image", "read_image_cv2", "resize_crop_image",
    "threshold_depth_map", "VKittiDataset", "KITTIOdometryDataset", "WaymoDataset",
    "ComposedDataset", "DynamicDataset", "collate",
]
