"""fp32 geometry: rotations, SE(3)/Sim(3), pose encodings, alignment
solvers and projection (port of vitslam_tpu/geometry)."""

from .rotations import (
    average_quaternions,
    mat_to_quat,
    normalize_quat,
    quat_to_mat,
    rotation_angle,
)
from .se3 import (
    apply_sim3_on_c2w,
    apply_sim3_on_point_maps,
    apply_sim3_on_w2c,
    closed_form_inverse_se3,
    compute_relative_poses,
    pad_to_4x4,
    se3_compose,
)
from .pose_encoding import (
    average_pose_encodings,
    extri_intri_to_pose_encoding,
    extri_to_pose_encoding,
    pose_encoding_to_extri,
    pose_encoding_to_extri_intri,
)
from .solvers import (
    depth_scale_weights,
    huber_weights,
    irls_sim3_umeyama,
    irls_sim3_umeyama_batched,
    method_of_horn,
    scale_lse_solver,
    umeyama,
    weighted_median_scale,
)
from .projection import (
    generate_pixel_grid,
    project_points_to_pixels,
    unproject_depth_to_points,
)

__all__ = [
    "average_quaternions", "mat_to_quat", "normalize_quat", "quat_to_mat",
    "rotation_angle",
    "apply_sim3_on_c2w", "apply_sim3_on_point_maps", "apply_sim3_on_w2c",
    "closed_form_inverse_se3", "compute_relative_poses", "pad_to_4x4",
    "se3_compose",
    "average_pose_encodings", "extri_intri_to_pose_encoding",
    "extri_to_pose_encoding", "pose_encoding_to_extri",
    "pose_encoding_to_extri_intri",
    "depth_scale_weights", "huber_weights", "irls_sim3_umeyama",
    "irls_sim3_umeyama_batched", "method_of_horn", "scale_lse_solver", "umeyama",
    "weighted_median_scale",
    "generate_pixel_grid", "project_points_to_pixels", "unproject_depth_to_points",
]
