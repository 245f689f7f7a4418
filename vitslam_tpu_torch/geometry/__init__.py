"""fp32 geometry: rotations, SE(3)/Sim(3), pose encodings and alignment
solvers (port of vitslam_tpu/geometry; ``projection`` is not ported yet)."""

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
]
