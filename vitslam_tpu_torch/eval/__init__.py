"""Evaluation (port of vitslam_tpu/eval): ATE / RPE / scale consistency,
Chamfer after ICP, the metric data preparation and the ``Metrics``
orchestrator of the test and validation modes. The numbers are computed in
fp32 torch on the device the predictions are given on (the card in a run on
the card); metric states live on the host."""
from .icp import ICPResult, iterative_closest_point
from .orchestrator import Metrics, gather_sequences, get_sequence_data, log_additional_data
from .prepare import find_subsample_factor, prepare_data_for_metrics, prepare_poses
from .reconstruction import ChamferDistanceMetrics
from .trajectory import (
    AbsoluteTrajectoryError,
    RelativePoseError,
    ScaleConsistency,
    ate_errors,
    rpe_errors,
    scale_factors,
)

__all__ = [
    "AbsoluteTrajectoryError", "RelativePoseError", "ScaleConsistency", "ate_errors",
    "rpe_errors", "scale_factors", "ChamferDistanceMetrics", "ICPResult",
    "iterative_closest_point", "find_subsample_factor", "prepare_data_for_metrics",
    "prepare_poses", "Metrics", "gather_sequences", "get_sequence_data",
    "log_additional_data",
]
