"""Native (C++) host-side preprocessing, bound with ctypes (port of
vitslam_tpu/native): built by g++ at first use; every entry point returns
None when the route is off (``VITSLAM_NATIVE=0``, or no toolchain), and the
readers then run their numpy versions."""
from .bindings import depth_to_points_native, lidar_splat_depth_native, native_available

__all__ = ["depth_to_points_native", "lidar_splat_depth_native", "native_available"]
