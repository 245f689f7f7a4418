"""Native (C++) host-side code, bound with ctypes, built by g++ at first
use: the preprocessing (port of vitslam_tpu/native), whose entry points
return None when the route is off (``VITSLAM_NATIVE=0``, or no toolchain)
so the readers run their numpy versions; and the zstd decoder of orbax
checkpoints, which has no other route and raises ``NativeUnavailable``."""
from .bindings import (
    NativeUnavailable,
    crc32c,
    depth_to_points_native,
    lidar_splat_depth_native,
    native_available,
    png_unfilter_native,
    zstd_decompress,
    zstd_decompress_into,
)

__all__ = ["NativeUnavailable", "crc32c", "depth_to_points_native", "lidar_splat_depth_native",
           "native_available", "png_unfilter_native", "zstd_decompress",
           "zstd_decompress_into"]
