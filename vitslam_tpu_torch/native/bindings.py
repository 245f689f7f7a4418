"""ctypes bindings of the native preprocessing kernels (port of
vitslam_tpu/native/bindings.py), and their build.

``preprocess.cpp`` is compiled by g++ at first use, never at import, into
``<package>/_build/`` (listed in .gitignore), under a name that carries a
hash of the source and the flags, so an edited source is rebuilt and a
current build reused; the library is written under a temporary name and
renamed, so processes that build at once do not read a half-written file.
``VITSLAM_NATIVE=0`` turns the native route off (read at every call); so
does a failed build or load. Each entry point returns None when the route
is off, and its caller runs its numpy version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libvitslam_preprocess_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None when the route is off."""
    global _lib, _failed
    if os.environ.get("VITSLAM_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _lib_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            _failed = True
            return None
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.lidar_splat_depth.argtypes = [f32, i64, f64, f64, i64, i64, ctypes.c_float, f32]
        lib.lidar_splat_depth.restype = None
        lib.depth_to_points.argtypes = [f32, i64, i64, f64, f64, f32, f32, u8]
        lib.depth_to_points.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native route runs: on, built and loaded."""
    return _load() is not None


def _matrix(m: np.ndarray, rows: int, cols: int, name: str) -> np.ndarray:
    m = np.asarray(m, np.float64)
    if m.ndim != 2 or m.shape[0] < rows or m.shape[1] < cols:
        raise ValueError(f"{name} must be at least {rows} x {cols}, got {m.shape}")
    return np.ascontiguousarray(m[:rows, :cols]).reshape(-1)


def lidar_splat_depth_native(points_xyz: np.ndarray, K: np.ndarray, extr: np.ndarray,
                             image_size, eps: float = 0.05) -> Optional[np.ndarray]:
    """C++ LiDAR splat of points_xyz (N, 3) through K (3, 3) and the w2c
    extrinsics (3, 4): the (H, W) depth, or None when the route is off."""
    lib = _load()
    if lib is None:
        return None
    H, W = int(image_size[0]), int(image_size[1])
    pts = np.ascontiguousarray(points_xyz, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points_xyz must be (N, 3), got {pts.shape}")
    out = np.zeros(H * W, np.float32)
    lib.lidar_splat_depth(pts, pts.shape[0], _matrix(K, 3, 3, "K"),
                          _matrix(extr, 3, 4, "extr"), H, W, np.float32(eps), out)
    return out.reshape(H, W)


def depth_to_points_native(depth: np.ndarray, extr: np.ndarray, K: np.ndarray):
    """C++ back-projection of a depth map (H, W) through the w2c extrinsics
    (3, 4) and K (3, 3): (world (H, W, 3), cam (H, W, 3), mask (H, W)), or
    None when the route is off."""
    lib = _load()
    if lib is None:
        return None
    d = np.ascontiguousarray(depth, np.float32)
    if d.ndim != 2:
        raise ValueError(f"depth must be (H, W), got {d.shape}")
    H, W = d.shape
    world = np.zeros(H * W * 3, np.float32)
    cam = np.zeros(H * W * 3, np.float32)
    mask = np.zeros(H * W, np.uint8)
    lib.depth_to_points(d.reshape(-1), H, W, _matrix(K, 3, 3, "K"), _matrix(extr, 3, 4, "extr"),
                        world, cam, mask)
    return world.reshape(H, W, 3), cam.reshape(H, W, 3), mask.reshape(H, W).astype(bool)
