"""ctypes bindings of the native host-side code, and its build: the
preprocessing kernels (``preprocess.cpp``, port of
vitslam_tpu/native/bindings.py) and the zstd decoder (``zstd.cpp``) that
reads orbax checkpoints.

Each source is compiled by g++ at first use, never at import, into
``<package>/_build/`` (listed in .gitignore), under a name that carries a
hash of the source and the flags, so an edited source is rebuilt and a
current build reused; a library is written under a temporary name and
renamed, so processes that build at once do not read a half-written file.
``VITSLAM_NATIVE=0`` turns the native route off (read at every call); so
does a failed build or load.

The preprocessing entry points return None when the route is off, and
their callers run their numpy versions. The zstd decoder has no such
fallback: a pure-Python decoder could not read a train state of gigabytes
in useful time, so ``zstd_decompress_into`` raises ``NativeUnavailable``,
naming the reason (the route switched off, g++ missing, the build failed),
and an orbax read stops there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "preprocess.cpp"
ZSTD_SOURCE = SOURCE.with_name("zstd.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}  # source -> the loaded CDLL, or the reason it is not there


class NativeUnavailable(RuntimeError):
    """The native route is off or could not be built, where there is no
    other route."""


def _lib_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(source.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libvitslam_{source.stem}_{h.hexdigest()[:16]}.so"


def _build(source: Path, path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(source), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open(source: Path, bind) -> ctypes.CDLL | str:
    """The library of ``source`` (built first if needed, then ``bind``
    sets its argument types), or the reason there is none."""
    if os.environ.get("VITSLAM_NATIVE", "1") == "0":
        return "the native route is switched off (VITSLAM_NATIVE=0)"
    with _lock:
        if source in _libs:
            return _libs[source]
        path = _lib_path(source)
        try:
            if not path.exists():
                if shutil.which("g++") is None:
                    raise OSError("g++ is not on PATH")
                _build(source, path)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[source] = lib
        except subprocess.CalledProcessError as e:
            _libs[source] = (f"g++ failed to build {source.name}: "
                             f"{e.stderr.decode(errors='replace')[-2000:]}")
        except (OSError, subprocess.SubprocessError) as e:
            _libs[source] = f"{source.name} could not be built or loaded: {e}"
        return _libs[source]


def _bind_preprocess(lib: ctypes.CDLL) -> None:
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.lidar_splat_depth.argtypes = [f32, i64, f64, f64, i64, i64, ctypes.c_float, f32]
    lib.lidar_splat_depth.restype = None
    lib.depth_to_points.argtypes = [f32, i64, i64, f64, f64, f32, f32, u8]
    lib.depth_to_points.restype = None
    lib.png_unfilter.argtypes = [u8, u8, i64, i64, i64]
    lib.png_unfilter.restype = None


def _bind_zstd(lib: ctypes.CDLL) -> None:
    ptr, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.zstd_decompress.argtypes = [ptr, u64, ptr, u64, ctypes.c_int, ctypes.c_char_p, u64]
    lib.zstd_decompress.restype = ctypes.c_int64
    lib.zstd_content_size.argtypes = [ptr, u64]
    lib.zstd_content_size.restype = ctypes.c_int64
    lib.crc32c.argtypes = [ptr, u64]
    lib.crc32c.restype = ctypes.c_uint32


def _load() -> Optional[ctypes.CDLL]:
    """The preprocessing library, built first if needed; None when the
    route is off."""
    lib = _open(SOURCE, _bind_preprocess)
    return None if isinstance(lib, str) else lib


def _zstd() -> ctypes.CDLL:
    lib = _open(ZSTD_SOURCE, _bind_zstd)
    if isinstance(lib, str):
        raise NativeUnavailable(f"the zstd decoder is native only, and {lib}")
    return lib


def _address(buf) -> tuple:
    """(address, size, keep-alive) of a bytes-like object's bytes."""
    if isinstance(buf, bytes):
        return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value, len(buf), buf
    arr = np.frombuffer(buf, np.uint8)
    return arr.ctypes.data, arr.size, arr


def zstd_decompress_into(src, dst: np.ndarray, exact: bool = True) -> int:
    """Decode the zstd frames of ``src`` (bytes-like: the frames back to
    back, skippable frames skipped) into ``dst``, a C-contiguous writable
    array; returns the bytes decoded, which must fill ``dst`` exactly unless
    ``exact`` is False. Corrupt input, a dictionary, a checksum or content
    size that does not match, or content past ``dst`` raise ValueError; no
    native decoder raises NativeUnavailable."""
    lib = _zstd()
    if not (dst.flags.c_contiguous and dst.flags.writeable):
        raise ValueError("zstd_decompress_into: dst must be C-contiguous and writable")
    addr, n, keep = _address(src)
    err = ctypes.create_string_buffer(512)
    got = lib.zstd_decompress(addr, n, dst.ctypes.data, dst.nbytes, int(exact), err, len(err))
    del keep
    if got < 0:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    return int(got)


def zstd_decompress(src, limit: int) -> bytes:
    """The content of the zstd frames of ``src``, at most ``limit`` bytes:
    sized by the frame headers where they declare it, else by doubling."""
    addr, n, keep = _address(src)
    size = _zstd().zstd_content_size(addr, n)
    del keep
    if size > limit:
        raise ValueError(f"zstd: content of {size} bytes above the limit of {limit}")
    if size >= 0:
        out = np.empty(size, np.uint8)
        zstd_decompress_into(src, out)
        return out.tobytes()
    cap = min(max(4 * n, 4096), limit)
    while True:
        out = np.empty(cap, np.uint8)
        try:
            return out[:zstd_decompress_into(src, out, exact=False)].tobytes()
        except ValueError:
            if cap >= limit:
                raise
            cap = min(2 * cap, limit)


def crc32c(buf) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object, natively."""
    addr, n, keep = _address(buf)
    value = _zstd().crc32c(addr, n)
    del keep
    return int(value)


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


def png_unfilter_native(rows: np.ndarray, filters: np.ndarray, bpp: int) -> bool:
    """Undo the PNG row filters of ``rows`` (H, stride) uint8, C-contiguous,
    in place; ``filters`` (H,) uint8 in 0-4. False when the route is off
    (``rows`` untouched)."""
    lib = _load()
    if lib is None:
        return False
    if rows.dtype != np.uint8 or rows.ndim != 2 or not rows.flags.c_contiguous:
        raise ValueError("rows must be a C-contiguous (H, stride) uint8 array")
    filters = np.ascontiguousarray(filters, np.uint8)
    lib.png_unfilter(rows, filters, rows.shape[0], rows.shape[1], int(bpp))
    return True
