"""Build and load the port's CUDA kernels: nvcc compiles each ``csrc/*.cu``
for sm_90a into its own shared library with a plain C interface, bound
with ctypes.

The build happens at first use (never at import), from the sources in this
package only, into ``<package>/_build/`` (listed in .gitignore): one nvcc
per source, all started together. A library's name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and a current build is reused within a checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# source stem -> {C entry point: argtypes}
ENTRY_POINTS = {
    "fused_attention": {
        "vitslam_qk_prep_bf16": [_P] * 5 + [_LL] * 2 + [_P] * 4 + [_I] * 5 + [_F, _P],
        "vitslam_fused_qkv_attention_bf16": [_P] * 6 + [_LL] * 2 + [_P] * 5 + [_I] * 5
                                            + [_F, _P],
    },
    "flash_attention": {
        "vitslam_flash_attention_bf16": [_P] * 6 + [_I] * 5 + [_LL] * 12 + [_P],
    },
    "flash_attention_bwd": {
        "vitslam_flash_attention_bwd_bf16": [_P] * 9 + [_I] * 5 + [_F] + [_LL] * 21 + [_P],
    },
    "mlp_tail": {"vitslam_mlp_tail_bf16": [_P] * 8 + [_I] * 5 + [_F, _P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source stem: the nvcc command, its output (``-Xptxas -v``: registers,
# shared memory and spills per kernel), the seconds taken, whether cached
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc "
                       "(PATH or CUDA_HOME/bin)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvitslam_{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel source that has no current build, one nvcc per
    source, concurrently; return {source stem: library path}. Raises with
    nvcc's output if any build fails."""
    paths = {name: _lib_path(name) for name in ENTRY_POINTS}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    for name in paths.keys() - todo.keys():
        build_info.setdefault(name, dict(seconds=0.0, cached=True, log=""))
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    jobs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (cmd, tmp, proc, time.perf_counter())
    failed = []
    for name, (cmd, tmp, proc, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, todo[name])  # atomic: a concurrent build never sees a partial file
        build_info[name] = dict(command=" ".join(cmd), log=log, seconds=seconds, cached=False)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (every kernel is built on the
    first call), with its entry points' argtypes set."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            lib = ctypes.CDLL(str(paths[name]))
            for fn_name, argtypes in ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
