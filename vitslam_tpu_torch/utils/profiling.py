"""Tracing and profiling hooks (port of vitslam_tpu/utils/profiling.py).

* ``trace(log_dir)``: a ``torch.profiler`` window over the host and, where
  torch sees a card, the card, written to ``<log_dir>/trace.json`` (Chrome
  trace format) when the window closes;
* ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``) and, on the card, an NVTX range;
* ``ChunkTimer``: per-chunk wall time and chunks/s, frames/s, each chunk
  ended by a fence that waits for the device (``torch.cuda.synchronize``
  unless the timer is for the CPU).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; yields ``log_dir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range of the enclosed block in a trace."""
    nvtx = torch.cuda.is_available()
    with record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class ChunkTimer:
    """Accumulates per-chunk wall time. ``fence`` must wait for the chunk's
    outputs; by default ``torch.cuda.synchronize`` for a timer on the card
    (``device="cuda"``), none for one on the CPU."""

    def __init__(self, fence: Optional[Callable] = None, device="cuda"):
        if fence is None and torch.device(device).type == "cuda":
            fence = torch.cuda.synchronize
        self.fence = fence
        self.reset()

    def reset(self):
        self.chunks = 0
        self.frames = 0
        self.elapsed = 0.0

    @contextlib.contextmanager
    def chunk(self, new_frames: int):
        t0 = time.perf_counter()
        yield
        if self.fence is not None:
            self.fence()
        self.elapsed += time.perf_counter() - t0
        self.chunks += 1
        self.frames += new_frames

    @property
    def chunks_per_sec(self) -> float:
        return self.chunks / self.elapsed if self.elapsed else 0.0

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.elapsed if self.elapsed else 0.0

    def summary(self) -> dict:
        return {
            "chunks": self.chunks,
            "frames": self.frames,
            "elapsed_s": round(self.elapsed, 4),
            "chunks_per_sec": round(self.chunks_per_sec, 3),
            "frames_per_sec": round(self.frames_per_sec, 3),
        }
