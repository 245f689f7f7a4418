"""CSV logging and step progress on the host (port of
vitslam_tpu/train/logging_utils.py): scalars appended to
``<log_dir>/<exp_name>/version_k/metrics.csv`` with a growing column union,
and a step-rate line on stderr."""
from __future__ import annotations

import csv
import os
import os.path as osp
import sys
import time
from typing import Optional


class CSVLogger:
    def __init__(self, save_dir: str, name: str, write: bool = True):
        """write: False for a rank of a gang other than 0, which shares the
        file system and logs nothing; it makes no ``version_k`` directory
        (the ranks would race for one) and has no ``log_dir`` or ``path``."""
        self._columns: list[str] = ["step"]
        self._rows: list[dict] = []
        self.log_dir = self.path = None
        if not write:
            return
        base = osp.join(save_dir, name)
        os.makedirs(base, exist_ok=True)
        version = 0
        while osp.exists(osp.join(base, f"version_{version}")):
            version += 1
        self.log_dir = osp.join(base, f"version_{version}")
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = osp.join(self.log_dir, "metrics.csv")

    def log_metrics(self, metrics: dict, step: int):
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        for k in row:
            if k not in self._columns:
                self._columns.append(k)
        self._rows.append(row)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._columns)
            w.writeheader()
            w.writerows(self._rows)


class StepProgress:
    """Every ``print_every`` steps: steps per second since the start and
    the first four metrics."""

    def __init__(self, total_steps: int, print_every: int = 10):
        self.total = total_steps
        self.every = print_every
        self.t0 = time.time()

    def update(self, step: int, metrics: Optional[dict] = None):
        if step % self.every != 0:
            return
        rate = (step + 1) / max(time.time() - self.t0, 1e-9)
        msg = f"step {step}/{self.total} ({rate:.2f} it/s)"
        if metrics:
            msg += " " + " ".join(f"{k}={float(v):.4f}" for k, v in list(metrics.items())[:4])
        print(msg, file=sys.stderr, flush=True)
