"""Gang launcher for ``torch.distributed`` workers, retried on a fresh port
(port of vitslam_tpu/parallel/spawn.py).

The multi-rank tests, ``chip_smoke.py``'s distributed phase and the CLI's
``--num_devices`` launch all rendezvous at a TCP store on a freshly bound
localhost port. Binding a port, closing it and handing the number to the
workers is racy (another process can take it in between), so a gang whose
workers fail with a rendezvous-shaped error (an address in use, a refused
or failed connection, a store that timed out) is relaunched whole on a
fresh port, up to ``retries`` times. A worker that fails in any other way
fails the gang at once: the other workers get ``GRACE_SECONDS`` to exit on
their own (a peer blocked in a collective never would), then are killed,
and no attempt is retried.

Each worker's stdout and stderr go to a file, not a pipe, so a worker that
prints a lot never blocks on a full pipe while its peers wait for it in a
collective. Every process the launcher starts is stopped before it returns
or raises.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

# failure signatures that mean "the gang never rendezvoused" (retryable with
# a fresh port): the JAX package's, then torch c10d's TCP store messages
RENDEZVOUS_PATTERNS: Tuple[str, ...] = (
    "Address already in use",
    "address already in use",
    "DEADLINE_EXCEEDED",
    "Connection refused",
    "failed to connect",
    "Failed to connect",
    "Coordination service",
    "coordination service",
    "Barrier timed out",
    "timed out waiting for",
    "Gloo connectFullMesh failed",
    "UNAVAILABLE",
    # torch.distributed's TCPStore: the server cannot bind, a client cannot
    # reach it, or the store times out waiting for the other ranks
    "EADDRINUSE",
    "has failed to listen on any local network address",
    "has failed to connect to",
    "waiting for clients",
    "DistNetworkError",
)
# variables of an enclosing gang that must not leak into a new one
GANG_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", "GROUP_RANK")
TRACEBACK = "Traceback (most recent call last)"
GRACE_SECONDS = 30.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _looks_like_rendezvous_failure(out: str) -> bool:
    return any(p in out for p in RENDEZVOUS_PATTERNS)


def _has_real_failure(out: str) -> bool:
    """A Python failure that is not a rendezvous error: an assertion, or a
    traceback whose text (from its last start on) carries no rendezvous
    signature (torch raises its store errors with a traceback too)."""
    if "AssertionError" in out:
        return True
    i = out.rfind(TRACEBACK)
    return i >= 0 and not _looks_like_rendezvous_failure(out[i:])


def clean_env(extra: Optional[dict] = None) -> dict:
    """Environment for spawned workers: the parent's, without an enclosing
    gang's rendezvous variables, plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in GANG_ENV}
    if extra:
        env.update(extra)
    return env


def _wait(procs, timeout: float) -> Tuple[bool, Optional[int]]:
    """Wait for every process; returns (timed out, the first failed
    worker). After a worker fails, the others have GRACE_SECONDS."""
    deadline = time.monotonic() + timeout
    failed = None
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return False, failed
        if failed is None:
            failed = next((i for i, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is not None:
                deadline = min(deadline, time.monotonic() + GRACE_SECONDS)
        if time.monotonic() > deadline:
            return failed is None, failed
        time.sleep(0.05)


def spawn_gang(argv_for: Callable[[int, int], Sequence[str]], num_processes: int,
               timeout: float = 1800.0, retries: int = 2, env: Optional[dict] = None,
               cwd: Optional[str] = None) -> Tuple[List[str], int]:
    """Launch ``num_processes`` workers and wait for all of them.

    ``argv_for(process_id, port) -> argv`` builds each worker's command
    line. All workers must exit 0; on a rendezvous-shaped failure (or a
    gang-wide timeout) the whole gang is relaunched on a fresh port.

    Returns ``(outputs, port)``: one combined stdout + stderr string per
    worker, in rank order. Raises RuntimeError after the final attempt,
    with the end of every worker's output."""
    env = env if env is not None else clean_env()
    outs: List[str] = []
    for attempt in range(retries + 1):
        port = free_port()
        with tempfile.TemporaryDirectory(prefix="gang_") as tmp:
            logs = [open(os.path.join(tmp, f"worker{i}.log"), "w+") for i in range(num_processes)]
            procs = []
            try:
                for i in range(num_processes):
                    procs.append(subprocess.Popen(list(argv_for(i, port)), stdout=logs[i],
                                                  stderr=subprocess.STDOUT, text=True, env=env,
                                                  cwd=cwd))
                timed_out, failed = _wait(procs, timeout)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
                outs = []
                for f in logs:
                    f.seek(0)
                    outs.append(f.read())
                    f.close()
        for i, p in enumerate(procs):
            if p.returncode < 0:
                outs[i] += f"\n[worker {i} killed: exit {p.returncode}]"
        if timed_out:
            outs = [o + "\n[gang timeout]" for o in outs]
        if not timed_out and failed is None and all(p.returncode == 0 for p in procs):
            return outs, port
        # relaunch only a gang that never rendezvoused: no worker died of a
        # real failure (when one rank hits a deterministic error, its peers'
        # teardown noise can look like a rendezvous failure too, and a retry
        # would replay the same failure)
        retryable = timed_out or (not any(_has_real_failure(o) for o in outs)
                                  and any(_looks_like_rendezvous_failure(o) for o in outs))
        if not retryable or attempt == retries:
            break
    blob = "\n\n".join(f"--- worker {i} ---\n{o[-6000:]}" for i, o in enumerate(outs))
    raise RuntimeError(f"gang failed after {attempt + 1} attempt(s):\n{blob}")


def python_worker_argv(worker_path: str, process_id: int, port: int,
                       *args: object) -> Sequence[str]:
    return [sys.executable, worker_path, str(process_id), str(port), *[str(a) for a in args]]
