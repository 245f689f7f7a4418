"""Host-to-device copies that do not make the host wait for the device.

A blocking copy of pageable host memory to a CUDA tensor synchronises the
stream: the host then waits for every kernel it queued before, and the
device idles while the host queues the next ones. ``to_device`` stages the
data in pinned memory (torch's caching host allocator, which keeps a block
until the copy that reads it has run) and copies it without blocking.
"""
from __future__ import annotations

import torch


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` (a numpy array, a tensor or a nested list) as a tensor on
    ``device``, with ``dtype`` if given; values as ``torch.as_tensor``
    gives them."""
    t = torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
