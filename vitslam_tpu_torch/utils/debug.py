"""Opt-in NaN/Inf checks (port of vitslam_tpu/utils/debug.py).

``nan_check(tree, name)`` counts the non-finite elements of every floating
tensor in ``tree`` (a tensor, or dicts, lists and tuples of them) on the
tensor's device and logs a warning naming the leaf, or raises
``FloatingPointError``. Off, it returns ``tree`` at once: no launch and no
host sync. On, each checked leaf costs a reduction and a host sync (the
count is read back). Switched on by ``VITSLAM_DEBUG_NANS=1`` (raising with
``VITSLAM_DEBUG_NANS_RAISE=1``), read when this module is imported, or by
``enable_nan_checks``.
"""
from __future__ import annotations

import logging
import os

import torch

_ENABLED = os.environ.get("VITSLAM_DEBUG_NANS", "0") == "1"
_RAISE = os.environ.get("VITSLAM_DEBUG_NANS_RAISE", "0") == "1"
logger = logging.getLogger(__name__)


def enable_nan_checks(enabled: bool = True, raise_on_nan: bool = False):
    global _ENABLED, _RAISE
    _ENABLED = enabled
    _RAISE = raise_on_nan


def nan_checks_enabled() -> bool:
    return _ENABLED


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _report(name: str, bad: int):
    if bad:
        msg = f"NaN/Inf detected in {name}: {bad} bad elements"
        if _RAISE:
            raise FloatingPointError(msg)
        logger.warning(msg)


def nan_check(tree, name: str = "tensor"):
    """Check every floating leaf of ``tree`` for NaN/Inf; returns ``tree``
    unchanged, so it can be used inline."""
    if not _ENABLED:
        return tree
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            _report(f"{name}[{i}]", int((~torch.isfinite(leaf)).sum()))
    return tree
