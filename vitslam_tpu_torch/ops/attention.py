"""Attention routing and dispatch (port of vitslam_tpu/ops/attention.py plus
the routing of vitslam_tpu/nn/layers.py:404-478).

Routes, at the reference's thresholds, with the backward each one takes:

* ``fused`` — qkv-packed self-attention over 384..4096 tokens whose q/k prep
  is either LayerNorm + a RoPE cache or nothing at all: kernel K1
  (``ops.fused_attention.fused_qkv_attention``); backward by autograd
  through its plain version (the reference's ``_fused_bwd`` recompute).
* ``flat`` — qk-normed attention with RoPE caches over more than 4096 keys:
  kernel K2 (``ops.fused_attention.flat_flash_attention``), called by
  ``nn.layers.Attention`` on the flat layout; backward by autograd through
  its plain version (``_flat_bwd``).
* ``flash`` — any other attention with 512 or more keys: kernel K3
  (``ops.flash_attention.flash_attention``), with its lse output when a
  gradient is needed; backward kernel K4.
* ``plain`` — everything else: plain math, as the reference leaves it to
  XLA; backward by autograd.

On a CPU tensor every kernel wrapper runs its plain version.
``plain_attention_routes()`` switches the kernels off for a block of code:
the fused and flat routes become ``plain``, and the flash route becomes
``reference`` (the plain versions of K3 and K4, which keep the backward's
memory O(N)); chip_smoke.py and the tests use it to hold the kernel path
of a train step against the same step without kernels.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch
import torch.utils.checkpoint

from .flash_attention import flash_attention, flash_attention_reference
from .flash_attention import flash_attention_plain as plain_attention

FUSED_MIN_TOKENS = 384
FUSED_MAX_TOKENS = 4096
FLASH_MIN_KV = 512

# how often each route was taken in this process (tests and chip_smoke.py
# read it to show which path a model run went through)
ROUTE_COUNTS: Counter = Counter()
_KERNELS_OFF = [False]

__all__ = ["ROUTE_COUNTS", "attention_route", "plain_attention", "plain_attention_routes",
           "remat", "scaled_dot_product_attention"]


@contextlib.contextmanager
def plain_attention_routes(enabled: bool = True):
    """Within the block (when ``enabled``), route every attention around
    the kernels: fused and flat -> ``plain``, flash -> ``reference``."""
    before = _KERNELS_OFF[0]
    _KERNELS_OFF[0] = before or enabled
    try:
        yield
    finally:
        _KERNELS_OFF[0] = before


@contextlib.contextmanager
def _routes_as(kernels_off: bool):
    before = _KERNELS_OFF[0]
    _KERNELS_OFF[0] = kernels_off
    try:
        yield
    finally:
        _KERNELS_OFF[0] = before


def remat(enabled: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; when ``enabled`` and gradients are on, under
    non-reentrant ``torch.utils.checkpoint`` (the reference's ``nn.remat``):
    the activations inside are freed after the forward and recomputed in
    the backward. The recomputation takes the attention routes the forward
    took, since the backward may run outside the ``plain_attention_routes``
    block the forward ran in."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    off = _KERNELS_OFF[0]
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _routes_as(off)), **kwargs)


def attention_route(n_q: int, n_kv: int, *, fusable: bool, fast: bool) -> str:
    """Pick the route for an attention with ``n_q`` queries and ``n_kv`` keys.

    fusable: qkv-packed self-attention whose prep the fused kernel can do
        (LayerNorm + RoPE cache, or no prep at all);
    fast: qk-normed with RoPE caches (the flat-layout prep path)."""
    if fusable and n_q == n_kv and FUSED_MIN_TOKENS <= n_q <= FUSED_MAX_TOKENS:
        route = "fused"
    elif fast and n_kv > FUSED_MAX_TOKENS:
        route = "flat"
    elif n_kv >= FLASH_MIN_KV:
        route = "flash"
    else:
        route = "plain"
    if _KERNELS_OFF[0]:
        return "reference" if route == "flash" else "plain"
    return route


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 route: str = "plain", static_max=None) -> torch.Tensor:
    """Attention over (B, H, Nq, D) queries and (B, H, Nk, D) keys/values on
    the ``flash`` route (K3, fixed shift ``static_max`` or an online max),
    the ``reference`` route (its plain version, with the plain flash
    backward) or the ``plain`` route."""
    if route == "flash":
        return flash_attention(q, k, v, static_max=static_max)
    if route == "reference":
        return flash_attention_reference(q, k, v)
    if route != "plain":
        raise ValueError(f"route {route!r} does not take (B, H, N, D) attention")
    return plain_attention(q, k, v)
