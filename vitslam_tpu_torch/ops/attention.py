"""Attention routing and dispatch (port of vitslam_tpu/ops/attention.py plus
the routing of vitslam_tpu/nn/layers.py:404-478).

Routes, at the reference's thresholds:

* ``fused`` — qkv-packed self-attention over 384..4096 tokens whose q/k prep
  is either LayerNorm + a RoPE cache or nothing at all: kernel K1
  (``ops.fused_attention.fused_qkv_attention``).
* ``flat`` — qk-normed attention with RoPE caches over more than 4096 keys:
  kernel K2 (``ops.fused_attention.flat_flash_attention``), called by
  ``nn.layers.Attention`` on the flat layout.
* ``flash`` — any other attention with 512 or more keys: kernel K3
  (``ops.flash_attention.flash_attention``).
* ``plain`` — everything else: plain math, as the reference leaves it to XLA.

On a CPU tensor every kernel wrapper runs its plain version.
"""
from __future__ import annotations

from collections import Counter

import torch

from .flash_attention import flash_attention
from .flash_attention import flash_attention_plain as plain_attention

FUSED_MIN_TOKENS = 384
FUSED_MAX_TOKENS = 4096
FLASH_MIN_KV = 512

# how often each route was taken in this process (tests and chip_smoke.py
# read it to show which path a model run went through)
ROUTE_COUNTS: Counter = Counter()

__all__ = ["ROUTE_COUNTS", "attention_route", "plain_attention",
           "scaled_dot_product_attention"]


def attention_route(n_q: int, n_kv: int, *, fusable: bool, fast: bool) -> str:
    """Pick the route for an attention with ``n_q`` queries and ``n_kv`` keys.

    fusable: qkv-packed self-attention whose prep the fused kernel can do
        (LayerNorm + RoPE cache, or no prep at all);
    fast: qk-normed with RoPE caches (the flat-layout prep path)."""
    if fusable and n_q == n_kv and FUSED_MIN_TOKENS <= n_q <= FUSED_MAX_TOKENS:
        return "fused"
    if fast and n_kv > FUSED_MAX_TOKENS:
        return "flat"
    if n_kv >= FLASH_MIN_KV:
        return "flash"
    return "plain"


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 route: str = "plain", static_max=None) -> torch.Tensor:
    """Attention over (B, H, Nq, D) queries and (B, H, Nk, D) keys/values on
    the ``flash`` route (K3, fixed shift ``static_max`` or an online max) or
    the ``plain`` route."""
    if route == "flash":
        return flash_attention(q, k, v, static_max=static_max)
    if route != "plain":
        raise ValueError(f"route {route!r} does not take (B, H, N, D) attention")
    return plain_attention(q, k, v)
