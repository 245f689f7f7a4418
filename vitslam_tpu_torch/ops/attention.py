"""Attention routing and dispatch (port of vitslam_tpu/ops/attention.py plus
the routing of vitslam_tpu/nn/layers.py:404-478).

Routes, at the reference's thresholds:

* ``fused`` — qkv-packed self-attention over 384..4096 tokens whose q/k prep
  is either LayerNorm + a RoPE cache or nothing at all: kernel K1
  (``ops.fused_attention.fused_qkv_attention``).
* ``flat`` — qk-normed self-attention with a RoPE cache over more than 4096
  keys: kernel K2 (the flat streaming kernel) in the reference.
* ``flash`` — any other attention with 512 or more keys: kernel K3 (the
  flash kernel) in the reference.
* ``plain`` — everything else: plain math, as the reference leaves it to XLA.

K2 and K3 are not ported yet (ROADMAP.md, queue 2). On CUDA their routes
raise ``NotImplementedError`` rather than silently running plain math; on
CPU they run plain math, so the reference's test shapes still run.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

FUSED_MIN_TOKENS = 384
FUSED_MAX_TOKENS = 4096
FLASH_MIN_KV = 512

# how often each route was taken in this process (tests and chip_smoke.py
# read it to show which path a model run went through)
ROUTE_COUNTS: Counter = Counter()

_UNPORTED = {
    "flat": "K2 (vitslam_tpu/ops/fused_attention.py::_flat_stream_tns_kernel)",
    "flash": "K3 (vitslam_tpu/ops/flash_attention.py::_flash_kernel)",
}


def attention_route(n_q: int, n_kv: int, *, fusable: bool, fast: bool) -> str:
    """Pick the route for an attention with ``n_q`` queries and ``n_kv`` keys.

    fusable: qkv-packed self-attention whose prep the fused kernel can do
        (LayerNorm + RoPE cache, or no prep at all);
    fast: qk-normed with a RoPE cache (the flat-layout prep path)."""
    if fusable and n_q == n_kv and FUSED_MIN_TOKENS <= n_q <= FUSED_MAX_TOKENS:
        return "fused"
    if fast and n_kv > FUSED_MAX_TOKENS:
        return "flat"
    if n_kv >= FLASH_MIN_KV:
        return "flash"
    return "plain"


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, Nq, D) / (B, H, Nk, D):
    logits and softmax in fp32, probabilities cast to v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, route: str = "plain") -> torch.Tensor:
    """Attention over (B, H, Nq, D) queries and (B, H, Nk, D) keys/values
    on a non-fused route."""
    if route in _UNPORTED and q.device.type == "cuda":
        raise NotImplementedError(
            f"the {route!r} attention route (Nk={k.shape[2]}) needs kernel "
            f"{_UNPORTED[route]}, which is not ported yet (ROADMAP.md queue 2)")
    if route not in ("plain", *_UNPORTED):
        raise ValueError(f"unknown attention route {route!r}")
    return plain_attention(q, k, v)
