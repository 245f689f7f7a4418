"""Fused qkv-packed self-attention and flat streaming attention (port of
the K1 and K2 parts of vitslam_tpu/ops/fused_attention.py).

``fused_qkv_attention`` reads q/k/v per head straight out of the packed
(B, N, 3C) qkv projection, applies the optional per-head LayerNorm and
RoPE to q and k, and writes the attention output in the flat (B, N, C)
layout. On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/fused_attention.cu`` (or raises); on a CPU tensor it runs
``fused_qkv_attention_plain``, the plain PyTorch version of the same math.

``flat_flash_attention`` (K2) streams attention over q/k/v that were
already LayerNormed and rotated in the flat (B, N, C) layout, for more than
4096 keys; on CUDA it launches ``csrc/flash_attention.cu`` on strided views
of the flat tensors (no head relayout), on the CPU it runs
``flat_flash_attention_plain``.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import (
    LOG2E,
    _needs_grad,
    flash_attention_plain,
    launch_streaming,
    shift_tensor,
)

LN_EPS = 1e-6
KERNEL_HEAD_DIMS = (64,)
KERNEL_MAX_TOKENS = 4096


def fused_qkv_attention_plain(qkv, *, num_heads, cos=None, sin=None, q_ln=None,
                              k_ln=None, scale=None, static_max=None, nsplit=2):
    """Plain PyTorch version of the kernel's math (the counterpart of
    ``_fused_reference``): per-head LayerNorm and RoPE in fp32, q and k cast
    back to qkv's dtype, S = q k^T accumulated in fp32, softmax in fp32, P
    cast to qkv's dtype before P V. With fp32 qkv everything is fp32.
    ``static_max`` does not change the result (softmax is shift-invariant)."""
    from ..nn.rope import rotate_half_multi  # nn imports ops: bind at call time

    B, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    dh = C // h
    if scale is None:
        scale = 1.0 / math.sqrt(dh)

    def prep(x, ln):
        xf = x.float().reshape(B, N, h, dh)
        if ln is not None:
            mean = xf.mean(dim=-1, keepdim=True)
            var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
            xf = (xf - mean) * torch.rsqrt(var + LN_EPS)
            xf = xf * ln[0].float() + ln[1].float()
        if cos is not None:
            c = cos[..., :dh].float()[:, :, None]
            s = sin[..., :dh].float()[:, :, None]
            xf = xf * c + rotate_half_multi(xf, nsplit) * s
        return xf.transpose(1, 2).to(qkv.dtype)

    q = prep(qkv[..., :C], q_ln)
    k = prep(qkv[..., C:2 * C], k_ln)
    v = qkv[..., 2 * C:].reshape(B, N, h, dh).transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1)
    o = torch.matmul(p.to(v.dtype), v)
    return o.transpose(1, 2).reshape(B, N, C)


class _FusedQKV(torch.autograd.Function):
    """K1 forward, backward by autograd through ``fused_qkv_attention_plain``
    (the reference's ``_fused_bwd`` recomputes through ``_fused_reference``
    the same way). The LayerNorm params may require grad; the RoPE tables
    and the softmax shift never do."""

    @staticmethod
    def forward(ctx, qkv, q_w, q_b, k_w, k_b, cos, sin, static_max, kw):
        ln = {} if q_w is None else dict(q_ln=(q_w, q_b), k_ln=(k_w, k_b))
        ctx.kw = dict(kw, cos=cos, sin=sin, static_max=static_max)
        ctx.save_for_backward(qkv, q_w, q_b, k_w, k_b)
        return _launch(qkv, **ln, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_(t.requires_grad)
                  for t in saved]
        qkv, q_w, q_b, k_w, k_b = leaves
        ln = {} if q_w is None else dict(q_ln=(q_w, q_b), k_ln=(k_w, k_b))
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = fused_qkv_attention_plain(qkv, **ln, **ctx.kw)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in leaves),
                None, None, None, None)


def _launch(qkv, *, num_heads, cos, sin, q_ln=None, k_ln=None, scale, static_max, nsplit):
    from .cuda_build import library

    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or C % num_heads:
        raise ValueError(f"qkv width {C3} is not 3 * num_heads * dh")
    dh = C // num_heads
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"fused_qkv_attention kernel takes bf16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention kernel takes a contiguous qkv")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_qkv_attention kernel supports head dim "
                         f"{KERNEL_HEAD_DIMS}, got {dh}")
    if not 1 <= N <= KERNEL_MAX_TOKENS:
        raise ValueError(f"fused_qkv_attention kernel takes 1..{KERNEL_MAX_TOKENS} "
                         f"tokens, got {N}")
    if nsplit not in (1, 2):
        raise ValueError(f"RoPE nsplit must be 1 or 2, got {nsplit}")
    if (cos is None) != (sin is None) or (q_ln is None) != (k_ln is None):
        raise ValueError("cos/sin and q_ln/k_ln come in pairs")
    dev = qkv.device
    # the tables below are stream-ordered allocations: freeing them after
    # the launch is safe, the allocator reuses them only behind this kernel
    cos_p = sin_p = ln_p = shift_p = None
    if cos is not None:
        tabs = []
        for t in (cos, sin):
            if t.shape[:2] != (B, N) or t.shape[-1] not in (dh, C):
                raise ValueError(f"RoPE table shape {tuple(t.shape)} does not "
                                 f"match qkv {tuple(qkv.shape)}")
            tabs.append(t[..., :dh].to(device=dev, dtype=torch.float32).contiguous())
        cos_p, sin_p = tabs[0].data_ptr(), tabs[1].data_ptr()
    if q_ln is not None:
        ln = torch.cat([torch.as_tensor(x, device=dev).float().reshape(dh)
                        for x in (*q_ln, *k_ln)]).contiguous()
        ln_p = ln.data_ptr()
    if static_max is not None:
        shift = shift_tensor(static_max, dev)
        shift_p = shift.data_ptr()
    out = torch.empty((B, N, C), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = library("fused_attention").vitslam_fused_qkv_attention_bf16(
            qkv.data_ptr(), out.data_ptr(), cos_p, sin_p, ln_p, shift_p,
            B, N, num_heads, dh, nsplit, float(scale * LOG2E),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qkv_attention kernel launch failed: CUDA error {err}")
    fused_qkv_attention.launches += 1
    return out


def fused_qkv_attention(qkv: torch.Tensor, *, num_heads: int, cos=None, sin=None,
                        q_ln=None, k_ln=None, scale: float | None = None,
                        static_max=None, nsplit: int = 2) -> torch.Tensor:
    """Self-attention straight from the packed qkv projection.

    qkv: (B, N, 3C) laid out [q | k | v]; cos/sin: RoPE tables (B, N, dh) or
    head-tiled (B, N, C); q_ln/k_ln: per-head LayerNorm (scale, bias), each
    (dh,); static_max: the qk-norm logit bound (fixed softmax shift), or None
    for an online row max. Returns (B, N, C).

    CPU tensor: the plain version. CUDA tensor: the kernel (bf16, dh 64,
    N <= 4096, contiguous), or an error; differentiable in qkv and the
    LayerNorm params, with the backward recomputed through the plain
    version. ``fused_qkv_attention.launches`` counts kernel launches."""
    dh = qkv.shape[-1] // 3 // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    kw = dict(num_heads=num_heads, cos=cos, sin=sin, q_ln=q_ln, k_ln=k_ln,
              scale=scale, static_max=static_max, nsplit=nsplit)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention runs on cpu or cuda, not {qkv.device}")
    ln = [*(q_ln or (None, None)), *(k_ln or (None, None))]
    if _needs_grad(qkv, *ln):
        del kw["q_ln"], kw["k_ln"], kw["cos"], kw["sin"], kw["static_max"]
        if isinstance(static_max, torch.Tensor):
            static_max = static_max.detach()
        return _FusedQKV.apply(qkv, *ln, cos, sin, static_max, kw)
    return _launch(qkv, **kw)


fused_qkv_attention.launches = 0


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> a (B, H, N, C // H) view."""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def flat_flash_attention_plain(q, k, v, *, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (the counterpart of ``_flat_reference``):
    q (B, Nq, C) carries scale * log2(e), so softmax(q k / log2(e)) is the
    kernel's exp2-domain softmax; k/v (B, Nk, C). Returns (B, Nq, C)."""
    B, nq, C = q.shape
    o = flash_attention_plain(_heads(q, num_heads), _heads(k, num_heads),
                              _heads(v, num_heads), scale=1.0 / LOG2E)
    return o.transpose(1, 2).reshape(B, nq, C)


def flat_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         num_heads: int, static_max) -> torch.Tensor:
    """Streaming attention on the flat (B, N, C) layout over q/k/v whose
    per-head LayerNorm and RoPE already ran; ``static_max`` is the qk-norm
    logit bound (the kernel's fixed softmax shift). log2(e) / sqrt(dh) is
    folded into q in fp32, then q is cast back (to bf16 for the kernel, as the
    reference does). Returns (B, Nq, C).

    CPU tensor: the plain version. CUDA tensor: the kernel (bf16 k/v, head
    dim 64, rows 16-byte aligned; v may be a strided slice of the qkv
    projection), or an error; differentiable in q, k and v, with the
    backward recomputed through the plain version.
    ``flat_flash_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        qs = (q.float() * (LOG2E / math.sqrt(q.shape[-1] // num_heads))).to(q.dtype)
        return flat_flash_attention_plain(qs, k, v, num_heads=num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flat_flash_attention runs on cpu or cuda, not {q.device}")
    if isinstance(static_max, torch.Tensor):
        static_max = static_max.detach()
    if _needs_grad(q, k, v):
        return _FlatFlash.apply(q, k, v, static_max, num_heads)
    return _launch_flat(q, k, v, static_max, num_heads)


flat_flash_attention.launches = 0


def _launch_flat(q, k, v, static_max, num_heads):
    B, nq, C = q.shape
    qs = (q.float() * (LOG2E / math.sqrt(C // num_heads))).to(torch.bfloat16)
    out = torch.empty((B, nq, C), dtype=torch.bfloat16, device=q.device)
    launch_streaming(_heads(qs, num_heads), _heads(k, num_heads), _heads(v, num_heads),
                     _heads(out, num_heads), shift_tensor(static_max, q.device))
    flat_flash_attention.launches += 1
    return out


class _FlatFlash(torch.autograd.Function):
    """K2 forward, backward by autograd through the scale fold and
    ``flat_flash_attention_plain`` (the reference's ``_flat_bwd`` recomputes
    through ``_flat_reference`` the same way). The shift is not
    differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, static_max, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        return _launch_flat(q, k, v, static_max, num_heads)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        q, k, v = leaves
        fold = LOG2E / math.sqrt(q.shape[-1] // ctx.num_heads)
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = flat_flash_attention_plain((q.float() * fold).to(q.dtype), k, v,
                                             num_heads=ctx.num_heads)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None)
