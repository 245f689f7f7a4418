"""Fused dense block tail (port of vitslam_tpu/ops/mlp_tail.py, kernel K5):
x' = res + act(h) W^T + b in fp32, and optionally y = LayerNorm(x').

``mlp_tail`` launches the hand-written Hopper kernel in ``csrc/mlp_tail.cu``
on a CUDA tensor (or raises), and runs ``mlp_tail_plain``, the plain
PyTorch version of the same math, on a CPU tensor. The two block sites that
use it (``nn.layers.dense_tail``):

* ``ln=True``: the attention's output projection + LayerScale + residual,
  returning x' (the next residual input) and y = LN(x') (the MLP's input);
* ``ln=False``, ``gelu=True``: gelu + fc2 + LayerScale + residual, whose
  LayerNorm (the next block's norm1) stays outside.

LayerScale is folded into W and b by the caller. W is the port's (C, F)
torch weight (the reference takes (F, C)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import _needs_grad

LN_EPS = 1e-6
KERNEL_K_TILE = 64     # F must be a multiple of it
KERNEL_N_TILE = 128    # C must be a multiple of it
KERNEL_LN_ROWS = 32    # rows per CTA with the LayerNorm: 32 fp32 rows of x' in shared memory
KERNEL_MAX_SMEM = 232448


def mlp_tail_plain(h, w2, b2, res, gamma=None, beta=None, *, eps: float = LN_EPS,
                   gelu: bool = False, ln: bool = True):
    """Plain PyTorch version of K5, step by step as ``mlp_tail_reference``:
    exact gelu in fp32 cast back to h's dtype, the product of h and W
    upcast to fp32, plus b and res in fp32; with ``ln`` the row mean, the
    centered variance, rsqrt(var + eps), gamma and beta; outputs in h's
    dtype. Returns (x', y) with ``ln``, else x'."""
    if gelu:
        h = F.gelu(h.float()).to(h.dtype)
    x = h.float() @ w2.float().t() + b2.float() + res.float()
    if not ln:
        return x.to(h.dtype)
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return x.to(h.dtype), y.to(h.dtype)


def _ln_smem_bytes(C: int) -> int:
    tiles = 2 * (KERNEL_LN_ROWS + KERNEL_N_TILE) * (KERNEL_K_TILE + 8) * 2
    return tiles + KERNEL_LN_ROWS * (C + 4) * 4


def _launch(h, w2, b2, res, gamma, beta, eps, gelu, ln):
    from .cuda_build import library

    if h.dim() != 2 or w2.dim() != 2 or res.dim() != 2:
        raise ValueError("mlp_tail kernel takes 2-D h (M, F), w2 (C, F) and res (M, C)")
    M, Fd = h.shape
    C = w2.shape[0]
    if w2.shape[1] != Fd or tuple(res.shape) != (M, C) or b2.numel() != C:
        raise ValueError(f"mlp_tail shapes do not match: h {tuple(h.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}, res {tuple(res.shape)}")
    for name, t in (("h", h), ("w2", w2), ("res", res)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mlp_tail kernel takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"mlp_tail kernel takes a contiguous, 16-byte aligned {name}")
    if Fd % KERNEL_K_TILE or C % KERNEL_N_TILE:
        raise ValueError(f"mlp_tail kernel takes F a multiple of {KERNEL_K_TILE} and C a "
                         f"multiple of {KERNEL_N_TILE}, got F {Fd}, C {C}")
    if ln and _ln_smem_bytes(C) > KERNEL_MAX_SMEM:
        raise ValueError(f"mlp_tail kernel's LayerNorm takes C <= 1408, got {C}")
    if M < 1:
        raise ValueError("mlp_tail kernel takes at least one row")
    dev = h.device
    vec = lambda t: t.detach().to(device=dev, dtype=torch.float32).reshape(C).contiguous()  # noqa: E731
    b = vec(b2)
    x = torch.empty((M, C), dtype=torch.bfloat16, device=dev)
    g = bt = y = None
    if ln:
        g, bt = vec(gamma), vec(beta)
        y = torch.empty((M, C), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = library("mlp_tail").vitslam_mlp_tail_bf16(
            h.data_ptr(), w2.data_ptr(), b.data_ptr(), res.data_ptr(), ptr(g), ptr(bt),
            x.data_ptr(), ptr(y), M, Fd, C, int(gelu), int(ln), float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp_tail kernel launch failed: CUDA error {err}")
    mlp_tail.launches += 1
    return (x, y) if ln else x


class _MlpTail(torch.autograd.Function):
    """K5 forward, backward by autograd through ``mlp_tail_plain`` (the
    reference's ``_mlp_tail_bwd`` recomputes through ``mlp_tail_reference``
    the same way)."""

    @staticmethod
    def forward(ctx, h, w2, b2, res, gamma, beta, eps, gelu, ln):
        ctx.kw = dict(eps=eps, gelu=gelu, ln=ln)
        ctx.save_for_backward(h, w2, b2, res, gamma, beta)
        return _launch(h, w2, b2, res, gamma, beta, eps, gelu, ln)

    @staticmethod
    def backward(ctx, *grads):
        leaves = [None if t is None else t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = mlp_tail_plain(*leaves, **ctx.kw)
            outs = out if ctx.kw["ln"] else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs]))
        return (*(next(got) if t is not None and t.requires_grad else None for t in leaves),
                None, None, None)


def mlp_tail(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, res: torch.Tensor,
             gamma=None, beta=None, *, eps: float = LN_EPS, gelu: bool = False,
             ln: bool = True):
    """(M, F) h, (C, F) w2, (C,) b2, (M, C) res: x' = res + act(h) w2^T + b2,
    act = exact gelu with ``gelu``; returns (x', LayerNorm(x'; gamma, beta))
    with ``ln``, else x'.

    CPU tensor: the plain version. CUDA tensor: the kernel (bf16 h, w2 and
    res, contiguous; F a multiple of 64, C of 128, C <= 1408 with ``ln``),
    or an error; differentiable in every tensor argument, with the backward
    recomputed through the plain version. ``mlp_tail.launches`` counts
    kernel launches."""
    if ln and (gamma is None or beta is None):
        raise ValueError("mlp_tail with ln=True needs gamma and beta")
    if h.device.type == "cpu":
        return mlp_tail_plain(h, w2, b2, res, gamma, beta, eps=eps, gelu=gelu, ln=ln)
    if h.device.type != "cuda":
        raise ValueError(f"mlp_tail runs on cpu or cuda, not {h.device}")
    args = (h, w2, b2, res, gamma, beta)
    if _needs_grad(*args):
        return _MlpTail.apply(*args, eps, gelu, ln)
    return _launch(*args, eps, gelu, ln)


mlp_tail.launches = 0
