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

The kernel takes any F and C that are multiples of 8 (C up to 4,096 with
the LayerNorm); the wrapper zero-pads other widths (zero h columns and W
columns along F; zero W rows, b, res, gamma and beta along C, the outputs
sliced back, the LayerNorm told the true width). Unlike the reference's
Pallas kernel, which sums only the first F // 1024 blocks of 1,024 when F
is above 1,024 and not a multiple of it (F 1,536: a third of the
reduction dropped), it sums all of F: the port computes
``mlp_tail_reference``'s function, not that fault.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import _needs_grad

LN_EPS = 1e-6
KERNEL_K_TILE = 64       # F per K slice; the last slice is zero-filled past F
KERNEL_N_TILE = 256      # one CTA's output columns; the last tile is clipped at C
KERNEL_MAX_CLUSTER = 16  # with the LayerNorm a cluster of ceil(C / 256) CTAs spans C
KERNEL_MAX_SMEM = 232448
WIDTH_MULTIPLE = 8       # the TMA maps' 16-byte rows: other F and C are zero-padded


def padded_width(n: int) -> int:
    """n rounded up to a multiple of WIDTH_MULTIPLE: the width the kernel
    is handed (zero-padded by the wrapper when it differs)."""
    return -(-n // WIDTH_MULTIPLE) * WIDTH_MULTIPLE


def check_k5_shape(M: int, F: int, C: int, ln: bool) -> None:
    """Raise ValueError on a shape ``mlp_tail`` does not take on the card,
    naming it: no rows, an empty F or C, or with the LayerNorm C above
    4,096 (a cluster along C of more than 16 CTAs)."""
    if M < 1 or F < 1 or C < 1:
        raise ValueError(f"mlp_tail kernel takes at least one row, F and C, got M {M}, F {F}, "
                         f"C {C}")
    if ln and -(-padded_width(C) // KERNEL_N_TILE) > KERNEL_MAX_CLUSTER:
        raise ValueError(f"mlp_tail kernel's LayerNorm takes C <= "
                         f"{KERNEL_MAX_CLUSTER * KERNEL_N_TILE}, got C {C}")


def k5_schedule(M: int, F: int, C: int, gelu: bool, ln: bool, sms: int) -> dict:
    """The launch ``csrc/mlp_tail.cu`` makes for an (M, F) x (F, C) tail on
    a card of ``sms`` SMs (the kernel reads the count from the card; the
    H100 has 132) at F and C padded to multiples of 8 (``padded``): 64 x
    256 output tiles (one consumer warpgroup) while they need at most two
    waves, else 128 x 256 (two), the last column tile clipped at C; one
    producer warpgroup, and with the gelu and one consumer warpgroup a gelu
    warpgroup; a ring of 5 or 4 stages of 64-wide K slices (``k_slices``,
    the last zero-filled past F); with the LayerNorm a cluster of
    ceil(C / 256) CTAs along C (non-portable above 8). Raises ValueError on
    a shape the wrapper does not take (``check_k5_shape``)."""
    check_k5_shape(M, F, C, ln)
    Fs, Cs = padded_width(F), padded_width(C)
    col_tiles = -(-Cs // KERNEL_N_TILE)
    warpgroups = 1 if -(-M // 64) * col_tiles <= 2 * sms else 2
    tile_m = 64 * warpgroups
    stages = 5 if warpgroups == 1 else 4
    ctas = -(-M // tile_m) * col_tiles
    stage_bytes = (tile_m + KERNEL_N_TILE) * KERNEL_K_TILE * 2
    smem = stages * stage_bytes + 2 * tile_m * 4 + 24 * stages + 1024
    gelu_warpgroup = int(gelu and warpgroups == 1)
    return dict(tile=(tile_m, KERNEL_N_TILE), grid=(-(-M // tile_m), col_tiles), ctas=ctas,
                threads=128 * (warpgroups + 1 + gelu_warpgroup), stages=stages,
                smem_bytes=smem, cluster=col_tiles if ln else 1, waves=-(-ctas // sms),
                padded=(Fs, Cs), k_slices=-(-Fs // KERNEL_K_TILE))


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
    check_k5_shape(M, Fd, C, ln)
    dev = h.device
    Fs, Cs = padded_width(Fd), padded_width(C)
    if Fs != Fd:  # zero h and W columns add nothing (gelu(0) = 0)
        h, w2 = F.pad(h, (0, Fs - Fd)), F.pad(w2, (0, Fs - Fd))
    if Cs != C:  # zero W rows, b and res: x' is 0 there, outside the LayerNorm's C
        w2, res = F.pad(w2, (0, 0, 0, Cs - C)), F.pad(res, (0, Cs - C))

    def vec(t):
        t = t.detach().to(device=dev, dtype=torch.float32).reshape(C)
        return (F.pad(t, (0, Cs - C)) if Cs != C else t).contiguous()

    b = vec(b2)
    x = torch.empty((M, Cs), dtype=torch.bfloat16, device=dev)
    g = bt = y = None
    if ln:
        g, bt = vec(gamma), vec(beta)
        y = torch.empty((M, Cs), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = library("mlp_tail").vitslam_mlp_tail_bf16(
            h.data_ptr(), w2.data_ptr(), b.data_ptr(), res.data_ptr(), ptr(g), ptr(bt),
            x.data_ptr(), ptr(y), M, Fs, Cs, C, int(gelu), int(ln), float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp_tail kernel launch failed: CUDA error {err}")
    mlp_tail.launches += 1
    if Cs != C:
        x, y = x[:, :C], None if y is None else y[:, :C]
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
    res, contiguous; any F and C, C <= 4096 with ``ln``; widths that are not
    multiples of 8 on zero-padded copies), or an error; differentiable in
    every tensor argument, with the backward
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
