"""int8 projections of the frozen backbone, the opt-in serving mode (port of
vitslam_tpu/ops/quant.py).

Dynamic symmetric quantisation: activations are scaled per row (max-abs
over the feature axis), weights per output column, both rounded half to
even after a division by the scale and clipped to [-127, 127]. The scale is
max-abs times the fp32 reciprocal of 127: the reference divides by 127, and
XLA compiles a division by a constant into that product, so this is what
the reference computes as it runs (under jit); it is also what torch
computes for ``/ 127`` on the card but not on the CPU, so the port writes
the product on both and gives the same integers on both. The int8
product accumulates in int32 (``torch._int_mm``: cuBLASLt on the card) and
is rescaled in fp32 as (y * x_scale) * w_scale, then the fp32 bias is added
and the result cast to the compute dtype. The model switches it on for the
backbone's blocks (``nn.layers.set_int8``); the default path stays bf16.

Serving only: the backbone is frozen, and no function here has a gradient.
A call that autograd would have to differentiate raises (the reference's
straight-through rounding is not ported).
"""
from __future__ import annotations

import torch

QMAX = 127.0
INV_QMAX = 1.0 / QMAX
MIN_SCALE = 1e-12
# torch._int_mm's rules on a CUDA tensor: more than 16 rows, K and N
# multiples of 8
CUDA_MIN_ROWS = 17
CUDA_MULTIPLE = 8


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K) -> int8 values and the per-row fp32 scale (..., 1)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) * INV_QMAX).clamp_min(MIN_SCALE)
    return torch.round(xf / scale).clamp_(-QMAX, QMAX).to(torch.int8), scale


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) weight -> int8 values (in w's memory layout) and the
    per-column fp32 scale (1, N). Quantise the fp32 parameter: its bf16
    copy gives other integers."""
    wf = w.float()
    scale = (wf.abs().amax(dim=0, keepdim=True) * INV_QMAX).clamp_min(MIN_SCALE)
    return torch.round(wf / scale).clamp_(-QMAX, QMAX).to(torch.int8), scale


def check_int_mm_shape(M: int, K: int, N: int) -> None:
    """Raise ValueError on an (M, K) x (K, N) product ``torch._int_mm``
    does not take on the card."""
    if M < CUDA_MIN_ROWS or K % CUDA_MULTIPLE or N % CUDA_MULTIPLE:
        raise ValueError(f"int8 projection on the card takes more than {CUDA_MIN_ROWS - 1} "
                         f"rows and K, N multiples of {CUDA_MULTIPLE}, got M {M}, K {K}, N {N}")


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact."""
    if xq.is_cuda:
        check_int_mm_shape(xq.shape[0], xq.shape[1], wq.shape[1])
    return torch._int_mm(xq, wq)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, bias=None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) @ w (K, N) through int8 with the dynamic rescale. A
    transposed view of the port's (N, K) weight keeps its quantised copy
    column-major, the layout cuBLASLt's int8 GEMM takes."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, bias)):
        raise RuntimeError("int8_matmul has no gradient (serving only): run the int8 "
                           "backbone frozen or under torch.no_grad()")
    K, N = w.shape
    xq, xs = quantize_rows(x.reshape(-1, K))
    wq, ws = quantize_cols(w)
    y = (int_mm(xq, wq) * xs) * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], N)
