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
product accumulates in int32 (``torch._int_mm``: cuBLASLt on the card; a
shape it refuses there, fewer than 17 rows or K or N not a multiple of 8,
is zero-padded up to one it takes and the product sliced back, which is
exact in int32) and
is rescaled in fp32 as (y * x_scale) * w_scale, then the fp32 bias is added
and the result cast to the compute dtype. The model switches it on for the
backbone's blocks (``nn.layers.set_int8``); the default path stays bf16.

The gradient is the reference's, which is not a straight-through one: its
rounding goes through an int8 cast, whose gradient is zero, so the int32
product is a constant and the gradient flows through the fp32 scales and
the bias alone. ``int8_matmul``'s backward is that of y = (yq * xs) * ws + b
with yq constant, through xs = max(amax|x| * (1/127), 1e-12) per row and ws
likewise per column: d/dx is nonzero only at each row's largest |x| (ties
share it, as JAX's max does), d/dw only at each column's largest |w|, d/db
is dense.
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
    does not take on the card (``int_mm`` pads such a product first)."""
    if M < CUDA_MIN_ROWS or K % CUDA_MULTIPLE or N % CUDA_MULTIPLE:
        raise ValueError(f"int8 projection on the card takes more than {CUDA_MIN_ROWS - 1} "
                         f"rows and K, N multiples of {CUDA_MULTIPLE}, got M {M}, K {K}, N {N}")


def int_mm_padding(M: int, K: int, N: int) -> tuple[int, int, int]:
    """The (M, K, N) that ``int_mm`` hands ``torch._int_mm`` on the card:
    at least 17 rows, K and N rounded up to multiples of 8."""
    up = lambda n: -(-n // CUDA_MULTIPLE) * CUDA_MULTIPLE  # noqa: E731
    return max(M, CUDA_MIN_ROWS), up(K), up(N)


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact. On the card a
    shape ``torch._int_mm`` refuses runs zero-padded to
    ``int_mm_padding``'s and is sliced back: zero rows and columns add 0 to
    every int32 sum, so the result is the unpadded product bit for bit."""
    M, K = xq.shape
    N = wq.shape[1]
    if xq.is_cuda:
        padded = int_mm_padding(M, K, N)
        if padded != (M, K, N):
            return int_mm_padded(xq, wq, *padded)
    return torch._int_mm(xq, wq)


def int_mm_padded(xq: torch.Tensor, wq: torch.Tensor, Mp: int, Kp: int, Np: int) -> torch.Tensor:
    """``torch._int_mm`` of xq and wq zero-padded to (Mp, Kp) and (Kp, Np)
    (the padded weight column-major, as the caller's), sliced back to
    (M, N)."""
    M, K = xq.shape
    N = wq.shape[1]
    xp = xq.new_zeros((Mp, Kp))
    xp[:M, :K] = xq
    wp = wq.new_zeros((Np, Kp)).t()
    wp[:K, :N] = wq
    return torch._int_mm(xp, wp)[:M, :N]


def _through_scale(t: torch.Tensor, d_scale: torch.Tensor, dim: int) -> torch.Tensor:
    """The gradient of ``t`` from that of its scale max(amax|t| * (1/127),
    1e-12) along ``dim``, with JAX's rules: the max's gradient is shared by
    its ties, the clamp's is 1 above 1e-12, 1/2 at it and 0 below, and |t|'s
    is +1 at 0 (select(t >= 0, g, -g); only a zero row or column has its max
    at 0, and there the clamp passes nothing)."""
    tf = t.float()
    a = tf.abs()
    amax = a.amax(dim=dim, keepdim=True)
    raw = amax * INV_QMAX
    clamp = (raw > MIN_SCALE).float() + 0.5 * (raw == MIN_SCALE).float()
    at_max = (a == amax).float()
    d_amax = d_scale * INV_QMAX * clamp / at_max.sum(dim=dim, keepdim=True)
    return d_amax * at_max * torch.where(tf >= 0, 1.0, -1.0)


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, out_dtype):
        xq, xs = quantize_rows(x)
        wq, ws = quantize_cols(w)
        yq = int_mm(xq, wq)
        y = (yq * xs) * ws
        if bias is not None:
            y = y + bias.float()
        ctx.save_for_backward(x, w, yq, xs, ws)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, yq, xs, ws = ctx.saved_tensors
        g, p = g.float(), yq.float()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _through_scale(x, ((g * ws) * p).sum(dim=-1, keepdim=True), -1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _through_scale(w, (g * (p * xs)).sum(dim=0, keepdim=True), 0).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=0).to(ctx.bias_dtype)
        return dx, dw, db, None


def int8_matmul(x: torch.Tensor, w: torch.Tensor, bias=None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) @ w (K, N) through int8 with the dynamic rescale, with the
    reference's gradient (module docstring). A transposed view of the
    port's (N, K) weight keeps its quantised copy column-major, the layout
    cuBLASLt's int8 GEMM takes. ``int8_matmul.launches`` counts calls (one
    int8 product each)."""
    int8_matmul.launches += 1
    K, N = w.shape
    y = _Int8Matmul.apply(x.reshape(-1, K), w, bias, out_dtype)
    return y.reshape(*x.shape[:-1], N)


int8_matmul.launches = 0
