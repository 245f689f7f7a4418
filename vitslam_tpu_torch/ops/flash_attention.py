"""Streaming flash attention, forward and backward (port of K3 and K4 of
vitslam_tpu/ops/flash_attention.py), and the launcher that K2
(``ops.fused_attention.flat_flash_attention``) shares with the forward.

``flash_attention`` takes (B, H, Nq, D) queries and (B, H, Nk, D) keys and
values, self or cross (Nq != Nk), with a fixed softmax shift (``static_max``,
the qk-norm logit bound) or an online row max. On a CUDA tensor it launches
the hand-written Hopper kernel in ``csrc/flash_attention.cu`` (or raises);
on a CPU tensor it runs ``flash_attention_plain``, the plain PyTorch version
of the same math (the counterpart of ``_xla_attention``).

Gradients (the counterpart of the reference's custom VJP ``_flash``): when
an input requires grad, the forward also writes the log2-domain row
logsumexp (``flash_attention_lse``, K3's lse output), and the backward is
``flash_attention_backward`` (K4, ``csrc/flash_attention_bwd.cu``: the FA2
formulas from the saved output and lse). The softmax shift is never
differentiated (the reference's ``stop_gradient(smax)``).
"""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634  # log2(e): folded into q so the softmax is exp2
KERNEL_HEAD_DIMS = (64, 128)
# the plain versions compute their fp32 logits this many elements at a time
# (a block of query rows against all keys), so the 30,900-token global
# attention of the large-chunk slice fits the card
PLAIN_MAX_LOGITS = 1 << 28


def q_fold(dh: int) -> float:
    """scale * log2(e) for head dim dh: the factor every forward kernel folds
    into q in fp32 before one rounding to bf16 (the kernels compute the same
    double), and K4's wrapper folds the same way to rebuild P."""
    return LOG2E / math.sqrt(dh)


def static_max_operand(static_max, device) -> torch.Tensor:
    """The natural-log logit bound as an fp32 device scalar, the form the
    kernels read (they multiply it by log2(e) themselves, so a bound
    computed on the device never syncs and costs no launch here). A 1-element
    fp32 tensor on ``device`` is used as it is; anything else is converted."""
    t = torch.as_tensor(static_max).detach()
    if t.dtype != torch.float32 or t.device != device or t.numel() != 1:
        t = t.to(device=device, dtype=torch.float32)
    return t.reshape(1)


def _row_blocks(q: torch.Tensor, nk: int) -> int:
    """Query rows per block so that one block's logits stay under
    PLAIN_MAX_LOGITS; each row's softmax is independent of the others, so
    the blocking does not change the result."""
    return max(1, PLAIN_MAX_LOGITS // max(1, math.prod(q.shape[:-2]) * nk))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None, with_lse: bool = False):
    """softmax(q k^T * scale) v over (..., Nq, D) / (..., Nk, D): logits and
    softmax in fp32, probabilities cast to v's dtype before P V (as
    ``_xla_attention``). With ``with_lse`` also returns the (..., Nq) fp32
    log2 of the row sums of the exp2-domain logits (K3's lse output).
    Query rows are taken in blocks of at most PLAIN_MAX_LOGITS logits."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kt = k.float().transpose(-1, -2)
    rows = _row_blocks(q, k.shape[-2])
    outs, lses = [], []
    for i in range(0, q.shape[-2], rows):
        s = torch.matmul(q[..., i:i + rows, :].float(), kt) * scale
        outs.append(torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v))
        if with_lse:
            lses.append(torch.logsumexp(s, dim=-1) * LOG2E)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)
    if not with_lse:
        return out
    return out, (lses[0] if len(lses) == 1 else torch.cat(lses, dim=-1))


def flash_attention_backward_plain(q, k, v, out, lse, dout, scale: float | None = None):
    """The FA2 backward, written out in fp32 (the plain version of K4 and
    the counterpart of ``_flash_backward``): with s = q k^T * scale *
    log2(e), P = exp2(s - lse), D = rowsum(dO * O), dS = P * (dO v^T - D):
    dq = scale * dS k, dk = scale * dS^T q, dv = P^T dO. lse is (..., Nq)
    fp32 in the log2 domain. Query rows are taken in blocks of at most
    PLAIN_MAX_LOGITS logits; dk and dv sum over the blocks. Returns
    (dq, dk, dv) in q's, k's and v's dtypes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    dmat = (dout.float() * out.float()).sum(dim=-1)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    rows = _row_blocks(q, k.shape[-2])
    for i in range(0, q.shape[-2], rows):
        qb = q[..., i:i + rows, :].float()
        gb = dout[..., i:i + rows, :].float()
        p = torch.exp2(torch.matmul(qb, kf.transpose(-1, -2)) * (scale * LOG2E)
                       - lse[..., i:i + rows, None])
        ds = p * (torch.matmul(gb, vf.transpose(-1, -2)) - dmat[..., i:i + rows, None])
        dqs.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qb) * scale
        dv += torch.matmul(p.transpose(-1, -2), gb)
    dq = dqs[0] if len(dqs) == 1 else torch.cat(dqs, dim=-2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


TMA_BOX_COLS = 64   # head-dim columns per TMA box: one 128-byte swizzle row
TMA_BOX_ROWS = 128  # tokens per box: the kernels' Q and K/V tiles
TMA_SWIZZLE = 128   # bytes


def tma_geometry(t: torch.Tensor) -> dict:
    """The tensor map the attention kernels encode for a (B, H, N, D) bf16
    view (``csrc/attention_fwd_sm90.cuh::make_map``): dims (D, N, H, B)
    innermost first, byte strides of the token, head and batch dims (an
    extent-1 head or batch dim takes the token stride, since it is never
    stepped), boxes of 64 columns by 128 rows, 128-byte swizzle, zero fill
    out of bounds. Raises ValueError on what TMA does not take: a head dim
    other than 64 or 128, a strided head dim, byte strides or a base address
    not 16-byte aligned, strides of 2^40 bytes or more."""
    if t.dim() != 4 or t.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"TMA view must be (B, H, N, D) with D in {KERNEL_HEAD_DIMS}, "
                         f"got {tuple(t.shape)}")
    B, H, N, D = t.shape
    sb, sh, sn, sd = t.stride()
    es = t.element_size()
    row = sn * es
    strides = (row, sh * es if H > 1 else row, sb * es if B > 1 else row)
    if sd != 1:
        raise ValueError(f"TMA view needs a contiguous head dim, got strides {t.stride()}")
    if any(s % 16 or s <= 0 or s >= 1 << 40 for s in strides):
        raise ValueError(f"TMA byte strides must be positive multiples of 16 below 2^40, "
                         f"got {strides} (element strides {t.stride()})")
    if t.data_ptr() % 16:
        raise ValueError(f"TMA base address must be 16-byte aligned, got {t.data_ptr():#x}")
    return dict(dims=(D, N, H, B), strides=strides, box=(TMA_BOX_COLS, TMA_BOX_ROWS, 1, 1),
                swizzle=TMA_SWIZZLE)


def _check_kernel_operands(kernel: str, ref: torch.Tensor, **tensors) -> None:
    """Raise on what the kernels do not take: bf16 (B, H, N, D) tensors on
    ref's device with D in KERNEL_HEAD_DIMS, a contiguous head dim and
    16-byte aligned rows and base (the TMA maps' and the 16-byte loads'
    rule, ``tma_geometry``)."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{kernel} kernel: {name} on {t.device}, q on {ref.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bf16, got {name} {t.dtype}")
        try:
            tma_geometry(t)
        except ValueError as e:
            raise ValueError(f"{kernel} kernel: {name}: {e}") from None


def _strides(*tensors) -> list[int]:
    return [s for t in tensors for s in t.stride()[:3]]


def launch_streaming(q, k, v, out, static_max, lse=None) -> None:
    """Launch ``csrc/flash_attention.cu`` on (B, H, N, D) bf16 views q, k, v
    and out, D 64 or 128, addressed through their strides; the kernel folds
    ``q_fold(D)`` into q itself. ``static_max`` is a device scalar from
    ``static_max_operand`` (the natural-log bound) or None for an online
    row max; ``lse``, if given, an fp32 (B, H, Nq) contiguous buffer for the
    log2-domain row logsumexp. Raises on what the kernel does not take."""
    from .cuda_build import library

    _check_kernel_operands("flash attention", q, q=q, k=k, v=v, out=out)
    B, H, nq, dh = q.shape
    nk = k.shape[2]
    if (k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[-1] != dh
            or out.shape != q.shape):
        raise ValueError(f"flash attention kernel: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} out {tuple(out.shape)}")
    if lse is not None and (lse.dtype != torch.float32 or lse.shape != (B, H, nq)
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash attention kernel: lse must be fp32 ({B}, {H}, {nq}) "
                         f"contiguous on {q.device}")
    with torch.cuda.device(q.device):
        err = library("flash_attention").vitslam_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if static_max is None else static_max.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, nq, nk, dh,
            *_strides(q, k, v, out), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")


def _forward_kernel(q, k, v, static_max, lse):
    """The CUDA forward on q as it comes (the kernel folds scale * log2(e)
    into it); the output is a (B, H, Nq, D) view of a (B, Nq, H, D) buffer,
    so the caller's merge of the heads back to (B, Nq, H*D) is free."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    B, H, nq, dh = q.shape
    out = torch.empty((B, nq, H, dh), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    smax = None if static_max is None else static_max_operand(static_max, q.device)
    launch_streaming(q, k, v, out, smax, lse)
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        static_max=None):
    """K3 with its lse output: (out (B, H, Nq, D), lse (B, H, Nq) fp32, log2
    domain), the residuals of the backward. CPU tensor: the plain version;
    CUDA tensor: the kernel (bf16, D 64 or 128), or an error. No autograd of
    its own. ``flash_attention_lse.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, with_lse=True)
    B, H, nq, _ = q.shape
    lse = torch.empty((B, H, nq), dtype=torch.float32, device=q.device)
    out = _forward_kernel(q, k, v, static_max, lse)
    flash_attention_lse.launches += 1
    return out, lse


flash_attention_lse.launches = 0


def flash_attention_backward(q, k, v, out, lse, dout):
    """K4: (dq, dk, dv) of flash attention from the forward's inputs, output
    and lse and the output's gradient, in q's, k's and v's dtypes. CPU
    tensor: ``flash_attention_backward_plain``; CUDA tensor: the dq and dk/dv
    kernels of ``csrc/flash_attention_bwd.cu`` (bf16, D 64 or 128), or an
    error. q is scaled by ``q_fold(D)`` and rounded to bf16 exactly as the
    forward kernel does in shared memory, so the rebuilt P is the
    forward's.
    ``flash_attention_backward.launches`` counts kernel launches (each
    launches both kernels)."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on cpu or cuda, not {q.device}")
    from .cuda_build import library

    if dout.dtype == torch.bfloat16 and (dout.stride(-1) != 1 or dout.data_ptr() % 16
                                         or any(s % 8 for s in dout.stride()[:3])):
        dout = dout.contiguous()  # autograd hands over whatever layout it has
    B, H, nq, dh = q.shape
    nk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qs = (q.float() * q_fold(dh)).to(torch.bfloat16)
    dq = torch.empty((B, nq, H, dh), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    dk = torch.empty((B, nk, H, dh), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    dv = torch.empty((B, nk, H, dh), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    _check_kernel_operands("flash attention backward", q, q=qs, k=k, v=v, dout=dout,
                           dq=dq, dk=dk, dv=dv)
    if (k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[-1] != dh
            or dout.shape != q.shape or lse.shape != (B, H, nq)):
        raise ValueError(f"flash attention backward kernel: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} dout {tuple(dout.shape)} "
                         f"lse {tuple(lse.shape)}")
    lse = lse.float().contiguous()
    dmat = (dout.float() * out.float()).sum(dim=-1).contiguous()  # D = rowsum(dO * O)
    with torch.cuda.device(q.device):
        err = library("flash_attention_bwd").vitslam_flash_attention_bwd_bf16(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dmat.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, nq, nk, dh,
            scale, *_strides(qs, k, v, dout, dq, dk, dv),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: CUDA error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward. ``use_kernel``: the kernel
    wrappers (K3 with lse, then K4; their plain versions on the CPU), or
    the plain versions on any device (``flash_attention_reference``). Saves
    q, k, v, the output and the lse: O(N) memory, no (Nq x Nk) logits."""

    @staticmethod
    def forward(ctx, q, k, v, static_max, use_kernel):
        if use_kernel:
            out, lse = flash_attention_lse(q, k, v, static_max=static_max)
        else:
            out, lse = flash_attention_plain(q, k, v, with_lse=True)
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_backward if ctx.use_kernel else flash_attention_backward_plain
        dq, dk, dv = bwd(q, k, v, out, lse, dout)
        return dq, dk, dv, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    static_max=None, with_lse: bool = False):
    """Flash attention over (B, H, Nq, D) queries and (B, H, Nk, D) keys and
    values, with logits scaled by 1/sqrt(D). static_max: an upper bound on
    |logits| (fixed softmax shift), or None for an online row max. Returns
    (B, H, Nq, D), and with ``with_lse`` also the (B, H, Nq) fp32 log2
    lse.

    CPU tensor: the plain version. CUDA tensor: the kernel (bf16, D 64 or
    128), or an error; its output is a (B, H, Nq, D) view of a (B, Nq, H, D)
    buffer. Differentiable in q, k and v: when one requires grad the
    forward runs with lse (``flash_attention_lse``) and the backward is K4
    (``flash_attention_backward``). ``flash_attention.launches`` counts the
    forward launches without lse."""
    static_max = static_max.detach() if isinstance(static_max, torch.Tensor) else static_max
    if _needs_grad(q, k, v):
        out, lse = _FlashAttention.apply(q, k, v, static_max, True)
        return (out, lse) if with_lse else out
    if with_lse:
        return flash_attention_lse(q, k, v, static_max=static_max)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    out = _forward_kernel(q, k, v, static_max, None)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain versions of K3 and K4 as one differentiable function, on
    any device: what the flash route computes when the kernels are switched
    off (``ops.attention.plain_attention_routes``). Unlike autograd through
    ``flash_attention_plain`` it keeps no (Nq x Nk) probabilities for the
    backward, so the head's 10,738-token global attention fits the card."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, None, False)[0]
    return flash_attention_plain(q, k, v)
