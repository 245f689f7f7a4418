"""Fused qkv-packed self-attention and flat streaming attention (port of
the K1 and K2 parts of vitslam_tpu/ops/fused_attention.py).

``fused_qkv_attention`` (K1) reads q/k/v per head straight out of the
packed (B, N, 3C) qkv projection, applies the optional per-head LayerNorm
and RoPE to q and k, and writes the attention output in the flat (B, N, C)
layout. It is two steps: ``qk_prep`` (LayerNorm + RoPE + the scale fold,
once per token and head) and the attention over the prepped q^, k^ and the
v slice of qkv. On a CUDA tensor both are hand-written Hopper kernels in
``csrc/fused_attention.cu`` (or raise; without LayerNorm and RoPE the
attention kernel folds the scale itself and there is no prep launch); on a
CPU tensor they are ``qk_prep_plain`` and ``flash_attention_plain`` on the
exp2 scale, which together make ``fused_qkv_attention_plain``.

``flat_flash_attention`` (K2) streams attention over q/k/v that were
already LayerNormed and rotated in the flat (B, N, C) layout, for more than
4096 keys; on CUDA it launches ``csrc/flash_attention.cu`` on strided views
of the flat tensors (no head relayout, the scale folded in the kernel), on
the CPU it runs ``flat_flash_attention_plain``.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import (
    LOG2E,
    _needs_grad,
    flash_attention_plain,
    launch_streaming,
    q_fold,
    static_max_operand,
)

LN_EPS = 1e-6
KERNEL_HEAD_DIMS = (64,)
KERNEL_MAX_TOKENS = 4096


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> a (B, H, N, C // H) view."""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def qk_prep_plain(qkv, *, num_heads, cos=None, sin=None, q_ln=None, k_ln=None,
                  nsplit=2, fold=1.0):
    """Plain PyTorch version of K1's prep kernel: per head, in fp32, the
    LayerNorm (E[x^2] - E[x]^2 without a clamp, eps 1e-6), then RoPE
    x * cos + rotate_half_multi(x) * sin, then for q the factor ``fold``
    (scale * log2(e) on K1's path); one rounding to qkv's dtype. Returns
    (q^, k^), each (B, N, C) flat; without LayerNorm and RoPE k^ is the k
    slice of qkv itself. cos/sin: (B, N, dh) or head-tiled (B, N, C)."""
    from ..nn.rope import rotate_half_multi  # nn imports ops: bind at call time

    B, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    dh = C // h

    def prep(x, ln, factor):
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
        if factor != 1.0:
            xf = xf * factor
        return xf.reshape(B, N, C).to(qkv.dtype)

    k = qkv[..., C:2 * C]
    if q_ln is None and cos is None:
        return prep(qkv[..., :C], None, fold), k
    return prep(qkv[..., :C], q_ln, fold), prep(k, k_ln, 1.0)


def fused_qkv_attention_plain(qkv, *, num_heads, cos=None, sin=None, q_ln=None,
                              k_ln=None, scale=None, static_max=None, nsplit=2):
    """Plain PyTorch version of K1 (the counterpart of ``_fused_reference``):
    ``qk_prep_plain`` with scale * log2(e) folded into q before q^ is
    rounded to qkv's dtype (where the kernels round it), then
    ``flash_attention_plain`` on the exp2 scale (S in fp32, softmax in
    fp32, P cast to qkv's dtype before P V). With fp32 qkv nothing is
    rounded, and the scale stays on the logits: the same operations as the
    flash route's plain attention, so the two routes agree to the last
    bits. ``static_max`` does not change the result (softmax is
    shift-invariant)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    rounded = qkv.dtype != torch.float32
    q, k = qk_prep_plain(qkv, num_heads=num_heads, cos=cos, sin=sin, q_ln=q_ln, k_ln=k_ln,
                         nsplit=nsplit, fold=scale * LOG2E if rounded else 1.0)
    v = qkv[..., 2 * C:]
    o = flash_attention_plain(_heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
                              scale=1.0 / LOG2E if rounded else scale)
    return o.transpose(1, 2).reshape(B, N, C)


def _fp32_operand(t, dev, dh):
    """A LayerNorm vector as the kernels read it: a contiguous, 16-byte
    aligned fp32 (dh,) tensor on dev; the model's params are used in place,
    anything else is converted."""
    if (isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.device == dev
            and t.shape == (dh,) and t.is_contiguous() and not t.data_ptr() % 16):
        return t
    return torch.as_tensor(t).to(device=dev, dtype=torch.float32).reshape(dh).clone()


def _rope_table(t, B, N, dh, dev):
    """A RoPE table as the prep kernel reads it: fp32 rows of a contiguous
    last dim, 16-byte aligned, at (batch, token) strides; the model's
    (B, N, dh) fp32 cache and a head-tiled (B, N, C) fp32 table are read in
    place (the first dh columns), other dtypes or layouts are converted."""
    if t.dim() != 3 or t.shape[:2] != (B, N) or t.shape[-1] % dh:
        raise ValueError(f"RoPE table shape {tuple(t.shape)} does not match (B, N) = {(B, N)}")
    if (t.dtype != torch.float32 or t.device != dev or t.stride(-1) != 1
            or t.stride(1) % 4 or t.stride(0) % 4 or t.data_ptr() % 16):
        t = t[..., :dh].to(device=dev, dtype=torch.float32).contiguous()
    return t


def _prep_operands(qkv, num_heads, cos, sin, q_ln, k_ln, nsplit):
    """Check what the prep kernel takes and return its table and LayerNorm
    arguments: [cos, sin, tab_sb, tab_sn, q_scale, q_bias, k_scale, k_bias]
    (pointers or None), the tensors they point into, and whether q and k
    are prepped (else k is read from qkv)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or C % num_heads:
        raise ValueError(f"qkv width {C3} is not 3 * num_heads * dh")
    dh = C // num_heads
    if qkv.device.type != "cuda":
        raise ValueError(f"the K1 kernels run on cpu or cuda, not {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the K1 kernels take bf16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the K1 kernels take a contiguous, 16-byte aligned qkv")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the K1 kernels support head dim {KERNEL_HEAD_DIMS}, got {dh}")
    if nsplit not in (1, 2):
        raise ValueError(f"RoPE nsplit must be 1 or 2, got {nsplit}")
    if (cos is None) != (sin is None) or (q_ln is None) != (k_ln is None):
        raise ValueError("cos/sin and q_ln/k_ln come in pairs")
    dev = qkv.device
    keep, args = [], [None, None, 0, 0]
    if cos is not None:
        tabs = [_rope_table(t, B, N, dh, dev) for t in (cos, sin)]
        if tabs[0].stride()[:2] != tabs[1].stride()[:2]:
            tabs = [t.contiguous() for t in tabs]
        keep += tabs
        args = [tabs[0].data_ptr(), tabs[1].data_ptr(), tabs[0].stride(0), tabs[0].stride(1)]
    if q_ln is None:
        args += [None] * 4
    else:
        ln = [_fp32_operand(x, dev, dh) for x in (*q_ln, *k_ln)]
        keep += ln
        args += [t.data_ptr() for t in ln]
    return args, keep, cos is not None or q_ln is not None


def qk_prep(qkv: torch.Tensor, *, num_heads: int, cos=None, sin=None, q_ln=None, k_ln=None,
            nsplit: int = 2, fold: float = 1.0):
    """K1's prep alone: (q^, k^) as ``qk_prep_plain`` computes them. CPU
    tensor: the plain version. CUDA tensor: the prep kernel of
    ``csrc/fused_attention.cu`` (bf16 qkv, contiguous, head dim 64), or an
    error; q^ and k^ are fresh (B, N, C) bf16 buffers (k^ is the k slice of
    qkv without LayerNorm and RoPE). fp32 LayerNorm params and fp32 RoPE
    tables with a contiguous last dim are read in place; other dtypes or
    layouts are converted first. ``qk_prep.launches`` counts its launches,
    here and inside ``fused_qkv_attention``."""
    if qkv.device.type == "cpu":
        return qk_prep_plain(qkv, num_heads=num_heads, cos=cos, sin=sin, q_ln=q_ln,
                             k_ln=k_ln, nsplit=nsplit, fold=fold)
    from .cuda_build import library

    args, _keep, prepped = _prep_operands(qkv, num_heads, cos, sin, q_ln, k_ln, nsplit)
    B, N, C3 = qkv.shape
    C = C3 // 3
    q_hat = torch.empty((B, N, C), dtype=torch.bfloat16, device=qkv.device)
    k_hat = torch.empty_like(q_hat) if prepped else qkv[..., C:2 * C]
    with torch.cuda.device(qkv.device):
        err = library("fused_attention").vitslam_qk_prep_bf16(
            qkv.data_ptr(), q_hat.data_ptr(), k_hat.data_ptr() if prepped else None, *args,
            B, N, num_heads, C // num_heads, nsplit, float(fold),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qk_prep kernel launch failed: CUDA error {err}")
    qk_prep.launches += 1
    return q_hat, k_hat


qk_prep.launches = 0


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
    """K1 on the card, one C call: the prep kernel into scratch q^ and k^,
    then the attention kernel over q^, k^ and the v slice of qkv (read in
    place at row stride 3C); without LayerNorm and RoPE only the attention
    kernel, on the q, k and v slices of qkv, folding the scale itself. The
    layouts are fixed by construction (qkv is checked contiguous and
    aligned, the scratch is fresh)."""
    from .cuda_build import library

    B, N, C3 = qkv.shape
    if not 1 <= N <= KERNEL_MAX_TOKENS:
        raise ValueError(f"fused_qkv_attention kernel takes 1..{KERNEL_MAX_TOKENS} "
                         f"tokens, got {N}")
    args, _keep, prepped = _prep_operands(qkv, num_heads, cos, sin, q_ln, k_ln, nsplit)
    C = C3 // 3
    dev = qkv.device
    out = torch.empty((B, N, C), dtype=torch.bfloat16, device=dev)
    q_hat = torch.empty_like(out) if prepped else None
    k_hat = torch.empty_like(out) if prepped else None
    smax = None if static_max is None else static_max_operand(static_max, dev)
    with torch.cuda.device(dev):
        err = library("fused_attention").vitslam_fused_qkv_attention_bf16(
            qkv.data_ptr(), *(None if t is None else t.data_ptr() for t in (q_hat, k_hat)),
            out.data_ptr(), *args, None if smax is None else smax.data_ptr(),
            B, N, num_heads, C // num_heads, nsplit, float(scale * LOG2E),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qkv_attention kernel launch failed: CUDA error {err}")
    qk_prep.launches += prepped
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

    CPU tensor: the plain version. CUDA tensor: the prep kernel and the
    attention kernel (only the latter without LayerNorm and RoPE; bf16, dh
    64, N <= 4096, contiguous), or an error;
    nothing else is launched when the inputs are in the kernels' types (fp32
    LayerNorm params and RoPE tables, a device-scalar ``static_max``; see
    ``qk_prep`` for what is converted). Differentiable in qkv and the
    LayerNorm params, with the backward recomputed through the plain
    version. ``fused_qkv_attention.launches`` counts attention launches,
    ``qk_prep.launches`` the prep's."""
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
    folded into q in fp32, then q is rounded back to its dtype (bf16 in the
    kernel, in shared memory, as the reference does). Returns (B, Nq, C).

    CPU tensor: the plain version. CUDA tensor: the kernel (bf16 k/v, head
    dim 64, rows 16-byte aligned; v may be a strided slice of the qkv
    projection), or an error; differentiable in q, k and v, with the
    backward recomputed through the plain version.
    ``flat_flash_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        qs = (q.float() * q_fold(q.shape[-1] // num_heads)).to(q.dtype)
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
    out = torch.empty((B, nq, C), dtype=torch.bfloat16, device=q.device)
    launch_streaming(_heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
                     _heads(out, num_heads), static_max_operand(static_max, q.device))
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
        fold = q_fold(q.shape[-1] // ctx.num_heads)
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = flat_flash_attention_plain((q.float() * fold).to(q.dtype), k, v,
                                             num_heads=ctx.num_heads)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None)
