"""Streaming flash attention forward (port of the K3 part of
vitslam_tpu/ops/flash_attention.py) and the launcher that K2
(``ops.fused_attention.flat_flash_attention``) shares with it.

``flash_attention`` takes (B, H, Nq, D) queries and (B, H, Nk, D) keys and
values, self or cross (Nq != Nk), with a fixed softmax shift (``static_max``,
the qk-norm logit bound) or an online row max. On a CUDA tensor it launches
the hand-written Hopper kernel in ``csrc/flash_attention.cu`` (or raises);
on a CPU tensor it runs ``flash_attention_plain``, the plain PyTorch version
of the same math (the counterpart of ``_xla_attention``).
"""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634  # log2(e): folded into q so the softmax is exp2
KERNEL_HEAD_DIM = 64
# the plain version computes its fp32 logits this many elements at a time
# (a block of query rows against all keys), so the 30,900-token global
# attention of the large-chunk slice fits the card
PLAIN_MAX_LOGITS = 1 << 28


def shift_tensor(static_max, device) -> torch.Tensor:
    """The log2-domain softmax shift as a device scalar: the kernels read it
    from device memory, so a shift computed on the device never syncs."""
    t = torch.as_tensor(static_max, dtype=torch.float32, device=device)
    return (t.reshape(1) * LOG2E).contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over (..., Nq, D) / (..., Nk, D): logits and
    softmax in fp32, probabilities cast to v's dtype before P V (as
    ``_xla_attention``). Query rows are taken in blocks of at most
    PLAIN_MAX_LOGITS logits; each row's softmax is independent of the others,
    so the blocking does not change the result."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kt = k.float().transpose(-1, -2)
    rows = max(1, PLAIN_MAX_LOGITS // max(1, math.prod(q.shape[:-2]) * k.shape[-2]))
    outs = []
    for i in range(0, q.shape[-2], rows):
        s = torch.matmul(q[..., i:i + rows, :].float(), kt)
        p = torch.softmax(s * scale, dim=-1)
        outs.append(torch.matmul(p.to(v.dtype), v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)


def launch_streaming(q, k, v, out, shift) -> None:
    """Launch ``csrc/flash_attention.cu`` on (B, H, N, 64) bf16 views q (with
    scale * log2(e) folded in), k, v and out, addressed through their
    strides; ``shift`` is a device scalar from ``shift_tensor`` or None for
    an online row max. Raises on what the kernel does not take."""
    from .cuda_build import library

    tensors = dict(q=q, k=k, v=v, out=out)
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash attention kernel: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bf16, got {name} {t.dtype}")
        if t.dim() != 4 or t.shape[-1] != KERNEL_HEAD_DIM:
            raise ValueError(f"flash attention kernel takes (B, H, N, {KERNEL_HEAD_DIM}), "
                             f"got {name} {tuple(t.shape)}")
        # rows are copied 16 bytes at a time
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel needs a contiguous head dim and "
                             f"16-byte aligned rows, got {name} strides {t.stride()}")
    B, H, nq, dh = q.shape
    nk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (B, H) or out.shape != q.shape:
        raise ValueError(f"flash attention kernel: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} out {tuple(out.shape)}")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = library("flash_attention").vitslam_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if shift is None else shift.data_ptr(), B, H, nq, nk, dh, *strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    static_max=None, with_lse: bool = False) -> torch.Tensor:
    """Flash attention over (B, H, Nq, D) queries and (B, H, Nk, D) keys and
    values, with logits scaled by 1/sqrt(D). static_max: an upper bound on
    |logits| (fixed softmax shift), or None for an online row max. Returns
    (B, H, Nq, D).

    CPU tensor: the plain version. CUDA tensor: the kernel (bf16, D 64), or
    an error; its output is a (B, H, Nq, D) view of a (B, Nq, H, D) buffer,
    so the caller's merge of the heads back to (B, Nq, H*D) is free.
    ``flash_attention.launches`` counts kernel launches."""
    if with_lse:
        raise NotImplementedError("the log2 lse output of K3 belongs to the training "
                                  "slice and is not ported yet")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    B, H, nq, dh = q.shape
    qs = (q.float() * (LOG2E / math.sqrt(dh))).to(torch.bfloat16)
    out = torch.empty((B, nq, H, dh), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    shift = None if static_max is None else shift_tensor(static_max, q.device)
    launch_streaming(qs, k, v, out, shift)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
