"""Transformer building blocks (port of vitslam_tpu/nn/layers.py): Dense,
LayerNorm, Mlp, LayerScale, qk-norm self- and cross-attention, pre-norm
blocks with RoPE, the fused block tails (``Block(mlp_tail=...)``, kernel
K5 through ``ops.mlp_tail``) and the int8 projections (``Dense(quant=True)``
under ``set_int8``, through ``ops.quant``).

Parameters are fp32; each module has a compute ``dtype`` (bf16 in the
backbone) and casts its inputs and weights to it at each matmul, as flax
does. LayerNorm statistics are fp32 with eps 1e-6. Parameters are allocated
uninitialised on ``device``; ``init_weights`` fills them from a
``torch.Generator``, or ``io.from_jax.load_jax_params`` loads them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import ROUTE_COUNTS, attention_route, scaled_dot_product_attention
from ..ops.fused_attention import flat_flash_attention, fused_qkv_attention
from ..ops.mlp_tail import mlp_tail
from ..ops.quant import int8_matmul
from ..parallel.mesh import all_gather
from .rope import apply_rope_1d, apply_rope_2d, apply_rope_cached, apply_rope_flat

# default softmax shift of the bounded-logit path; raised to the provable
# bound when the learned qk-norm gains exceed it
QK_STATIC_MAX = 24.0
LN_EPS = 1e-6
# fused block tails: below this many block-input rows a block keeps its
# unfused tails (the reference's _TAIL_MIN_ROWS)
TAIL_MIN_ROWS = 1024
# Block(mlp_tail=...) -> the tail sites that go through K5 (the reference
# reads the same choice from VITSLAM_MLP_TAIL in _tail_sites)
TAIL_SITES = {"off": frozenset(), "mlp": frozenset({"mlp"}), "proj": frozenset({"proj"}),
              "both": frozenset({"mlp", "proj"})}


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (+-2 sigma) with variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` with the reference's initialisers,
    drawing from ``generator`` (on the parameters' device). Children are
    initialised before their parent, so a parent may override them."""
    with torch.no_grad():
        for m in reversed(list(module.modules())):
            if hasattr(m, "init_params"):
                m.init_params(generator)
    return module


def _is_rope_cache(pos) -> bool:
    return isinstance(pos, tuple) and len(pos) == 3 and isinstance(pos[2], int)


def qk_logit_bound(q_params, k_params, dh: int) -> torch.Tensor:
    """Provable upper bound on qk-normed attention logits from the LayerNorm
    affine params (scale, bias): after LayerNorm ||x_hat|| = sqrt(dh), so
    ||q|| <= max|g_q| sqrt(dh) + ||b_q||, RoPE preserves norms, and
    |logit| <= bound(q) bound(k) / sqrt(dh)."""
    sq = math.sqrt(dh)

    def row_bound(p):
        r = p[0].abs().max() * sq
        if p[1] is not None:
            r = r + torch.linalg.vector_norm(p[1])
        return r

    return (row_bound(q_params) * row_bound(k_params) / sq).float()


def qk_shift_from(qp, kp, dh: int) -> torch.Tensor:
    """Overflow-proof softmax shift max(24, bound) from (scale, bias) pairs."""
    return qk_logit_bound(qp, kp, dh).detach().clamp_min(QK_STATIC_MAX)


def ln_apply(x, scale, bias, dtype, eps: float = LN_EPS):
    """Functional LayerNorm: fp32 stats, max(0, E[x^2] - E[x]^2), cast to
    dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


class Dense(nn.Module):
    """Linear layer with fp32 params and a compute dtype (flax nn.Dense).
    ``quant=True`` (the reference's QuantizableDense): while the int8 mode
    is on (``set_int8``) the product runs through ``ops.quant.int8_matmul``
    on the input as it comes and the fp32 weight."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None, quant: bool = False):
        super().__init__()
        self.weight = _param(out_features, in_features, device=device)
        self.bias = _param(out_features, device=device) if bias else None
        self.dtype, self.quant, self.int8 = dtype, quant, False

    def init_params(self, g):
        lecun_normal_(self.weight, self.weight.shape[1], g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        if self.int8:
            return int8_matmul(x, self.weight.t(), self.bias, self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def set_int8(module: nn.Module, enabled: bool) -> nn.Module:
    """Switch the int8 mode of every ``Dense(quant=True)`` in ``module``
    (the reference's VITSLAM_INT8, here a property of the model)."""
    for m in module.modules():
        if isinstance(m, Dense) and m.quant:
            m.int8 = enabled
    return module


class Conv2d(nn.Module):
    """NCHW convolution with fp32 params and a compute dtype (flax nn.Conv;
    the weight is in torch's (out, in, kh, kw) layout)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = _param(cout, cin, kernel, kernel, device=device)
        self.bias = _param(cout, device=device) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def init_params(self, g):
        fan_in = self.weight[0].numel()
        lecun_normal_(self.weight, fan_in, g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        stride=self.stride, padding=self.padding)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: fp32 stats with the clamped fast variance,
    (x - mean) * (rsqrt(var + eps) * scale) + bias, cast to dtype."""

    def __init__(self, dim: int, dtype=torch.float32, use_scale: bool = True,
                 use_bias: bool = True, eps: float = LN_EPS, device=None):
        super().__init__()
        self.weight = _param(dim, device=device) if use_scale else None
        self.bias = _param(dim, device=device) if use_bias else None
        self.dtype, self.eps = dtype, eps

    def init_params(self, g):
        if self.weight is not None:
            self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class HeadLayerNorm(nn.Module):
    """Per-head LayerNorm over ``head_dim`` features, on the (B, H, N, dh)
    layout or (``flat=True``) on the flat (B, N, H*dh) layout; unclamped
    E[x^2] - E[x]^2 variance, as the fused kernel computes it."""

    def __init__(self, num_heads: int, head_dim: int, dtype=torch.float32,
                 eps: float = LN_EPS, device=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.weight = _param(head_dim, device=device)
        self.bias = _param(head_dim, device=device)
        self.dtype, self.eps = dtype, eps

    def init_params(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, flat: bool = False):
        shape = x.shape
        xf = x.float()
        if flat:
            xf = xf.reshape(shape[:-1] + (self.num_heads, self.head_dim))
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype).reshape(shape)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5, device=None):
        super().__init__()
        self.gamma = _param(dim, device=device)
        self.init_values = init_values

    def init_params(self, g):
        self.gamma.fill_(self.init_values)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


def dense_tail(dense: Dense, h, res, ls_gamma, tail_ln, gelu: bool):
    """res + ls * dense(act(h)) [+ LayerNorm] through ``ops.mlp_tail`` (K5),
    with LayerScale folded into the weights in fp32 (a per-column scale
    commutes with the product): W cast to h's dtype, b kept in fp32.
    Returns (x', LN(x')) when ``tail_ln`` = (scale, bias) is given, else
    x'."""
    w = dense.weight
    b = dense.bias if dense.bias is not None else torch.zeros_like(w[:, 0])
    if ls_gamma is not None:
        w = w * ls_gamma[:, None]
        b = b * ls_gamma
    h2 = h.reshape(-1, h.shape[-1])
    r2 = res.reshape(-1, res.shape[-1])
    if tail_ln is not None:
        x, y = mlp_tail(h2, w.to(h2.dtype), b, r2, tail_ln[0], tail_ln[1], gelu=gelu, ln=True)
        return x.reshape(res.shape), y.reshape(res.shape)
    return mlp_tail(h2, w.to(h2.dtype), b, r2, gelu=gelu, ln=False).reshape(res.shape)


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> fc2. With ``tail=(res, ls_gamma)`` the
    caller asks for the fused tail: gelu + fc2 + LayerScale + residual in
    K5, returning res + ls * fc2(gelu(fc1(x))). ``quant``: both Denses'."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, bias: bool = True, dtype=torch.float32,
                 device=None, quant: bool = False):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, bias, dtype, device, quant)
        self.fc2 = Dense(hidden_features, out_features, bias, dtype, device, quant)

    def forward(self, x, tail=None):
        if tail is not None:
            return dense_tail(self.fc2, self.fc1(x), tail[0], tail[1], None, gelu=True)
        return self.fc2(F.gelu(self.fc1(x)))


def _apply_rope(q, k, pos_q, pos_k, mode: Optional[str], base: float):
    """RoPE on (B, H, N, D) q/k from integer positions or a cache."""
    if mode is None or pos_q is None:
        return q, k
    if _is_rope_cache(pos_q):
        return apply_rope_cached(q, pos_q), apply_rope_cached(k, pos_k)
    fn = apply_rope_1d if mode == "1d" else apply_rope_2d
    return fn(q, pos_q, base), fn(k, pos_k, base)


class Attention(nn.Module):
    """Multi-head self-attention with optional per-head qk LayerNorm and
    RoPE (rope: None | '1d' | '2d', positions or a cache at call time).

    Routing follows ``ops.attention.attention_route``: the fused route hands
    the packed qkv projection, the LayerNorm params, the RoPE cache and the
    logit bound to ``fused_qkv_attention`` (K1 on CUDA); the flat route
    preps q/k once in the flat layout and streams them through
    ``flat_flash_attention`` (K2); the flash route goes to K3. With
    ``tail=(res, ls_gamma, ln_scale, ln_bias)`` the output projection,
    LayerScale, residual add and the following LayerNorm run in K5 on every
    route, and the call returns (x', LN(x')).

    ``seq_group`` (sequence parallelism, ``parallel/seq.py``): the tokens
    are split over this process group in rank order; the LayerNormed and
    rotated keys and values are gathered over it, the queries stay local,
    and the route follows the gathered key count (never K1, which reads
    q, k and v from one packed projection). ``quant``: the qkv (also over
    ``kv``) and output projections'."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = True,
                 rope: Optional[str] = None, rope_base: float = 100.0,
                 dtype=torch.float32, device=None, seq_group=None, quant: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qk_norm, self.rope, self.rope_base = qk_norm, rope, rope_base
        self.seq_group = seq_group
        dh = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, device, quant)
        if qk_norm:
            self.q_norm = HeadLayerNorm(num_heads, dh, dtype, device=device)
            self.k_norm = HeadLayerNorm(num_heads, dh, dtype, device=device)
        self.proj = Dense(dim, dim, proj_bias, dtype, device, quant)

    def _norm_params(self):
        return ((self.q_norm.weight, self.q_norm.bias),
                (self.k_norm.weight, self.k_norm.bias))

    def _proj(self, out, tail):
        if tail is None:
            return self.proj(out)
        res, ls_gamma, ln_scale, ln_bias = tail
        return dense_tail(self.proj, out, res, ls_gamma, (ln_scale, ln_bias), gelu=False)

    def forward(self, x, pos=None, kv=None, pos_kv=None, tail=None):
        """Self-attention over ``x`` (B, N, C). With ``kv`` given, queries
        come from ``x`` and keys/values from ``kv`` through the same qkv
        projection (the aggregator's KV-merged global attention), and
        ``pos_kv`` is the RoPE cache of the kv token set."""
        B, N, C = x.shape
        h = self.num_heads
        dh = C // h
        qkv = self.qkv(x)
        qkv_k = self.qkv(kv) if kv is not None else qkv
        if pos_kv is None:
            pos_kv = pos
        sp = self.seq_group is not None
        nk = qkv_k.shape[1] * (dist.get_world_size(self.seq_group) if sp else 1)
        fast = self.qk_norm and _is_rope_cache(pos) and _is_rope_cache(pos_kv)
        fusable = kv is None and not sp and (
            fast or (not self.qk_norm and self.rope is None and pos is None))
        route = attention_route(N, nk, fusable=fusable, fast=fast)
        ROUTE_COUNTS[route] += 1
        if route == "fused":
            kwargs = dict(num_heads=h)
            if fast:
                qp, kp = self._norm_params()
                cos, sin, nsplit = pos
                kwargs.update(cos=cos, sin=sin, q_ln=qp, k_ln=kp, nsplit=nsplit,
                              static_max=qk_shift_from(qp, kp, dh))
            return self._proj(fused_qkv_attention(qkv, **kwargs), tail)
        static_max = None
        if fast:
            cos, sin, nsplit = pos
            cos_k, sin_k, nsplit_k = pos_kv
            q = apply_rope_flat(self.q_norm(qkv[..., :C], flat=True), cos, sin, h, nsplit)
            k = apply_rope_flat(self.k_norm(qkv_k[..., C:2 * C], flat=True), cos_k, sin_k,
                                h, nsplit_k)
            v = qkv_k[..., 2 * C:]
            if sp:  # prepped once, so the gather carries LN + RoPE with it
                k, v = (all_gather(t, self.seq_group, dim=1) for t in (k, v))
            static_max = qk_shift_from(*self._norm_params(), dh)
            if route == "flat":
                # prepped once in the flat layout, streamed with no relayout
                return self._proj(flat_flash_attention(q, k, v, num_heads=h,
                                                       static_max=static_max), tail)
            q, k, v = (t.reshape(B, t.shape[1], h, dh).transpose(1, 2) for t in (q, k, v))
        else:
            q = qkv[..., :C].reshape(B, N, h, dh).transpose(1, 2)
            k, v = (qkv_k[..., i * C:(i + 1) * C].reshape(B, nk, h, dh).transpose(1, 2)
                    for i in (1, 2))
            if self.qk_norm:
                q, k = self.q_norm(q), self.k_norm(k)
                static_max = qk_shift_from(*self._norm_params(), dh)
            q, k = _apply_rope(q, k, pos, pos_kv, self.rope, self.rope_base)
            if sp:
                k, v = (all_gather(t, self.seq_group, dim=2) for t in (k, v))
        out = scaled_dot_product_attention(q, k, v, route=route, static_max=static_max)
        return self._proj(out.transpose(1, 2).reshape(B, N, C), tail)


class CrossAttention(nn.Module):
    """Cross-attention with separate q/k/v projections and distinct RoPE
    position sets for queries and keys."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = False,
                 rope: Optional[str] = None, rope_base: float = 100.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qk_norm, self.rope, self.rope_base = qk_norm, rope, rope_base
        dh = dim // num_heads
        self.q = Dense(dim, dim, qkv_bias, dtype, device)
        self.k = Dense(dim, dim, qkv_bias, dtype, device)
        self.v = Dense(dim, dim, qkv_bias, dtype, device)
        if qk_norm:
            self.q_norm = LayerNorm(dh, dtype, device=device)
            self.k_norm = LayerNorm(dh, dtype, device=device)
        self.proj = Dense(dim, dim, proj_bias, dtype, device)

    def forward(self, x, y, pos=None):
        B, N, C = x.shape
        M = y.shape[1]
        h = self.num_heads
        dh = C // h
        q = self.q(x).reshape(B, N, h, dh).transpose(1, 2)
        k = self.k(y).reshape(B, M, h, dh).transpose(1, 2)
        v = self.v(y).reshape(B, M, h, dh).transpose(1, 2)
        static_max = None  # no qk-norm: the flash route tracks an online max
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
            static_max = qk_shift_from((self.q_norm.weight, self.q_norm.bias),
                                       (self.k_norm.weight, self.k_norm.bias), dh)
        pos_q, pos_k = pos if pos is not None else (None, None)
        q, k = _apply_rope(q, k, pos_q, pos_k, self.rope, self.rope_base)
        route = attention_route(N, M, fusable=False, fast=False)
        ROUTE_COUNTS[route] += 1
        out = scaled_dot_product_attention(q, k, v, route=route, static_max=static_max)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    """Pre-norm ViT block: x + ls1(attn(norm1 x)); x + ls2(mlp(norm2 x)).

    ``mlp_tail`` ("off" | "mlp" | "proj" | "both") routes residual tails
    through K5 (``ops.mlp_tail``) when the block input has at least
    ``TAIL_MIN_ROWS`` rows: "proj" fuses the attention's output projection
    + LayerScale + residual + norm2 (the LayerNorm's variance then is the
    centered one, not ``ln_apply``'s E[x^2] - E[x]^2), "mlp" fuses gelu +
    fc2 + LayerScale + residual. The frozen backbone's blocks take it; the
    parameters are the same either way. ``seq_group``: the attention's
    (``Attention``). ``quant``: the four projections may run int8
    (``set_int8``); while they do, the block takes no fused tail, as the
    reference's does not."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 qk_norm: bool = True, init_values: Optional[float] = None,
                 rope: Optional[str] = None, rope_base: float = 100.0,
                 dtype=torch.float32, device=None, mlp_tail: str = "off",
                 seq_group=None, quant: bool = False):
        super().__init__()
        if mlp_tail not in TAIL_SITES:
            raise ValueError(f"mlp_tail must be one of {sorted(TAIL_SITES)}, got {mlp_tail!r}")
        self.dtype, self.tail_sites = dtype, TAIL_SITES[mlp_tail]
        self.norm1 = LayerNorm(dim, dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, proj_bias, qk_norm,
                              rope, rope_base, dtype, device, seq_group, quant)
        self.norm2 = LayerNorm(dim, dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, device=device, quant=quant)
        if init_values is not None:
            self.ls1 = LayerScale(dim, init_values, device)
            self.ls2 = LayerScale(dim, init_values, device)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x, pos=None, kv=None, pos_kv=None):
        kv_n = self.norm1(kv) if kv is not None else None
        tails = x.numel() // x.shape[-1] >= TAIL_MIN_ROWS and not self.attn.qkv.int8
        sites = self.tail_sites if tails else ()
        ls1, ls2 = (None, None) if self.ls1 is None else (self.ls1.gamma, self.ls2.gamma)
        if "proj" in sites:
            x, y = self.attn(self.norm1(x), pos, kv=kv_n, pos_kv=pos_kv,
                             tail=(x, ls1, self.norm2.weight, self.norm2.bias))
        else:
            a = self.attn(self.norm1(x), pos, kv=kv_n, pos_kv=pos_kv)
            if self.ls1 is not None:
                a = self.ls1(a)
            x = x + a
            y = ln_apply(x, self.norm2.weight, self.norm2.bias, self.dtype)
        if "mlp" in sites:
            return self.mlp(y, tail=(x, ls2))
        m = self.mlp(y)
        if self.ls2 is not None:
            m = self.ls2(m)
        return x + m


class CrossAttentionBlock(nn.Module):
    """Pre-norm cross-attention block:
    x + ls1(cross_attn(norm1 x, norm3 y)); x + ls2(mlp(norm2 x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 qk_norm: bool = True, init_values: Optional[float] = None,
                 rope: Optional[str] = None, rope_base: float = 100.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype, device=device)
        self.norm3 = LayerNorm(dim, dtype, device=device)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias, proj_bias,
                                         qk_norm, rope, rope_base, dtype, device)
        self.norm2 = LayerNorm(dim, dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, device=device)
        if init_values is not None:
            self.ls1 = LayerScale(dim, init_values, device)
            self.ls2 = LayerScale(dim, init_values, device)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x, y, pos=None):
        a = self.cross_attn(self.norm1(x), self.norm3(y), pos)
        x = x + (self.ls1(a) if self.ls1 is not None else a)
        m = self.mlp(self.norm2(x))
        return x + (self.ls2(m) if self.ls2 is not None else m)
