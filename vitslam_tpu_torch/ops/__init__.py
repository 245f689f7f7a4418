"""Kernels and their dispatch (port of vitslam_tpu/ops). Every Pallas kernel
of the reference has its CUDA counterpart: K1 and K2 (``fused_attention``),
K3 with its lse output and K4, the flash backward (``flash_attention``), and
K5, the fused block tail (``mlp_tail``: GEMM + bias + residual, optional
gelu and LayerNorm, the route of ``nn.layers.Block(mlp_tail=...)``). The
CUDA sources live in ``../csrc`` and are built by ``cuda_build`` at first
use. ``knn`` is the tiled brute-force nearest-neighbour search of the eval,
in stock torch."""
from .attention import (
    ROUTE_COUNTS,
    attention_route,
    plain_attention_routes,
    scaled_dot_product_attention,
)
from .flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_lse,
    flash_attention_plain,
    flash_attention_reference,
)
from .fused_attention import (
    flat_flash_attention,
    flat_flash_attention_plain,
    fused_qkv_attention,
    fused_qkv_attention_plain,
)
from .mlp_tail import mlp_tail, mlp_tail_plain
from .resize import bicubic_matrix, resize_bilinear_nchw

__all__ = [
    "ROUTE_COUNTS", "attention_route", "plain_attention_routes",
    "scaled_dot_product_attention", "flash_attention", "flash_attention_backward",
    "flash_attention_backward_plain", "flash_attention_lse", "flash_attention_plain",
    "flash_attention_reference", "flat_flash_attention", "flat_flash_attention_plain",
    "fused_qkv_attention", "fused_qkv_attention_plain", "mlp_tail", "mlp_tail_plain",
    "bicubic_matrix",
    "resize_bilinear_nchw",
]
