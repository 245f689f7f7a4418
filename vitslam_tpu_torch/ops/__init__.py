"""Kernels and their dispatch (port of vitslam_tpu/ops). K1 is ported
(``fused_attention``); the CUDA sources live in ``../csrc`` and are built by
``cuda_build`` at first use."""
from .attention import ROUTE_COUNTS, attention_route, scaled_dot_product_attention
from .fused_attention import fused_qkv_attention, fused_qkv_attention_plain
from .resize import bicubic_matrix, resize_bilinear_nchw

__all__ = [
    "ROUTE_COUNTS", "attention_route", "scaled_dot_product_attention",
    "fused_qkv_attention", "fused_qkv_attention_plain", "bicubic_matrix",
    "resize_bilinear_nchw",
]
