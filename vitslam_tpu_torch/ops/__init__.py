"""Kernels and their dispatch (port of vitslam_tpu/ops). K1 and K2
(``fused_attention``) and K3 with its lse output and K4, the flash backward
(``flash_attention``), are ported; the CUDA sources live in ``../csrc`` and
are built by ``cuda_build`` at first use."""
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
from .resize import bicubic_matrix, resize_bilinear_nchw

__all__ = [
    "ROUTE_COUNTS", "attention_route", "plain_attention_routes",
    "scaled_dot_product_attention", "flash_attention", "flash_attention_backward",
    "flash_attention_backward_plain", "flash_attention_lse", "flash_attention_plain",
    "flash_attention_reference", "flat_flash_attention", "flat_flash_attention_plain",
    "fused_qkv_attention", "fused_qkv_attention_plain", "bicubic_matrix",
    "resize_bilinear_nchw",
]
