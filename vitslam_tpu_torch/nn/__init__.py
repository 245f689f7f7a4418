"""Transformer building blocks, RoPE and the memory writer (port of
vitslam_tpu/nn)."""
from .gated_update import GatedUpdate
from .layers import (
    Attention,
    Block,
    Conv2d,
    CrossAttention,
    CrossAttentionBlock,
    Dense,
    HeadLayerNorm,
    LayerNorm,
    LayerScale,
    Mlp,
    init_weights,
    ln_apply,
    qk_logit_bound,
    qk_shift_from,
    set_int8,
)

__all__ = [
    "Attention", "Block", "Conv2d", "CrossAttention", "CrossAttentionBlock",
    "Dense", "GatedUpdate", "HeadLayerNorm", "LayerNorm", "LayerScale", "Mlp",
    "init_weights", "ln_apply", "qk_logit_bound", "qk_shift_from", "set_int8",
]
