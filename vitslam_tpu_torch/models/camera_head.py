"""CameraHead — iterative camera pose regression from the camera token (port
of vitslam_tpu/models/camera_head.py).

The last tap's camera token (B, S, 2C) is LayerNormed; each of ``num_iters``
refinement iterations embeds the current 9-d encoding (the learned empty
pose first), produces adaLN shift/scale/gate, modulates the tokens as
``gate * (adaln_norm(x) * (1 + scale) + shift) + x``, runs the trunk of
self-attention blocks across the S frames, and regresses a delta through
``pose_branch``. Encodings are fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Block, Dense, LayerNorm, Mlp, _param


def activate_pose(enc: torch.Tensor, trans_act: str = "linear",
                  quat_act: str = "linear", fov_act: str = "relu") -> torch.Tensor:
    """Per-part activation of a 9-d absT_quaR_FoV encoding."""

    def act(x, kind):
        if kind == "linear":
            return x
        if kind == "relu":
            return F.relu(x)
        raise ValueError(f"unknown pose activation {kind!r}")

    return torch.cat([act(enc[..., :3], trans_act), act(enc[..., 3:7], quat_act),
                      act(enc[..., 7:], fov_act)], dim=-1)


class CameraHead(nn.Module):
    def __init__(self, dim_in: int = 2048, trunk_depth: int = 4,
                 num_heads: int = 16, mlp_ratio: float = 4.0, pose_dim: int = 9,
                 num_iters: int = 4, init_values: float = 0.01,
                 trans_act: str = "linear", quat_act: str = "linear",
                 fov_act: str = "relu", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.pose_dim, self.num_iters, self.dtype = pose_dim, num_iters, dtype
        self.acts = (trans_act, quat_act, fov_act)
        self.token_norm = LayerNorm(dim_in, dtype, device=device)
        self.embed_pose = Dense(pose_dim, dim_in, dtype=dtype, device=device)
        self.modulation = Dense(dim_in, 3 * dim_in, dtype=dtype, device=device)
        self.trunk_names = [f"trunk_{i}" for i in range(trunk_depth)]
        for name in self.trunk_names:
            self.add_module(name, Block(dim_in, num_heads, mlp_ratio, qk_norm=False,
                                        init_values=init_values, dtype=dtype,
                                        device=device))
        self.trunk_norm = LayerNorm(dim_in, dtype, device=device)
        self.adaln_norm = LayerNorm(dim_in, dtype, use_scale=False, use_bias=False,
                                    device=device)
        self.pose_branch = Mlp(dim_in, dim_in // 2, pose_dim, dtype=torch.float32,
                               device=device)
        self.empty_pose_tokens = _param(1, 1, pose_dim, device=device)

    def init_params(self, g):
        self.empty_pose_tokens.zero_()

    def forward(self, camera_tokens: torch.Tensor) -> list[torch.Tensor]:
        """camera_tokens (B, S, dim_in) -> list of num_iters (B, S, 9) fp32."""
        B, S, _ = camera_tokens.shape
        x = self.token_norm(camera_tokens.to(self.dtype))
        pred = None
        preds = []
        for _ in range(self.num_iters):
            cond_in = (self.empty_pose_tokens.expand(B, S, self.pose_dim)
                       if pred is None else pred.detach())
            cond = self.embed_pose(cond_in.to(self.dtype))
            shift, scale, gate = self.modulation(F.silu(cond)).chunk(3, dim=-1)
            h = gate * (self.adaln_norm(x) * (1.0 + scale) + shift) + x
            for name in self.trunk_names:
                h = getattr(self, name)(h)
            delta = self.pose_branch(self.trunk_norm(h).float())
            pred = delta if pred is None else pred + delta
            preds.append(activate_pose(pred, *self.acts))
        return preds
