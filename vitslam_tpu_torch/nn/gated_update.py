"""GatedUpdate — the AlignmentHead's memory-token writer (port of
vitslam_tpu/nn/gated_update.py).

* N per-token delta MLPs (3D -> D -> D, GELU) over
  [update | memory * |u| | mean(memory) * |u|], as one batched einsum over
  stacked per-token weights;
* one shared gate MLP (2D -> D -> 1) over the gradient-detached
  [delta - memory | memory * |u|];
* the delta is orthogonalised against the unit memory direction,
  normalised, gated, and the result put back on the unit sphere.
All fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _param, lecun_normal_


class GatedUpdate(nn.Module):
    def __init__(self, token_dim: int, num_tokens: int, init_gate: float = 0.5,
                 device=None):
        super().__init__()
        D, N = token_dim, num_tokens
        self.token_dim, self.num_tokens, self.init_gate = D, N, init_gate
        self.delta_w1 = _param(N, 3 * D, D, device=device)
        self.delta_b1 = _param(N, D, device=device)
        self.delta_w2 = _param(N, D, D, device=device)
        self.delta_b2 = _param(N, D, device=device)
        self.gate_fc1 = Dense(2 * D, D, device=device)
        self.gate_fc2 = Dense(D, 1, device=device)

    def init_params(self, g):
        # flax lecun_normal on (N, in, out): fan_in = N * in
        for w in (self.delta_w1, self.delta_w2):
            lecun_normal_(w, w.shape[0] * w.shape[1], g)
        self.delta_b1.zero_()
        self.delta_b2.zero_()
        # the gate's final layer: small weights, bias at logit(init_gate)
        # (init_weights runs a parent after its children, so this overrides
        # the generic Dense init)
        nn.init.normal_(self.gate_fc2.weight, 0.0, 0.1, generator=g)
        self.gate_fc2.bias.fill_(math.log(self.init_gate / (1.0 - self.init_gate)))

    def forward(self, memory: torch.Tensor, update: torch.Tensor) -> torch.Tensor:
        """memory (B, N, D) unit-norm tokens; update (B, D) -> (B, N, D)."""
        B, N, D = memory.shape
        if N != self.num_tokens or D != self.token_dim:
            raise ValueError(f"memory {tuple(memory.shape)} does not match "
                             f"({self.num_tokens}, {self.token_dim})")
        mem = memory.float()
        upd = update.float()
        u_scale = upd.norm(dim=-1, keepdim=True)[:, None]  # (B, 1, 1)
        mem_scaled = mem * u_scale
        mem_mean_scaled = mem.mean(dim=1, keepdim=True).expand(B, N, D) * u_scale
        delta_in = torch.cat([upd[:, None].expand(B, N, D), mem_scaled,
                              mem_mean_scaled], dim=-1)
        hid = F.gelu(torch.einsum("bni,nio->bno", delta_in, self.delta_w1) + self.delta_b1)
        deltas = torch.einsum("bni,nio->bno", hid, self.delta_w2) + self.delta_b2
        delta_diff = deltas - mem

        gate_in = torch.cat([delta_diff, mem_scaled], dim=-1).detach()
        gate = torch.sigmoid(self.gate_fc2(F.gelu(self.gate_fc1(gate_in))))

        proj = (delta_diff * mem).sum(dim=-1, keepdim=True) * mem
        delta_orth = delta_diff - proj
        delta_dir = delta_orth / delta_orth.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        new_mem = mem + gate * delta_dir
        new_mem = new_mem / new_mem.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return new_mem.to(memory.dtype)
