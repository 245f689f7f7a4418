"""AlignmentHead — the trained feature-level chunk aligner (port of
vitslam_tpu/models/alignment_head.py).

From the current chunk's backbone tokens, the previous chunk's overlap
tokens and the rolling unit-norm memory tokens it regresses a chunk Sim(3)
encoding (B, 1, 8) = [t, quat_xyzw, scale] and per-frame SE(3) corrections
(B, S-1, 7), and emits the next chunk's overlap tokens and memory.

Encoder: project_in + LayerNorm, a per-frame alignment token, ``depth_aa``
rounds of frame attention (2-D RoPE) and either temporal cross-attention
over time at each spatial location (1-D RoPE, current positions shifted by
S - (T - 1) so overlapping frames share ids; self-attention on the first
chunk) or global attention over the (T+S)*P tokens. Decoder (fp32): chunk
token cross-attends frame tokens and memory, GatedUpdate writes the memory,
frame tokens cross-attend the chunk token, small MLPs decode the encodings.
In training (``train=True``) the non-overlap frame tokens of a continuation
chunk are dropped with probability ``drop_prob_nonoverlap`` before the frame
decoder and the rest rescaled by 1/(1-p), the keep mask drawn from the
``torch.Generator`` the caller passes; and every frame, temporal and global
block is recomputed in the backward instead of keeping its activations
(``ops.attention.remat``, the reference's ``nn.remat(Block) if train``).
The dropout draws sit in the decoder, outside the recomputed blocks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.gated_update import GatedUpdate
from ..nn.layers import Block, CrossAttentionBlock, Dense, LayerNorm, Mlp, _param
from ..nn.rope import patch_grid_positions
from ..ops.attention import remat
from .aggregator import expand_frame_tokens


class AlignmentHead(nn.Module):
    def __init__(self, patch_size: int = 14, in_dim: int = 2048,
                 embed_dim: int = 1024, dec_dim: int = 512, depth_aa: int = 4,
                 depth_decoder: int = 2, num_heads: int = 8, mlp_ratio: float = 4.0,
                 num_register_tokens: int = 4, qk_norm: bool = True,
                 rope_base: float = 100.0, init_values: float = 0.01,
                 num_memory_tokens: int = 8, temporal_attention: bool = True,
                 drop_prob_nonoverlap: float = 0.2, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.patch_size, self.embed_dim, self.dec_dim = patch_size, embed_dim, dec_dim
        self.depth_aa, self.depth_decoder = depth_aa, depth_decoder
        self.num_register_tokens = num_register_tokens
        self.num_memory_tokens = num_memory_tokens
        self.temporal_attention, self.dtype = temporal_attention, dtype
        self.drop_prob_nonoverlap = drop_prob_nonoverlap
        enc = dict(mlp_ratio=mlp_ratio, qk_norm=qk_norm, init_values=init_values,
                   rope_base=rope_base, device=device)
        self.project_in = Dense(in_dim, embed_dim, dtype=dtype, device=device)
        self.token_norm = LayerNorm(embed_dim, dtype, device=device)
        self.per_frame_alignment_token = _param(2, 1, embed_dim, device=device)
        for i in range(depth_aa):
            self.add_module(f"frame_block_{i}", Block(embed_dim, num_heads, rope="2d",
                                                      dtype=dtype, **enc))
            if temporal_attention:
                self.add_module(f"temporal_block_{i}", CrossAttentionBlock(
                    embed_dim, num_heads, rope="1d", dtype=dtype, **enc))
            else:
                self.add_module(f"global_block_{i}", Block(embed_dim, num_heads, rope="2d",
                                                           dtype=dtype, **enc))
        f32 = torch.float32
        self.project_dec = Dense(embed_dim, dec_dim, dtype=f32, device=device)
        self.dec_norm = LayerNorm(dec_dim, f32, device=device)
        M = num_memory_tokens
        if M > 0:
            self.memory_token = _param(M, dec_dim, device=device)
            self.frame_proj = Dense(dec_dim, M * dec_dim, dtype=f32, device=device)
            self.alpha = _param(device=device)
            self.gated_update = GatedUpdate(dec_dim, M, device=device)
        for i in range(depth_decoder):
            self.add_module(f"chunk_cross_block_{i}", CrossAttentionBlock(
                dec_dim, num_heads, rope="1d", dtype=f32, **enc))
        self.chunk_norm = LayerNorm(dec_dim, f32, device=device)
        for i in range(depth_decoder):
            self.add_module(f"frame_cross_block_{i}", CrossAttentionBlock(
                dec_dim, num_heads, rope="1d", dtype=f32, **enc))
        self.frame_norm = LayerNorm(dec_dim, f32, device=device)
        self.frame_se3_decoder = Mlp(dec_dim, dec_dim // 2, 7, dtype=f32, device=device)
        self.chunk_sim3_decoder = Mlp(dec_dim, dec_dim // 2, 8, dtype=f32, device=device)

    def init_params(self, g):
        nn.init.normal_(self.per_frame_alignment_token, 0.0, 1e-6, generator=g)
        if self.num_memory_tokens > 0:
            # orthogonal rows normalised to unit norm (avoids early memory collapse)
            nn.init.orthogonal_(self.memory_token, generator=g)
            self.memory_token /= self.memory_token.norm(dim=-1, keepdim=True).clamp_min(1e-8)
            self.alpha.fill_(0.1)

    @property
    def patch_start_idx(self) -> int:
        # alignment token + camera token + register tokens
        return 1 + 1 + self.num_register_tokens

    def forward(self, tokens: torch.Tensor, image_size: Tuple[int, int],
                next_num_overlap: int, overlap_tokens: Optional[torch.Tensor] = None,
                memory_tokens: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                batch_rows: Optional[Tuple[int, int]] = None):
        """tokens (B, S, P0, in_dim); overlap_tokens (B, T, 1+P0, embed_dim)
        or None (first chunk; detached on receipt); memory_tokens (B, M,
        dec_dim) or None; train: the non-overlap frame dropout, drawn from
        ``generator`` (torch's default generator when None). batch_rows
        (offset, total): these B rows are rows [offset, offset + B) of a
        global batch of ``total`` split over data-parallel ranks; the
        dropout draws the global batch's uniforms and keeps these rows, so
        every rank draws what one process running the global batch would.
        Returns (chunk_sim3_enc (B, 1, 8), frame_se3_encs (B, S-1, 7),
        memory_tokens (B, M, dec_dim) or None,
        new_overlap_tokens (B, 1+next_num_overlap, 1+P0, embed_dim))."""
        H, W = image_size
        B, S, P0, _ = tokens.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        E = self.embed_dim
        dev = tokens.device
        x = self.token_norm(self.project_in(tokens.to(self.dtype)))
        first_chunk = overlap_tokens is None
        T = None
        if not first_chunk:
            overlap_tokens = overlap_tokens.detach().to(self.dtype)
            T = overlap_tokens.shape[1]
        at = expand_frame_tokens(self.per_frame_alignment_token, B, S).reshape(B, S, 1, E)
        x = torch.cat([at.to(self.dtype), x], dim=2)
        P = x.shape[2]  # 1 + P0

        pos2d = patch_grid_positions(B * S, gh, gw, self.patch_start_idx, dev)
        seq_ids = torch.arange(S, device=dev)
        if self.temporal_attention:
            if not first_chunk:
                att_ids = seq_ids + (S - (T - 1))
                cross_ids = torch.cat([seq_ids[:1], seq_ids[-(T - 1):]])
            else:
                att_ids = cross_ids = seq_ids
            pos_t = (att_ids[None].expand(B * P, S),
                     cross_ids[None].expand(B * P, cross_ids.shape[0]))
        else:
            n_frames = S if first_chunk else S + T
            pos_global = patch_grid_positions(
                B * n_frames, gh, gw, self.patch_start_idx, dev).reshape(B, n_frames * P, 2)

        for i in range(self.depth_aa):
            xf = remat(train, getattr(self, f"frame_block_{i}"), x.reshape(B * S, P, E), pos2d)
            x = xf.reshape(B, S, P, E)
            if self.temporal_attention:
                xt = x.transpose(1, 2).reshape(B * P, S, E)
                cross = (xt if first_chunk else
                         overlap_tokens.transpose(1, 2).reshape(B * P, T, E))
                xt = remat(train, getattr(self, f"temporal_block_{i}"), xt, cross, pos_t)
                x = xt.reshape(B, P, S, E).transpose(1, 2)
            else:
                if first_chunk:
                    xg = x.reshape(B, S * P, E)
                else:
                    xg = torch.cat([overlap_tokens, x], dim=1).reshape(B, (S + T) * P, E)
                xg = remat(train, getattr(self, f"global_block_{i}"), xg, pos_global)
                x = xg.reshape(B, -1, P, E)[:, -S:]

        chunk_sim3_enc, frame_se3_encs, memory_tokens = self._decode(
            x[:, :, 0, :].float(), memory_tokens, next_num_overlap,
            train and not first_chunk, generator, batch_rows)
        new_overlap = torch.cat([x[:, :1], x[:, S - next_num_overlap:]], dim=1)
        return chunk_sim3_enc, frame_se3_encs, memory_tokens, new_overlap

    def _decode(self, frame_tokens_in, memory_tokens, num_overlap: int, dropout: bool,
                generator: Optional[torch.Generator], batch_rows=None):
        """fp32 decode of the alignment encodings; ``dropout``: drop the
        non-overlap frame tokens (a training continuation chunk)."""
        B, S, _ = frame_tokens_in.shape
        M = self.num_memory_tokens
        dev = frame_tokens_in.device
        tokens = self.dec_norm(self.project_dec(frame_tokens_in))

        # 1-D RoPE ids: the chunk token (id 0) attends frames 0..S-1 and the
        # memory at ids 2S.. (outside the frame range)
        seq = torch.arange(S, device=dev)
        cross_ids = torch.cat([seq, torch.arange(S, S + M, device=dev) + S]) if M > 0 else seq
        zeros = torch.zeros((B, 1), dtype=torch.long, device=dev)
        pos_chunk = (zeros, cross_ids[None].expand(B, cross_ids.shape[0]))
        pos_frames = (torch.arange(1, S, device=dev)[None].expand(B, S - 1), zeros)

        directional_memory = None
        if M > 0:
            token_scale = tokens.norm(dim=-1).mean(dim=-1, keepdim=True)[:, None]  # (B, 1, 1)
            if memory_tokens is None:
                base_mem = self.memory_token[None].expand(B, M, self.dec_dim)
                frame_init = self.frame_proj(tokens[:, 0]).reshape(B, M, self.dec_dim)
                frame_dir = frame_init / frame_init.norm(dim=-1, keepdim=True).clamp_min(1e-6)
                alpha = torch.sigmoid(self.alpha)
                directional_memory = (1 - alpha) * base_mem + alpha * frame_dir
                effective_memory = base_mem * token_scale
            else:
                directional_memory = memory_tokens.float()
                effective_memory = directional_memory * token_scale
            cross_tokens = torch.cat([tokens, effective_memory], dim=1)
        else:
            cross_tokens = tokens

        chunk_tok = tokens[:, :1]
        for i in range(self.depth_decoder):
            chunk_tok = getattr(self, f"chunk_cross_block_{i}")(chunk_tok, cross_tokens,
                                                                pos_chunk)
        new_memory = None
        if M > 0:
            new_memory = self.gated_update(directional_memory, chunk_tok[:, 0])
        chunk_tok = self.chunk_norm(chunk_tok)

        frame_toks = tokens[:, 1:]
        p = self.drop_prob_nonoverlap
        n_drop = S - 1 - num_overlap
        if dropout and p > 0.0 and n_drop > 1:
            offset, total = batch_rows if batch_rows is not None else (0, B)
            u = torch.rand((total, n_drop), generator=generator,
                           device=generator.device if generator is not None else dev)
            u = u[offset:offset + B]
            keep = (u.to(dev) > p).float()[..., None]
            mask = torch.cat([keep, torch.ones((B, num_overlap, 1), device=dev)], dim=1)
            frame_toks = frame_toks * mask / (1.0 - p)
        for i in range(self.depth_decoder):
            frame_toks = getattr(self, f"frame_cross_block_{i}")(frame_toks, chunk_tok,
                                                                 pos_frames)
        frame_toks = self.frame_norm(frame_toks)

        frame_se3_encs = self.frame_se3_decoder(frame_toks)
        chunk_sim3 = self.chunk_sim3_decoder(chunk_tok)
        chunk_sim3 = torch.cat(
            [chunk_sim3[..., :-1], torch.exp(chunk_sim3[..., -1:].clamp(-20.0, 20.0))], dim=-1)
        return chunk_sim3, frame_se3_encs, new_memory
