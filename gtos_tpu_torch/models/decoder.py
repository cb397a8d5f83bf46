"""Transformer decoder with an alignment cross-attention for the copy path.

Port of gtos_tpu/models/decoder.py. Two modes share all parameters:
`forward`, the teacher-forced full sequence (training: input dropout, the
causal self-mask, dropout in the residuals and the FFN), and `step`, one
token over a horizon-sized KV cache with precomputed memory K/V (search,
no dropout). The last layer's cross-attention distribution feeds the copy
mechanism (models/generator.py).
"""

from __future__ import annotations

import torch
from torch import nn

from gtos_tpu_torch.models.components import (
    Dropout, Embedding, FeedForward, MultiheadAttention, PostLNResidual,
    causal_mask, sinusoidal_positions, step_position,
)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int, heads: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.self_attn = MultiheadAttention(d_model, heads)
        self.self_res = PostLNResidual(d_model, dropout)
        self.cross_attn = MultiheadAttention(d_model, heads)
        self.cross_res = PostLNResidual(d_model, dropout)
        self.ffn = FeedForward(d_model, d_ff, dropout)
        self.ffn_res = PostLNResidual(d_model, dropout)

    def forward(self, x, mem, mem_mask, self_mask):
        """x: [B,T,D]; mem: [B,N,D]; mem_mask: [B,N]; self_mask
        [1,1,T,T]. Returns (x, cross_probs [B,H,T,N] f32)."""
        sa, _ = self.self_attn(x, x, x, self_mask)
        x = self.self_res(x, sa)
        ca, cross_probs = self.cross_attn(x, mem, mem,
                                          mem_mask[:, None, None, :])
        x = self.cross_res(x, ca)
        return self.ffn_res(x, self.ffn(x)), cross_probs

    def init_cache(self, B: int, Tmax: int, mem):
        """Self-attn KV buffers [B, H, Tmax, Dh] + precomputed memory KV.
        Tmax should be the search horizon: every step reads the whole
        buffer, and beam search reorders it."""
        mem_k, mem_v = self.cross_attn.project_kv(mem, mem)
        H, Dh = mem_k.shape[1], mem_k.shape[3]
        shape = (B, H, Tmax, Dh)
        return dict(self_k=mem.new_zeros(shape), self_v=mem.new_zeros(shape),
                    mem_k=mem_k, mem_v=mem_v)

    def step(self, x_t, cache, pos, mem_mask):
        """x_t: [B,1,D]; pos: a 0-d int64 tensor on the card (or an int).
        Returns (x_t, cache, cross_probs [B,H,1,N]); the self-KV buffers
        of `cache` are written in place."""
        sa, ck, cv = self.self_attn.step_self(
            x_t, cache["self_k"], cache["self_v"], pos)
        x_t = self.self_res(x_t, sa)
        ca, cross_probs = self.cross_attn.attend_precomputed(
            x_t, cache["mem_k"], cache["mem_v"], mem_mask[:, None, None, :])
        x_t = self.cross_res(x_t, ca)
        x_t = self.ffn_res(x_t, self.ffn(x_t))
        return x_t, dict(cache, self_k=ck, self_v=cv), cross_probs


class Decoder(nn.Module):
    """Embedding + positions + N DecoderLayers. The output projection is
    tied to this embedding (`output_logits`)."""

    def __init__(self, vocab: int, layers: int, d_model: int, d_ff: int,
                 heads: int, max_len: int, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.d_model, self.max_len, self.layers = d_model, max_len, layers
        self.embed = Embedding(vocab, d_model, dtype)
        self.input_drop = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer{i}",
                            DecoderLayer(d_model, d_ff, heads, dropout))
        self.register_buffer("pos_table",
                             sinusoidal_positions(max_len, d_model),
                             persistent=False)

    def blocks(self):
        return [getattr(self, f"layer{i}") for i in range(self.layers)]

    def embed_tokens(self, ids):
        return self.embed(ids) * (self.d_model ** 0.5)

    def output_logits(self, h):
        """Tied softmax projection: h [.., D] -> logits [.., vocab], both
        rounded to the compute type."""
        dt = self.embed.dtype
        return torch.matmul(h.to(dt), self.embed.weight.to(dt).t())

    def forward(self, token_in, mem, mem_mask):
        """Teacher-forced: token_in [B,T] -> (h [B,T,D], align [B,H,T,N],
        the last layer's cross-attention probabilities)."""
        T = token_in.shape[1]
        x = self.embed_tokens(token_in)
        x = self.input_drop(x + self.pos_table[:T][None].to(x.dtype))
        smask = causal_mask(T, device=x.device)
        align = None
        for blk in self.blocks():
            x, align = blk(x, mem, mem_mask, smask)
        group = blk.cross_attn.tp_group
        if group is not None:   # tensor parallel: this rank's heads
            from gtos_tpu_torch.parallel.comm import gather_blocks
            align = gather_blocks(align, group, 1)
        return x, align

    def init_cache(self, B: int, mem, horizon=None):
        """horizon: self-KV buffer length (number of decode steps);
        defaults to max_len."""
        Tmax = self.max_len if horizon is None else min(horizon, self.max_len)
        return [blk.init_cache(B, Tmax, mem) for blk in self.blocks()]

    def step(self, token_t, pos, caches, mem_mask):
        """token_t: [B] int; pos: the step's position, a 0-d int64 tensor
        on the tokens' device (or an int): read on the card, so one
        captured step serves every position. Returns (h_t [B,D], caches,
        align [B,H,N])."""
        pos = step_position(pos, token_t.device)
        x = self.embed_tokens(token_t[:, None])
        x = x + self.pos_table.index_select(0, pos.reshape(1)).to(x.dtype)
        new_caches, align = [], None
        for blk, cache in zip(self.blocks(), caches):
            x, cache, align = blk.step(x, cache, pos, mem_mask)
            new_caches.append(cache)
        group = blk.cross_attn.tp_group
        if group is not None:   # tensor parallel: this rank's heads
            from gtos_tpu_torch.parallel.comm import gather_blocks
            align = gather_blocks(align, group, 1)
        return x[:, 0], new_caches, align[:, :, 0]
