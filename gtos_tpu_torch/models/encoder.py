"""Input encoders: concept/char token encoder and the path-GRU relation
encoder.

Port of gtos_tpu/models/encoder.py: concept embedding + character CNN, and
a bidirectional GRU over each unique relation path in the batch bank, with
the carry frozen at pad steps (the backward direction runs over the whole
reversed padded sequence, so its leading pads are skipped the same way).
Dropout where the JAX package has it: at the token encoder's output, on
the relation embeddings and at the relation encoder's output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gtos_tpu_torch.models.components import (
    Dense, Dropout, Embedding, LayerNorm, sinusoidal_positions,
)


class Conv1d(nn.Conv1d):
    """nn.Conv1d that rounds its f32 weight and bias to the input's type at
    use (flax Conv with dtype = the compute type)."""

    def forward(self, x):
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class CharCNN(nn.Module):
    """Multi-width char convolutions ("SAME" padding), max-pooled over the
    real chars of each word. chars: [B, N, C] ids."""

    def __init__(self, char_vocab: int, char_dim: int, filters: int,
                 widths, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.widths = tuple(widths)
        self.char_embed = Embedding(char_vocab, char_dim, dtype)
        for w in self.widths:
            setattr(self, f"conv{w}", Conv1d(char_dim, filters, w))
        self.char_proj = Dense(filters * len(self.widths), out_dim)

    def forward(self, chars):
        B, N, C = chars.shape
        x = self.char_embed(chars).reshape(B * N, C, -1).transpose(1, 2)
        real = (chars.reshape(B * N, C) != 0)               # [B*N, C]
        pooled = []
        for w in self.widths:
            # flax "SAME": (w-1)//2 zeros before, w//2 after
            h = getattr(self, f"conv{w}")(F.pad(x, ((w - 1) // 2, w // 2)))
            h = torch.relu(h).masked_fill(~real[:, None, :], -1e9)
            pooled.append(h.amax(dim=2))                     # [B*N, filters]
        h = torch.cat(pooled, dim=-1)
        # all-pad words (e.g. the CLS node) max-pool to -1e9; zero them
        h = h.masked_fill(~real.any(dim=1, keepdim=True), 0.0)
        return self.char_proj(h).reshape(B, N, -1)


class TokenEncoder(nn.Module):
    """Concept embedding + CharCNN -> d_model, LayerNorm (f32), dropout.

    add_positions: sinusoidal positions for the translator path, where
    nodes are source words in sentence order."""

    def __init__(self, vocab: int, char_vocab: int, d_model: int,
                 char_dim: int, char_filters: int, char_widths,
                 dropout: float = 0.0, dtype=torch.float32,
                 add_positions: bool = False):
        super().__init__()
        self.add_positions = add_positions
        self.embed = Embedding(vocab, d_model, dtype)
        self.char_cnn = CharCNN(char_vocab, char_dim, char_filters,
                                char_widths, d_model, dtype)
        self.merge = Dense(2 * d_model, d_model)
        self.ln = LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, ids, chars):
        emb = self.embed(ids)
        x = self.merge(torch.cat([emb, self.char_cnn(chars)], dim=-1))
        if self.add_positions:
            pos = sinusoidal_positions(ids.shape[1], x.shape[-1],
                                       device=x.device)
            x = x + pos[None].to(x.dtype)
        return self.drop(self.ln(x).to(emb.dtype))


class GRUCell(nn.Module):
    """flax.linen.GRUCell with its six dense layers fused into two: gate
    order (r, z, n); the input side has biases, the recurrent side only on
    n (flax's `hn`)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_dim))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))

    def scan(self, xs, valid):
        """xs [L, P, in], valid [L, P] bool -> last carry [P, hidden]; the
        carry stays frozen where valid is False."""
        dt = xs.dtype
        gi = F.linear(xs, self.weight_ih.to(dt), self.bias_ih.to(dt))
        w_hh, b_hn = self.weight_hh.to(dt), self.bias_hn.to(dt)
        hidden = self.bias_hn.shape[0]
        h = xs.new_zeros(xs.shape[1], hidden)
        for t in range(xs.shape[0]):
            gi_r, gi_z, gi_n = gi[t].split(hidden, dim=-1)
            gh_r, gh_z, gh_n = F.linear(h, w_hh).split(hidden, -1)
            r = torch.sigmoid(gi_r + gh_r)
            z = torch.sigmoid(gi_z + gh_z)
            n = torch.tanh(gi_n + r * (gh_n + b_hn))
            h = torch.where(valid[t][:, None], (1.0 - z) * n + z * h, h)
        return h


class RelationEncoder(nn.Module):
    """Bidirectional GRU over the relation bank.

    bank: [P, L] label ids; lengths: [P]. Returns [P, out_dim], with the
    rows of zero-length (pad) paths forced to zero. Each unique path in the
    batch is encoded once."""

    def __init__(self, relation_vocab: int, emb_dim: int, hidden: int,
                 out_dim: int, dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.rel_embed = Embedding(relation_vocab, emb_dim, dtype)
        self.gru_fwd = GRUCell(emb_dim, hidden)
        self.gru_bwd = GRUCell(emb_dim, hidden)
        self.out_proj = Dense(2 * hidden, out_dim)
        self.emb_drop = Dropout(dropout)
        self.out_drop = Dropout(dropout)

    def forward(self, bank, lengths):
        L = bank.shape[1]
        xs = self.emb_drop(self.rel_embed(bank)).transpose(0, 1)  # [L, P, e]
        valid = (torch.arange(L, device=bank.device)[:, None]
                 < lengths[None, :])                         # [L, P]
        h_fwd = self.gru_fwd.scan(xs, valid)
        h_bwd = self.gru_bwd.scan(xs.flip(0), valid.flip(0))
        out = self.out_proj(torch.cat([h_fwd, h_bwd], dim=-1))
        return self.out_drop(out.masked_fill((lengths == 0)[:, None], 0.0))
