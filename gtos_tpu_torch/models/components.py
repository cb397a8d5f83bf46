"""Shared transformer building blocks.

Port of gtos_tpu/models/components.py: multi-head attention with an
incremental step, sinusoidal positions, post-LN residuals, the FFN.
Batch-major [B, T, D] layout and parameter names as in the JAX package, so
`convert.py` maps its parameter tree onto these modules name for name.

Numerics follow the JAX package: parameters are kept in f32 and each
layer rounds its weights to the activations' type at use (flax's
`param_dtype` f32 with `dtype` the compute type; a no-op when the weights
are already in that type, as in the serving copy), attention scores and
softmax in f32, LayerNorm statistics in f32 with epsilon 1e-6 (flax's
default; torch's is 1e-5). Dropout is flax's: in training each element is
kept with probability 1-p and scaled by 1/(1-p), with bits from an
explicit torch.Generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


class Dense(nn.Linear):
    """nn.Linear that rounds its f32 weight and bias to the input's type at
    use (flax Dense with dtype = the compute type). Under tensor
    parallelism (parallel/tensor_parallel.py) `tp` is ("column" | "row",
    group): a column layer's input has its gradient summed over the group;
    a row layer's output is all-reduced over it before the bias is
    added."""

    tp = None

    def forward(self, x):
        if self.tp is None:
            return F.linear(x, self.weight.to(x.dtype),
                            self.bias.to(x.dtype))
        from gtos_tpu_torch.parallel import comm
        kind, group = self.tp
        if kind == "column":
            return F.linear(comm.sum_grads(x, group),
                            self.weight.to(x.dtype), self.bias.to(x.dtype))
        y = comm.all_reduce(F.linear(x, self.weight.to(x.dtype)), group)
        return y + self.bias.to(x.dtype)


class Embedding(nn.Embedding):
    """nn.Embedding whose rows come out in the compute type `dtype` (flax
    Embed with dtype set: the same values as rounding the table first)."""

    def __init__(self, num: int, dim: int, dtype=torch.float32):
        super().__init__(num, dim)
        self.dtype = dtype

    def forward(self, ids):
        return super().forward(ids).to(self.dtype)


class Dropout(nn.Module):
    """flax.linen.Dropout: an identity in eval mode or at rate 0; in
    training, where(keep, x / (1 - p), 0) with keep ~ Bernoulli(1 - p).
    The bits come from `rng`, a torch.Generator on the activations' device
    that the owning model sets (models/generator.py). `shard` = (r, n):
    x is column block r of n of a wider tensor (tensor parallelism); the
    whole width's mask is drawn and its block kept."""

    shard = None

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.rng: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        if self.shard is None:
            keep = torch.rand(x.shape, generator=self.rng,
                              device=x.device) < keep_prob
        else:
            r, n = self.shard
            w = x.shape[-1]
            keep = (torch.rand((*x.shape[:-1], w * n), generator=self.rng,
                               device=x.device) < keep_prob
                    )[..., r * w:(r + 1) * w]
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """[length, dim] sinusoidal embeddings (first half sin, second cos),
    computed on `device` (default the CPU): no copy from the host, so a
    captured step may build them."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.arange(length, **f32)[:, None]
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, **f32) / half)
    ang = pos * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, D/H]."""
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, Dh] -> [B, T, H*Dh]."""
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def attend(q, k, v, mask: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled dot-product attention; softmax in f32. q [B,H,Tq,Dh], k/v
    [B,H,Tk,Dh], mask broadcastable to [B,H,Tq,Tk] (True = keep).
    Returns (out in v.dtype, f32 probs)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return out, probs


class LayerNorm(nn.LayerNorm):
    """LayerNorm with flax's epsilon, computed in f32 whatever the input
    type (its parameters stay f32 when the model is cast)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class MultiheadAttention(nn.Module):
    """Projections + attention, full-sequence or one step with a cache.
    Under tensor parallelism `heads` is this rank's and `tp_group` set
    (parallel/tensor_parallel.py)."""

    tp_group = None

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.out_proj = Dense(d_model, d_model)

    def forward(self, query, key, value, mask=None):
        """query [B,Tq,D], key/value [B,Tk,D]; mask [B,1|H,Tq,Tk] or None."""
        q = split_heads(self.q_proj(query), self.heads)
        k, v = self.project_kv(key, value)
        out, probs = attend(q, k, v, mask)
        return self.out_proj(merge_heads(out)), probs

    def project_kv(self, key, value):
        """Precompute K/V (e.g. cross-attention memory, built once)."""
        return (split_heads(self.k_proj(key), self.heads),
                split_heads(self.v_proj(value), self.heads))

    def attend_precomputed(self, query, k, v, mask=None):
        """Attention against already-projected K/V ([B,H,Tk,Dh])."""
        q = split_heads(self.q_proj(query), self.heads)
        out, probs = attend(q, k, v, mask)
        return self.out_proj(merge_heads(out)), probs

    def step_self(self, x_t, cache_k, cache_v, pos):
        """One causal self-attention step.

        x_t: [B, 1, D]; cache_k/v: [B, H, Tmax, Dh] (positions < pos
        valid); pos: a 0-d int64 tensor on x_t's device (an int is taken
        too), so that one captured step serves every position. Writes
        position `pos` of the caches IN PLACE (the JAX package returns
        updated copies) and returns (out [B,1,D], cache_k, cache_v)."""
        pos = step_position(pos, x_t.device)
        at = pos.reshape(1)
        q = split_heads(self.q_proj(x_t), self.heads)      # [B,H,1,Dh]
        cache_k.index_copy_(2, at, split_heads(self.k_proj(x_t), self.heads))
        cache_v.index_copy_(2, at, split_heads(self.v_proj(x_t), self.heads))
        Tmax = cache_k.shape[2]
        valid = torch.arange(Tmax, device=x_t.device) <= pos   # [Tmax]
        out, _ = attend(q, cache_k, cache_v, valid)
        return self.out_proj(merge_heads(out)), cache_k, cache_v


def step_position(pos, device) -> torch.Tensor:
    """A decode step's position as a 0-d int64 tensor on `device`."""
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.int64)
    return torch.tensor(pos, dtype=torch.int64, device=device)


class FeedForward(nn.Module):
    """fc2(dropout(relu(fc1(x))))."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Dense(d_model, d_ff)
        self.fc2 = Dense(d_ff, d_model)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


class PostLNResidual(nn.Module):
    """x = LayerNorm(x + dropout(f(x))) — the reference's fairseq post-LN
    convention."""

    def __init__(self, d_model: int, dropout: float = 0.0):
        super().__init__()
        self.ln = LayerNorm(d_model)
        self.drop = Dropout(dropout)

    def forward(self, x, sub):
        return self.ln(x + self.drop(sub)).to(x.dtype)


def causal_mask(T: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] lower-triangular True mask."""
    return torch.tril(torch.ones(T, T, dtype=torch.bool, device=device)
                      )[None, None]
