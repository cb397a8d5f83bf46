"""Relation-aware attention over the batch-global relation bank, in plain
torch — port of gtos_tpu/ops/attention.py (the JAX package's "xla" impl).

For every ordered node pair (i, j) with bank row r = rel_index[b, i, j]:

    e_ij = scale * (q_i + a_r) . (k_j + b_r)
         = scale * (q_i.k_j + q_i.b_r + a_r.k_j + a_r.b_r)

The three relation terms are computed against the bank ([N, P] tables)
and gathered per pair, so nothing of size N^2 * D is materialized. This is
also the independent oracle of the localized kernel's plain version
(ops/local_relation_attention.py). Scores and softmax in f32. The one
exception, `dense_relation_scores_reference`, materializes the pair
tensors on purpose: it is the bench's baseline, never on the model's path.

Shapes: q, k, v [B, H, N, D]; a_bank, b_bank [P, H, D]; rel_index
[B, N, N] int; key_mask [B, N] bool (True = real node).
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def bank_relation_scores(q, k, a_bank, b_bank, rel_index, *, scale=None):
    """Unnormalized f32 scores e: [B, H, N, N] via the 4-term decomposition."""
    B, H, N, D = q.shape
    if scale is None:
        scale = D ** -0.5
    q, k = q.float(), k.float()
    a_bank, b_bank = a_bank.float(), b_bank.float()
    idx = rel_index.long()

    t1 = torch.matmul(q, k.transpose(-1, -2))
    # T2[b,h,i,p] = q_i . b_p, gathered at p = idx[b,i,j]
    t2 = torch.einsum("bhid,phd->bhip", q, b_bank)
    t2g = t2.gather(-1, idx[:, None].expand(B, H, N, N))
    # T3[b,h,j,p] = k_j . a_p, gathered at p = idx[b,i,j] (indexed by j)
    t3 = torch.einsum("bhjd,phd->bhjp", k, a_bank)
    t3g = t3.gather(-1, idx.transpose(1, 2)[:, None].expand(B, H, N, N)
                    ).transpose(-1, -2)
    # T4[p, h] = a_p . b_p, one scalar per bank row per head
    t4 = torch.einsum("phd,phd->ph", a_bank, b_bank)
    t4g = t4[idx].permute(0, 3, 1, 2)
    return (t1 + t2g + t3g + t4g) * scale


def dense_relation_scores_reference(q, k, a_bank, b_bank, rel_index, *,
                                    scale=None):
    """The reference-style dense materialization, never on the model's
    path: gathers the full [B, N, N, H, D] relation pair tensors, then
    sum((q_i + a_ij) . (k_j + b_ij)) in f32, times the scale: [B, H, N, N].
    Equal to bank_relation_scores up to rounding; the baseline of the
    bench's north-star cell (edges/s) and of the tests. The gathers are
    index_select, whose backward is one index_add_ (an XLA scatter-add in
    the JAX package); autograd of `a_bank[idx]` would sort the indices
    and accumulate each bank row's pairs one after another."""
    B, H, N, D = q.shape
    if scale is None:
        scale = D ** -0.5
    idx = rel_index.long().reshape(-1)
    a_pair = a_bank.index_select(0, idx).view(B, N, N, H, D)
    b_pair = b_bank.index_select(0, idx).view(B, N, N, H, D)
    qe = q.transpose(1, 2)[:, :, None]                    # [B, N, 1, H, D]
    ke = k.transpose(1, 2)[:, None]                       # [B, 1, N, H, D]
    e = ((qe + a_pair).float() * (ke + b_pair).float()).sum(-1)
    return e.permute(0, 3, 1, 2) * scale                  # [B, H, N, N]


def masked_softmax(scores, key_mask):
    """Softmax over the last axis with masked key positions at -1e9."""
    neg = torch.where(key_mask[:, None, None, :], 0.0, NEG_INF)
    return torch.softmax(scores + neg, dim=-1)


def bank_relation_attention(q, k, v, a_bank, b_bank, rel_index, key_mask,
                            *, scale=None):
    """Scores -> masked softmax -> aggregate. Returns (out [B, H, N, D] in
    v.dtype, attn [B, H, N, N] f32)."""
    e = bank_relation_scores(q, k, a_bank, b_bank, rel_index, scale=scale)
    attn = masked_softmax(e, key_mask)
    out = torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)
    return out, attn
