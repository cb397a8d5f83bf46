"""Sparse (edge-list) relation-aware attention, the "sparse" impl (plain
torch, as the JAX package leaves it to XLA).

Port of gtos_tpu/ops/sparse_relation.py: the score

    e_ij = scale * (q_i + a_r) . (k_j + b_r),   r = rel of edge (i <- j)

is evaluated only on an explicit edge list, followed by a softmax over the
edges of each destination node and a weighted sum of the sources' values:
O(E) memory. It is also the backward of the block-sparse attention when a
batch has no src-major tile layout (ops/block_sparse_attention.py).

Edge tensors are flat [B, E] (flatten_edge_cells turns batchify's
[B, S, S, Ec] cells into them); masked edges point at node 0 and score
NEG_INF.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def _gather_nodes(x, idx):
    """x [B, H, N, D], idx [B, E] node ids -> [B, H, E, D]."""
    B, H, _, D = x.shape
    ii = idx.long()[:, None, :, None].expand(B, H, idx.shape[1], D)
    return torch.gather(x, 2, ii)


def edge_relation_scores(q, k, a_bank, b_bank, src, dst, rel, mask, *,
                         scale=None):
    """Per-edge SDDMM: e[b, h, e] = scale * (q[dst] + a[rel]).(k[src] +
    b[rel]) in f32. q, k: [B, H, N, D]; a_bank/b_bank: [P, H, D]; src/dst/
    rel: [B, E]; mask [B, E] bool. Masked edges score NEG_INF."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    f32 = torch.float32
    qd = _gather_nodes(q, dst).to(f32)
    ks = _gather_nodes(k, src).to(f32)
    ar = a_bank[rel.long()].permute(0, 2, 1, 3).to(f32)     # [B, H, E, D]
    br = b_bank[rel.long()].permute(0, 2, 1, 3).to(f32)
    e = ((qd + ar) * (ks + br)).sum(-1) * scale
    return torch.where(mask[:, None, :], e, NEG_INF)


def sparse_relation_attention(q, k, v, a_bank, b_bank, src, dst, rel, mask,
                              *, scale=None):
    """O(E) relation attention: q, k, v [B, H, N, D]; edges [B, E] (any dst
    order). Returns out [B, H, N, D] f32, zero at nodes with no incoming
    edge. The softmax's shift by the per-node max (at least NEG_INF) does
    not change the result, so no gradient flows through it."""
    B, H, N, D = q.shape
    e = edge_relation_scores(q, k, a_bank, b_bank, src, dst, rel, mask,
                             scale=scale)
    ids = dst.long()[:, None, :].expand(B, H, dst.shape[1])
    seg_max = torch.full((B, H, N), NEG_INF, dtype=e.dtype,
                         device=e.device).scatter_reduce(
        2, ids, e.detach(), "amax")
    p = torch.where(mask[:, None, :],
                    torch.exp(e - torch.gather(seg_max, 2, ids)), 0.0)
    denom = torch.zeros(B, H, N, dtype=p.dtype, device=p.device
                        ).scatter_add(2, ids, p)
    vs = _gather_nodes(v, src).float()
    num = torch.zeros(B, H, N, D, dtype=p.dtype, device=p.device
                      ).scatter_add(2, ids[..., None].expand(B, H, -1, D),
                                    p[..., None] * vs)
    has_in = denom > 0
    safe = torch.where(has_in, denom, 1.0)[..., None]
    return torch.where(has_in[..., None], num / safe, 0.0)


def flatten_edge_cells(edge_src, edge_dst, edge_rel, edge_mask,
                       num_nodes: int):
    """[B, S, S, Ec] cell tensors (block-local ids) -> flat [B, E] tensors
    with global ids; masked edges parked on node 0."""
    B, S, S2, _ = edge_src.shape
    assert S == S2
    nl = num_nodes // S
    off = torch.arange(S, device=edge_src.device) * nl
    src = (edge_src + off[None, None, :, None]).reshape(B, -1)
    dst = (edge_dst + off[None, :, None, None]).reshape(B, -1)
    rel = edge_rel.reshape(B, -1)
    mask = edge_mask.reshape(B, -1)
    return (torch.where(mask, src, 0), torch.where(mask, dst, 0), rel, mask)
