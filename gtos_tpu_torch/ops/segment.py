"""Sparse edge-list ops: SDDMM, segment softmax, SpMM (plain torch).

Port of gtos_tpu/ops/segment.py, which leaves them to XLA: the O(E)
attention pipeline over a padded COO edge list sorted by destination.

Conventions: src, dst [E] int64/int32 node ids; edge_mask [E] bool (True =
real edge); x [N, D] node features (one graph, or a flattened batch with
node ids offset per graph).
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def sparse_sddmm(q, k, src, dst, edge_mask=None):
    """Per-edge scores e[e] = q[dst[e]] . k[src[e]] in f32; [E]."""
    scores = (q[dst.long()].float() * k[src.long()].float()).sum(-1)
    if edge_mask is not None:
        scores = torch.where(edge_mask, scores, NEG_INF)
    return scores


def segment_softmax(scores, segment_ids, num_segments):
    """Softmax of scores [E] f32 over the edges of each segment (= dst
    node); returns [E]. The shift by the segment max does not change the
    result, so no gradient flows through it."""
    ids = segment_ids.long()
    seg_max = torch.full((num_segments,), -torch.inf, dtype=scores.dtype,
                         device=scores.device).scatter_reduce(
        0, ids, scores.detach(), "amax")
    expd = torch.exp(scores - seg_max[ids])
    seg_sum = torch.zeros(num_segments, dtype=scores.dtype,
                          device=scores.device).index_add(0, ids, expd)
    return expd / (seg_sum[ids] + 1e-20)


def sparse_spmm(weights, values, src, dst, num_nodes):
    """out[i] = sum_{e: dst[e] = i} weights[e] * values[src[e]], f32
    [num_nodes, D]."""
    contrib = weights[:, None].float() * values[src.long()].float()
    return torch.zeros(num_nodes, values.shape[-1], dtype=torch.float32,
                       device=values.device).index_add(0, dst.long(),
                                                       contrib)


def sparse_graph_attention(q, k, v, src, dst, edge_mask, num_nodes):
    """SDDMM -> segment softmax -> SpMM over one edge list: q, k, v [N, D]
    -> [N, D] f32."""
    scale = q.shape[-1] ** -0.5
    e = sparse_sddmm(q, k, src, dst, edge_mask) * scale
    w = segment_softmax(e, dst, num_nodes)
    if edge_mask is not None:
        w = torch.where(edge_mask, w, 0.0)
    return sparse_spmm(w, v, src, dst, num_nodes)
