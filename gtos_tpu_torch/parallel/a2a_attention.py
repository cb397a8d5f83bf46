"""All-to-all context-parallel sparse relation attention.

Port of gtos_tpu/parallel/a2a_attention.py, the schedule beside the ring
(parallel/ring_attention.py). The edges are cut by SOURCE block: rank s
holds the cells (d, s) of batchify's [B, S, S, Ec] layout, the outgoing
edges of its node block. The query blocks travel once (one all_gather),
each rank computes the partial softmax statistics (max, denominator,
numerator) of every destination block over its own sources, and one
all_to_all of the packed [S, B, H, Nl, D+2] statistics returns each
destination block's S partials to its owner, which merges them: two
collectives whatever S. The query all_gather makes a rank's query memory
O(N D): only k, v and the edges shrink with S; the ring is the schedule
whose node memory shrinks with S.

`a2a_partial` (one destination block's partials) and `a2a_merge` are the
compute with no exchange in it and `a2a_local` the schedule's one body;
the distributed entry and `emulate_a2a` (S ranks in one process) both
run it, each with its exchange (parallel/comm.py).
"""

from __future__ import annotations

import torch

from gtos_tpu_torch.ops.sparse_relation import NEG_INF, _gather_nodes
from gtos_tpu_torch.parallel.ring_attention import _f32


def a2a_partial(q, k, v, a_bank, b_bank, cell, scale=None):
    """Partial statistics of one destination block over this rank's
    sources, all inputs f32: q [B, H, Nl, D] the block's queries, k, v
    this rank's block, cell (src, dst, rel, mask [B, Ec]) block-local.
    Returns (m, l [B, H, Nl], o [B, H, Nl, D]) f32, o and l shifted by m
    (m = NEG_INF, l = 0 for a node with no edge here); m carries no
    gradient."""
    B, H, Nl, D = q.shape
    src, dst, rel, mask = cell
    if scale is None:
        scale = D ** -0.5
    f32 = torch.float32
    qd = _gather_nodes(q, dst)                              # [B, H, Ec, D]
    ks = _gather_nodes(k, src)
    vs = _gather_nodes(v, src)
    ar = a_bank[rel.long()].permute(0, 2, 1, 3)
    br = b_bank[rel.long()].permute(0, 2, 1, 3)
    e = ((qd + ar) * (ks + br)).sum(-1) * scale
    e = torch.where(mask[:, None, :], e, NEG_INF)
    ids = dst.long()[:, None, :].expand(B, H, -1)
    m = q.new_full((B, H, Nl), NEG_INF, dtype=f32).scatter_reduce(
        2, ids, e.detach(), "amax")
    p = torch.where(mask[:, None, :],
                    torch.exp(e - torch.gather(m, 2, ids)), 0.0)
    l = q.new_zeros((B, H, Nl), dtype=f32).scatter_add(2, ids, p)
    o = q.new_zeros((B, H, Nl, D), dtype=f32).scatter_add(
        2, ids[..., None].expand(-1, -1, -1, D), p[..., None] * vs)
    return m, l, o


def pack(m, l, o):
    """[S] lists of partials -> one [S, B, H, Nl, D+2] tensor."""
    return torch.cat([torch.stack(o), torch.stack(m)[..., None],
                      torch.stack(l)[..., None]], -1)


def a2a_merge(packed):
    """The S partials of one destination block ([S, B, H, Nl, D+2], as the
    all_to_all delivers them) -> out [B, H, Nl, D] f32, 0 for a node with
    no incoming edge."""
    D = packed.shape[-1] - 2
    o_r, m_r, l_r = packed[..., :D], packed[..., D], packed[..., D + 1]
    M = m_r.detach().amax(0)
    w = torch.exp(m_r.detach() - M[None])
    l = (l_r * w).sum(0)
    o = (o_r * w[..., None]).sum(0)
    has_in = l > 0
    return torch.where(has_in[..., None],
                       o / torch.where(has_in, l, 1.0)[..., None], 0.0)


def a2a_local(xchg, qs, kvs, a_bank, b_bank, cells, scale=None):
    """The schedule over the ranks xchg runs (parallel/comm.py): qs and
    kvs (k, v) their blocks [B, H, Nl, D], cells[i] rank i's src-block
    column (src, dst, rel, mask [B, S, Ec]). Returns each rank's out
    [B, H, Nl, D] f32."""
    # f32 from here, the exchanges too: every gradient is summed in f32
    # and a bf16 input's is rounded once, at this cast
    qs, kvs, a_bank, b_bank = _f32(qs, kvs, a_bank, b_bank)
    S = xchg.size
    q_all = xchg.gather_stack(qs)                       # [S, B, H, Nl, D]
    sent = [pack(*zip(*[a2a_partial(
        q_all[d], *kvs[i], a_bank, b_bank, tuple(c[:, d] for c in cells[i]),
        scale) for d in range(S)])) for i in range(len(qs))]
    return [a2a_merge(p) for p in xchg.all_to_all(sent)]


def _cells(x, g: int, S: int):
    """This rank's src-block column [B, S, Ec] of an edge-cell tensor,
    given whole [B, S, S, Ec] or already sharded [B, S, 1, Ec]."""
    return x[:, :, g] if x.shape[2] == S else x[:, :, 0]


def a2a_sparse_relation_attention(mesh, q, k, v, a_bank, b_bank, edge_src,
                                  edge_dst, edge_rel, edge_mask,
                                  axis_name: str = "graph", scale=None):
    """Context-parallel sparse relation attention, all-to-all schedule.
    The ring's contract (parallel/ring_attention.py), with the edge cells
    whole or this rank's src-block column [B, S, 1, Ec]. Returns out
    [B, H, N, D] f32, whole."""
    from gtos_tpu_torch.parallel.comm import (
        GroupExchange, gather_blocks, sum_grads, take_block)

    S, g, group = (mesh.size(axis_name), mesh.index(axis_name),
                   mesh.group(axis_name))
    N = q.shape[2]
    if N % S:
        raise ValueError(f"node dim {N} not divisible by '{axis_name}'={S}")
    if edge_src.shape[1] != S:
        raise ValueError(f"edge cell layout {tuple(edge_src.shape)} was "
                         f"built for cp_shards={edge_src.shape[1]}, mesh "
                         f"has {S}")
    cells = tuple(_cells(x, g, S) for x in (edge_src, edge_dst, edge_rel,
                                            edge_mask))
    q, k, v = (take_block(x, group, 2) for x in (q, k, v))
    a_bank, b_bank = (sum_grads(x.float(), group) for x in (a_bank, b_bank))
    (out,) = a2a_local(GroupExchange(group), [q], [(k, v)], a_bank, b_bank,
                       [cells], scale)
    return gather_blocks(out, group, 2)


def emulate_a2a(q, k, v, a_bank, b_bank, edge_src, edge_dst, edge_rel,
                edge_mask, S: int, scale=None):
    """The a2a schedule of S ranks in one process: a2a_local with the
    collectives on lists (parallel/comm.py Emulated). Edge cells whole;
    differentiable. Returns out [B, H, N, D] f32."""
    from gtos_tpu_torch.parallel.comm import Emulated

    Nl = q.shape[2] // S
    blk = lambda x, s: x[:, :, s * Nl:(s + 1) * Nl]  # noqa: E731
    cells = [tuple(c[:, :, s] for c in (edge_src, edge_dst, edge_rel,
                                        edge_mask)) for s in range(S)]
    return torch.cat(a2a_local(
        Emulated(S), [blk(q, s) for s in range(S)],
        [(blk(k, s), blk(v, s)) for s in range(S)], a_bank, b_bank, cells,
        scale), 2)
