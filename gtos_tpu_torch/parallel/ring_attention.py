"""Ring context-parallel sparse relation attention over edge cells.

Port of gtos_tpu/parallel/ring_attention.py (plain torch, as the JAX
package leaves it to XLA). The nodes are cut into S blocks over the
mesh's 'graph' axis, and the edges by destination block: rank s holds
the cells (s, j) of batchify's [B, S, S, Ec] layout (block-local ids), so
the softmax over a node's incoming edges is local. Only the (k, v) source
blocks travel: at step t rank s holds block j = (s - t) mod S, processes
cell (s, j), and passes the block on to rank s+1; the exchange for step
t+1 is posted before step t's compute, so it overlaps it. The softmax is
streamed (running max, denominator and numerator, rescaled per step):
exact, with no [E, D] value buffer.

`ring_step` is one step's compute with no exchange in it and
`ring_local` the schedule's one loop; the distributed entry and
`emulate_ring` (S ranks in one process, the exchange a rotation of a
list) both run that loop, each with its exchange (parallel/comm.py). The
entry takes the whole q, k, v (the same on every graph rank), computes on
its own node block and returns the whole output gathered over the group
(parallel/comm.py gives the gradients: whole dq, dk, dv, bank gradients
summed over the group).
"""

from __future__ import annotations

import torch

from gtos_tpu_torch.ops.sparse_relation import NEG_INF, _gather_nodes


def ring_step(q, k, v, a_bank, b_bank, cell, state=None, scale=None):
    """One ring step on f32 q, k, v and banks: the edges of one cell
    (src, dst, rel, mask [B, Ec], dst ids into q's block, src ids into
    the held k/v block) folded into the streamed softmax state (m, l [B,
    H, Nl], o [B, H, Nl, D] f32; None before the first step). The
    running max carries no gradient: the result does not depend on it."""
    B, H, Nl, D = q.shape
    src, dst, rel, mask = cell
    if scale is None:
        scale = D ** -0.5
    f32 = torch.float32
    if state is None:
        state = (q.new_full((B, H, Nl), NEG_INF, dtype=f32),
                 q.new_zeros((B, H, Nl), dtype=f32),
                 q.new_zeros((B, H, Nl, D), dtype=f32))
    m, l, o = state
    qd = _gather_nodes(q, dst)                              # [B, H, Ec, D]
    ks = _gather_nodes(k, src)
    vs = _gather_nodes(v, src)
    ar = a_bank[rel.long()].permute(0, 2, 1, 3)
    br = b_bank[rel.long()].permute(0, 2, 1, 3)
    e = ((qd + ar) * (ks + br)).sum(-1) * scale             # [B, H, Ec]
    e = torch.where(mask[:, None, :], e, NEG_INF)
    ids = dst.long()[:, None, :].expand(B, H, -1)
    new_m = m.scatter_reduce(2, ids, e.detach(), "amax")
    alpha = torch.exp(m - new_m)
    p = torch.where(mask[:, None, :],
                    torch.exp(e - torch.gather(new_m, 2, ids)), 0.0)
    l = l * alpha + torch.zeros_like(l).scatter_add(2, ids, p)
    o = o * alpha[..., None] + torch.zeros_like(o).scatter_add(
        2, ids[..., None].expand(-1, -1, -1, D), p[..., None] * vs)
    return new_m, l, o


def finish(state):
    """out [B, H, Nl, D] f32 = o / l, 0 for a node with no incoming edge
    (the division guarded, so its gradient is 0 there too)."""
    _, l, o = state
    has_in = l > 0
    return torch.where(has_in[..., None],
                       o / torch.where(has_in, l, 1.0)[..., None], 0.0)


def dst_row(x, g: int, S: int):
    """Rank g's dst-block row [B, S, ...] of a per-cell tensor (edge cells,
    per-cell tiles), given whole [B, S, S, ...] or already sharded
    [B, 1, S, ...]."""
    return x[:, g] if x.shape[1] == S else x[:, 0]


def _f32(qs, kvs, a_bank, b_bank):
    f32 = torch.float32
    return ([q.to(f32) for q in qs],
            [tuple(x.to(f32) for x in kv) for kv in kvs],
            a_bank.to(f32), b_bank.to(f32))


def ring_local(xchg, qs, kvs, a_bank, b_bank, cells, scale=None):
    """The ring over the ranks xchg runs (parallel/comm.py: one under a
    process group, all S emulated): qs [B, H, Nl, D] and kvs (k, v) their
    blocks, cells[i] rank i's dst-block row (src, dst, rel, mask
    [B, S, Ec]). At step t rank g holds block (g - t) mod S, the next
    exchange posted before the step's compute. Differentiable: the
    gradients of k and v travel back along the ring to their home rank,
    the bank gradients stay each rank's part. Returns each rank's out
    [B, H, Nl, D] f32."""
    # f32 from here, the exchanges too: every gradient is summed in f32
    # and a bf16 input's is rounded once, at this cast
    qs, kvs, a_bank, b_bank = _f32(qs, kvs, a_bank, b_bank)
    S = xchg.size
    states = [None] * len(qs)
    for t in range(S):
        if t < S - 1:
            posted = xchg.post(kvs)
        for i, g in enumerate(xchg.ranks):
            cell = tuple(c[:, (g - t) % S] for c in cells[i])
            states[i] = ring_step(qs[i], *kvs[i], a_bank, b_bank, cell,
                                  states[i], scale)
        if t < S - 1:
            kvs = xchg.wait(posted)
    return [finish(st) for st in states]


def ring_sparse_relation_attention(mesh, q, k, v, a_bank, b_bank, edge_src,
                                   edge_dst, edge_rel, edge_mask,
                                   axis_name: str = "graph", scale=None):
    """Context-parallel sparse relation attention over `axis_name`.

    q, k, v: [B, H, N, D], whole (the same on every rank of the axis);
    a_bank/b_bank [P, H, D]; edge cells [B, S, S, Ec] (block-local ids),
    whole or this rank's dst-block row [B, 1, S, Ec] (parallel/mesh.py).
    Returns out [B, H, N, D] f32, whole."""
    from gtos_tpu_torch.parallel.comm import (
        GroupExchange, gather_blocks, sum_grads, take_block)

    S, g, group = (mesh.size(axis_name), mesh.index(axis_name),
                   mesh.group(axis_name))
    N = q.shape[2]
    if N % S:
        raise ValueError(f"node dim {N} not divisible by '{axis_name}'={S}")
    if edge_src.shape[2] != S:
        raise ValueError(f"edge cell layout {tuple(edge_src.shape)} was "
                         f"built for cp_shards={edge_src.shape[2]}, mesh "
                         f"has {S}")
    cells = tuple(dst_row(x, g, S) for x in (edge_src, edge_dst, edge_rel,
                                              edge_mask))
    q, k, v = (take_block(x, group, 2) for x in (q, k, v))
    a_bank, b_bank = (sum_grads(x.float(), group) for x in (a_bank, b_bank))
    (out,) = ring_local(GroupExchange(group), [q], [(k, v)], a_bank, b_bank,
                        [cells], scale)
    return gather_blocks(out, group, 2)


def emulate_ring(q, k, v, a_bank, b_bank, edge_src, edge_dst, edge_rel,
                 edge_mask, S: int, scale=None):
    """The ring of S ranks in one process: ring_local with the exchange a
    rotation of a list (parallel/comm.py Emulated). q, k, v whole
    [B, H, N, D]; edge cells whole [B, S, S, Ec]. Differentiable by
    autograd. Returns out [B, H, N, D] f32."""
    from gtos_tpu_torch.parallel.comm import Emulated

    Nl = q.shape[2] // S
    blk = lambda x, s: x[:, :, s * Nl:(s + 1) * Nl]  # noqa: E731
    cells = [tuple(c[:, s] for c in (edge_src, edge_dst, edge_rel,
                                     edge_mask)) for s in range(S)]
    return torch.cat(ring_local(
        Emulated(S), [blk(q, s) for s in range(S)],
        [(blk(k, s), blk(v, s)) for s in range(S)], a_bank, b_bank, cells,
        scale), 2)
