"""Ring context-parallel block-sparse relation attention: the kernels B5s
and B6 as each ring step's compute.

Port of gtos_tpu/parallel/ring_block_sparse.py. The nodes are cut into S
blocks over the 'graph' axis (Nl = N/S, a multiple of 128) and batchify
packs each (dst-block, src-block) cell's kept pairs with block-local tile
ids (ops/block_sparse.py pack_block_sparse_cells*), so a ring step hands
cell (own block, held block) straight to the single-device kernels:

  forward   at step t rank s holds the (k, v) block j = (s - t) mod S
            (posted on to rank s+1 before the step's compute) and runs B5s
            on cell (s, j): out_t, m_t, l_t [B, H, Nl]; the partials are
            merged flash-attention style, exactly (`merge`), rows with no
            kept pair in a cell (m_t = -1e9, l_t = 0) weighed 0;
  backward  a reverse ring (`_RingBlockSparse.backward`): the global
            (m, l) make each cell's probabilities exact, so at each step
            B6d, B6s and B6b run on the held cell: dq and the bank
            gradients accumulate on the rank, dk/dv accumulate into
            buffers that travel with (k, v), and one final shift delivers
            them home. The B6 plans of a rank's S cells are built once per
            batch (`ring_plans`), outside the step loop.

Batches without the src-major cells (ctile_dst) take the backward of the
edge-cell ring (parallel/ring_attention.py) over the same pairs.

The step compute (`fwd_step`, `merge`, `finish`, `bwd_step`) has no
exchange in it; the distributed entry and `emulate` (S ranks in one
process, the exchange a rotation of a list) both run it. The entry takes
the whole q, k, v and returns the whole output (parallel/comm.py's
boundary: whole dq, dk, dv; bank gradients summed over the graph group,
and over the data group by the parameter all-reduce).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from gtos_tpu_torch.ops import block_sparse_attention as fwd_ops
from gtos_tpu_torch.ops import block_sparse_attention_bwd as bwd_ops
from gtos_tpu_torch.ops.block_sparse_attention import NEG_INF, bank_t4


def fwd_step(q, k, v, a_bank, b_bank, t4, cell_src, cell_rel, scale):
    """B5s on one cell: q this rank's block, k, v the held block
    [B, H, Nl, Dh]; cell_src [B, Tdl, Smax_c], cell_rel [..., 128, 128].
    Returns (out_t in v's type, m_t, l_t [B, H, Nl] f32)."""
    return fwd_ops.block_sparse_attention_with_stats(
        q, k, v, a_bank, b_bank, cell_src, cell_rel, scale, t4)


def init_state(q):
    B, H, Nl, D = q.shape
    f32 = torch.float32
    return (q.new_full((B, H, Nl), NEG_INF, dtype=f32),
            q.new_zeros((B, H, Nl), dtype=f32),
            q.new_zeros((B, H, Nl, D), dtype=f32))


def merge(state, out_t, m_t, l_t):
    """The exact flash merge of one step's normalized partial (out_t,
    m_t, l_t) into the running (m, l, o): o un-normalized, f32."""
    m, l, o = state
    new_m = torch.maximum(m, m_t)
    alpha = torch.exp(m - new_m)
    beta = torch.where(l_t > 0, torch.exp(m_t - new_m), 0.0)
    l = l * alpha + l_t * beta
    o = o * alpha[..., None] + out_t.float() * (l_t * beta)[..., None]
    return new_m, l, o


def finish(state):
    """(out [B, H, Nl, D] f32, m, l): out = o / l, 0 where l = 0."""
    m, l, o = state
    has_in = l > 0
    out = torch.where(has_in[..., None],
                      o / torch.where(has_in, l, 1.0)[..., None], 0.0)
    return out, m, l


def bwd_step(q, k, v, a_bank, b_bank, t4, gp, m, l, delta, cell, plan,
             scale):
    """B6d, B6s and B6b on one cell: q, gp, m, l, delta this rank's block
    (m, l the merged statistics), k, v the held block; cell = (src, rel,
    dst, rel_src) of pack_block_sparse_cells*; plan its backward_plan.
    Returns (dq_t, dk_t, dv_t in the input types, g_a_t, g_b_t in the
    bank type)."""
    src, rel, dst, rel_src = cell
    dq, ge, pair_s = bwd_ops.block_sparse_attention_bwd_dst(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, src, rel, plan, scale)
    dk, dv = bwd_ops.block_sparse_attention_bwd_src(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, dst, rel_src, plan,
        pair_s, scale)
    g_a, g_b = bwd_ops.block_sparse_bank_grads(q, k, a_bank, b_bank, ge,
                                               plan)
    return dq, dk, dv, g_a, g_b


def rank_cells(g: int, S: int, ctile_src, ctile_rel, ctile_dst=None,
               ctile_rel_src=None) -> List[tuple]:
    """The S cells (g, j) of rank g, each (src, rel[, dst, rel_src]) made
    contiguous for the kernels."""
    from gtos_tpu_torch.parallel.ring_attention import dst_row

    rows = [dst_row(x, g, S) for x in (ctile_src, ctile_rel, ctile_dst,
                                        ctile_rel_src) if x is not None]
    return [tuple(r[:, j].contiguous() for r in rows) for j in range(S)]


def ring_plans(cells, Nl: int, P: int, cap: int) -> List[dict]:
    """backward_plan of each of a rank's cells (built once per batch, on
    the card with no host read; cap: the batch's pair capacity,
    pair_capacity of the whole cell layout, which bounds every cell's
    pairs)."""
    return [bwd_ops.backward_plan(*c, Nl, P, cap) for c in cells]


def ring_forward(xchg, qs, kvs, a_bank, b_bank, t4, cells, scale,
                 merge_fn=merge):
    """The forward ring over the ranks xchg runs (parallel/comm.py: one
    under a process group, all S emulated): qs and kvs (k, v) their blocks
    [B, H, Nl, Dh], cells[i] rank i's S cells (rank_cells). At step t rank
    g holds block (g - t) mod S, the next exchange posted before the
    step's compute. Returns each rank's (out, m, l)."""
    S = xchg.size
    states = [init_state(q) for q in qs]
    for t in range(S):
        if t < S - 1:
            posted = xchg.post(kvs)
        for i, g in enumerate(xchg.ranks):
            src, rel = cells[i][(g - t) % S][:2]
            states[i] = merge_fn(states[i], *fwd_step(
                qs[i], *kvs[i], a_bank, b_bank, t4, src, rel, scale))
        if t < S - 1:
            kvs = xchg.wait(posted)
    return [finish(st) for st in states]


def ring_backward(xchg, qs, kvs, a_bank, b_bank, t4, gps, ms, ls, deltas,
                  cells, plans, scale):
    """The reverse ring over the ranks xchg runs: at each step B6d, B6s
    and B6b on the held cell, with each rank's merged (m, l) and its
    prep_bwd_invariants (gp, delta). dq and the bank gradients accumulate
    where they are; the dk/dv buffers travel with (k, v), and after the S
    steps they hold block g+1's, so one more shift lands each on its home
    rank. Returns (dq per rank, (dk, dv) per rank, g_a, g_b): f32, the
    bank gradients summed over the ranks run here."""
    S, f32 = xchg.size, torch.float32
    dq = [torch.zeros(q.shape, dtype=f32, device=q.device) for q in qs]
    dkv = [tuple(torch.zeros(q.shape, dtype=f32, device=q.device)
                 for _ in range(2)) for q in qs]
    g_a = torch.zeros(a_bank.shape, dtype=f32, device=a_bank.device)
    g_b = torch.zeros_like(g_a)
    for t in range(S):
        if t < S - 1:
            posted = xchg.post(kvs)
        for i, g in enumerate(xchg.ranks):
            j = (g - t) % S
            dq_t, dk_t, dv_t, ga_t, gb_t = bwd_step(
                qs[i], *kvs[i], a_bank, b_bank, t4, gps[i], ms[i], ls[i],
                deltas[i], cells[i][j], plans[i][j], scale)
            dq[i] += dq_t
            g_a += ga_t
            g_b += gb_t
            dkv[i][0].add_(dk_t)
            dkv[i][1].add_(dv_t)
        if t < S - 1:
            kvs = xchg.wait(posted)
            dkv = xchg.wait(xchg.post(dkv))
    if S > 1:
        dkv = xchg.wait(xchg.post(dkv))
    return dq, dkv, g_a, g_b


class _RingBlockSparse(torch.autograd.Function):
    """The ring on this rank's blocks, B5s forward and the B6 reverse ring
    backward (the exchanges are inside: nothing of the ring is recorded by
    autograd)."""

    @staticmethod
    def forward(ctx, q, k, v, a_bank, b_bank, group, cells, plans, scale):
        from gtos_tpu_torch.parallel.comm import GroupExchange

        xchg = GroupExchange(group)
        t4 = bank_t4(a_bank, b_bank)
        ((out, m, l),) = ring_forward(xchg, [q], [(k, v)], a_bank, b_bank,
                                      t4, [cells], scale)
        ctx.save_for_backward(q, k, v, a_bank, b_bank, t4, out, m, l)
        ctx.ring = (xchg, cells, plans, scale)
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, a_bank, b_bank, t4, out, m, l = ctx.saved_tensors
        xchg, cells, plans, scale = ctx.ring
        gp, delta = bwd_ops.prep_bwd_invariants(q, g_out, out)
        (dq,), ((dk, dv),), g_a, g_b = ring_backward(
            xchg, [q], [(k, v)], a_bank, b_bank, t4, [gp], [m], [l],
            [delta], [cells], [plans], scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                g_a.to(a_bank.dtype), g_b.to(b_bank.dtype),
                None, None, None, None)


class _RingBlockSparseEdgeBwd(torch.autograd.Function):
    """B5s ring forward; backward: autograd of the edge-cell ring over the
    same pairs (batches without the src-major cells)."""

    @staticmethod
    def forward(ctx, q, k, v, a_bank, b_bank, group, cells, edges, scale):
        from gtos_tpu_torch.parallel.comm import GroupExchange

        xchg = GroupExchange(group)
        ((out, _, _),) = ring_forward(xchg, [q], [(k, v)], a_bank, b_bank,
                                      bank_t4(a_bank, b_bank), [cells],
                                      scale)
        ctx.save_for_backward(q, k, v, a_bank, b_bank)
        ctx.ring = (xchg, edges, scale)
        return out

    @staticmethod
    def backward(ctx, g_out):
        from gtos_tpu_torch.parallel.ring_attention import ring_local

        xchg, edges, scale = ctx.ring
        leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        q, k, v, a_bank, b_bank = leaves
        with torch.enable_grad():
            (out,) = ring_local(xchg, [q], [(k, v)], a_bank, b_bank, [edges],
                                scale)
            grads = torch.autograd.grad(out, leaves, g_out.float())
        return (*(gr.to(x.dtype) for gr, x in zip(grads, leaves)),
                None, None, None, None)


def ring_block_sparse_relation_attention(
        mesh, q, k, v, a_bank, b_bank, ctile_src, ctile_rel, edge_src=None,
        edge_dst=None, edge_rel=None, edge_mask=None, ctile_dst=None,
        ctile_rel_src=None, cells: Optional[List[tuple]] = None,
        plans: Optional[List[dict]] = None, axis_name: str = "graph",
        scale=None):
    """Context-parallel block-sparse relation attention (ring schedule, the
    tile kernels per step; differentiable).

    q, k, v: [B, H, N, Dh] whole; banks [P, H, Dh]; ctile_src/ctile_rel
    the per-cell layout (pack_block_sparse_cells), whole [B, S, S, ...]
    or this rank's dst-block row [B, 1, S, ...]. With ctile_dst/
    ctile_rel_src the backward is the B6 reverse ring; otherwise the
    edge-cell ring's, over edge_* (dst-block rows). `cells` and `plans`:
    this rank's rank_cells of these layouts and their ring_plans (a
    stack builds them once for its layers), built here when not given.
    Returns out [B, H, N, Dh] f32, whole."""
    from gtos_tpu_torch.ops.relation_attention import _default_scale
    from gtos_tpu_torch.parallel.comm import (
        gather_blocks, sum_grads, take_block)
    from gtos_tpu_torch.parallel.ring_attention import dst_row

    S, g, group = (mesh.size(axis_name), mesh.index(axis_name),
                   mesh.group(axis_name))
    N = q.shape[2]
    if N % S:
        raise ValueError(f"node dim {N} not divisible by '{axis_name}'={S}")
    if ctile_src.shape[2] != S:
        raise ValueError(f"cell tile layout {tuple(ctile_src.shape)} was "
                         f"built for cp_shards={ctile_src.shape[2]}, mesh "
                         f"has {S}")
    scale = _default_scale(q, scale)
    q, k, v = (take_block(x, group, 2) for x in (q, k, v))
    a_bank, b_bank = sum_grads(a_bank, group), sum_grads(b_bank, group)
    a_bank, b_bank = a_bank.contiguous(), b_bank.contiguous()
    if cells is None:
        cells = rank_cells(g, S, ctile_src, ctile_rel, ctile_dst,
                           ctile_rel_src)
    if ctile_dst is not None:
        if plans is None and torch.is_grad_enabled():
            plans = ring_plans(cells, N // S, a_bank.shape[0],
                               bwd_ops.pair_capacity(ctile_rel))
        out = _RingBlockSparse.apply(q, k, v, a_bank, b_bank, group, cells,
                                     plans, scale)
    else:
        if edge_src is None and torch.is_grad_enabled() and q.requires_grad:
            raise ValueError(
                "need either (ctile_dst, ctile_rel_src) for the kernel ring "
                "backward or the edge cells for the edge-cell ring's")
        edges = (None if edge_src is None else tuple(
            dst_row(x, g, S) for x in (edge_src, edge_dst, edge_rel,
                                       edge_mask)))
        out = _RingBlockSparseEdgeBwd.apply(q, k, v, a_bank, b_bank, group,
                                            cells, edges, scale)
    return gather_blocks(out, group, 2)


def emulate(q, k, v, a_bank, b_bank, ctile_src, ctile_rel, S: int,
            ctile_dst=None, ctile_rel_src=None, g_out=None, scale=None,
            merge_fn=merge):
    """The ring of S ranks in one process: ring_forward (with `merge_fn`)
    and ring_backward with each exchange a rotation of a Python list
    (parallel/comm.py Emulated). q, k, v whole [B, H, N, Dh]; per-cell
    layouts whole [B, S, S, ...]. B5s launches S*S times; with g_out (the
    output's cotangent, whole) the reverse ring runs B6d, B6s, B6b S*S
    times each. Returns out [B, H, N, Dh] f32, or with g_out (out, dq, dk,
    dv, g_a, g_b): dq, dk, dv f32 and whole, g_a/g_b f32 summed over the
    ranks."""
    from gtos_tpu_torch.ops.relation_attention import _default_scale
    from gtos_tpu_torch.parallel.comm import Emulated

    scale = _default_scale(q, scale)
    Nl = q.shape[2] // S
    blk = lambda x, s: x[:, :, s * Nl:(s + 1) * Nl].contiguous()  # noqa
    xchg = Emulated(S)
    t4 = bank_t4(a_bank, b_bank)
    cells = [rank_cells(s, S, ctile_src, ctile_rel, ctile_dst,
                        ctile_rel_src) for s in range(S)]
    qs = [blk(q, s) for s in range(S)]
    kvs = [(blk(k, s), blk(v, s)) for s in range(S)]
    fin = ring_forward(xchg, qs, kvs, a_bank, b_bank, t4, cells, scale,
                       merge_fn)
    out = torch.cat([f[0] for f in fin], 2)
    if g_out is None:
        return out
    cap = bwd_ops.pair_capacity(ctile_rel)
    plans = [ring_plans(c, Nl, a_bank.shape[0], cap) for c in cells]
    gps, deltas = zip(*[bwd_ops.prep_bwd_invariants(qs[s], blk(g_out, s),
                                                    fin[s][0])
                        for s in range(S)])
    dq, dkv, g_a, g_b = ring_backward(
        xchg, qs, kvs, a_bank, b_bank, t4, gps, [f[1] for f in fin],
        [f[2] for f in fin], deltas, cells, plans, scale)
    return (out, torch.cat(dq, 2), torch.cat([x[0] for x in dkv], 2),
            torch.cat([x[1] for x in dkv], 2), g_a, g_b)
