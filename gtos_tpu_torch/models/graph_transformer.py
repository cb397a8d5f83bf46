"""The graph-transformer encoder stack.

Port of gtos_tpu/models/graph_transformer.py: post-LN layers of
relation-aware multi-head attention + FFN over all node pairs, or over the
kept pairs of the sparse tier. Five attention impls are ported, all with
one set of parameters:

  "xla"          the plain bank decomposition over the batch-global bank
                 (ops/attention.py);
  "pallas"       the fused attention over the batch-global bank
                 (ops/relation_attention.py): kernel B3 or B3' forward, and
                 with gradients the trainable entry, whose backward is B4
                 (CUDA kernels on the card, plain versions on the CPU). B4's
                 walk orders over each graph's rows and columns of
                 rel_index are built once per stack;
  "pallas_local" per-graph localized banks (batchify
                 build_local_banks=True): the GRU's relation vectors are
                 gathered once per stack (ops/localize.py) and every layer
                 runs the localized relation attention
                 (ops/local_relation_attention.py): kernel B1 without
                 gradients, and with them the trainable entry, whose
                 forward is B1p and backward B2. The kernels take the
                 halves of the bank projection as views and B2 writes its
                 gradient as one tensor, so neither is copied. B2's slot
                 order over each graph's pairs and its work list over the
                 runs are built once per stack, as the JAX package builds its
                 sort auxiliaries once per step;
  "sparse"       the edge-list attention over batchify's COO edge cells
                 (build_edges=True), plain torch as the JAX package leaves
                 it to XLA (ops/sparse_relation.py);
  "block_sparse" the block-sparse attention over batchify's 128x128 tile
                 layouts (build_block_tiles=True;
                 ops/block_sparse_attention.py): kernel B5 without
                 gradients, and with them the trainable entry, whose
                 forward is B5s and backward B6d, B6s and B6b. The
                 backward's pair orders are built once per stack, on the
                 card with no host read, padded to the batch's pair
                 capacity (ops/block_sparse_attention_bwd.py pair_cap),
                 so the step can be captured; the plan's check that both layouts
                 hold the same pairs is a device flag, kept in
                 `plan_checks` for the train step's metrics.

"auto" is resolved per batch (models/generator.py resolve_attention_impl)
into "block_sparse", "pallas" or "pallas_local" and handed to `forward` as
`impl`; the module is built once and runs any route.

With a context-parallel mesh (`cp_mesh`, parallel/mesh.py) whose 'graph'
axis has S > 1 ranks, "block_sparse" runs the ring with B5s/B6 per step
(parallel/ring_block_sparse.py, on batchify's per-cell layouts ctile_*;
the B6 plans of the rank's S cells built once per stack) and "sparse"
the edge-cell ring or, with cp_schedule "a2a", the all-to-all schedule
(parallel/ring_attention.py, a2a_attention.py). Dropout where the JAX
package has it: on the attention and FFN outputs before each residual
add, and after the FFN's ReLU.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from gtos_tpu_torch.models.components import (
    Dense, FeedForward, PostLNResidual, merge_heads, split_heads,
)
from gtos_tpu_torch.ops.attention import bank_relation_attention
from gtos_tpu_torch.ops.block_sparse_attention import (
    block_sparse_attention, block_sparse_relation_attention_trainable,
)
from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
    backward_plan, pair_cap,
)
from gtos_tpu_torch.ops.local_relation_attention import (
    local_relation_attention, local_relation_attention_trainable,
    bank_runs, slot_order, split_banks,
)
from gtos_tpu_torch.ops.localize import localize_bank
from gtos_tpu_torch.ops.relation_attention import (
    pallas_relation_attention, relation_attention_trainable, walk_orders,
)
from gtos_tpu_torch.ops.sparse_relation import (
    flatten_edge_cells, sparse_relation_attention,
)

# what a layer runs
ROUTES = ("xla", "pallas", "pallas_local", "sparse", "block_sparse")


def check_impl(impl: str):
    if impl in ROUTES or impl == "auto":
        return
    if impl.endswith("_interpret"):
        raise ValueError(
            f"attention_impl {impl!r}: the port has no interpret mode; "
            f"use {impl[:-len('_interpret')]!r} (CPU tensors run the plain "
            "version)")
    raise NotImplementedError(f"attention_impl {impl!r} is not ported yet")


def _route(impl: str) -> str:
    """The impl a call runs: a resolved one ("auto" must be resolved per
    batch before it reaches the stack)."""
    if impl not in ROUTES:
        raise ValueError(
            f"attention_impl {impl!r} reached the encoder unresolved: "
            "resolve_attention_impl must run per batch")
    return impl


class RelationMultiheadAttention(nn.Module):
    """Relation-aware MHA: e_ij = scale * (q_i + a_ij).(k_j + b_ij).

    The relation vectors are projected per layer into per-head a/b banks
    (`rel_proj`, one Linear chunked in two). Under tensor parallelism
    `heads` is this rank's and `tp_cols` the columns of its heads in both
    halves of the whole `rel_proj` output (parallel/tensor_parallel.py).
    `cp_mesh`/`cp_schedule`: the context-parallel mesh (module
    docstring)."""

    tp_group = tp_cols = cp_mesh = None
    cp_schedule = "ring"

    def __init__(self, d_model: int, heads: int, impl: str = "xla"):
        super().__init__()
        check_impl(impl)
        self.d_model, self.heads, self.impl = d_model, heads, impl
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.rel_proj = Dense(d_model, 2 * d_model)
        self.out_proj = Dense(d_model, d_model)

    def forward(self, x, rel_vecs, rel_index, node_mask,
                edges: Optional[Dict[str, torch.Tensor]] = None,
                impl: Optional[str] = None):
        """x: [B,N,D]; node_mask: [B,N]. impl: the route of this call
        (default: the module's). rel_vecs: the batch-global [P,Dr] for
        "xla" and "pallas" (with edges["row_order"]/["col_order"] when
        gradients are taken), or pre-localized [B,P_loc,Dr] for
        "pallas_local" (with edges["rel_index_loc"], and
        edges["pair_order"]/["slot_start"]/["bank_runs"] when gradients
        are taken); the
        global [P,Dr] for "sparse" (with edges["flat_edges"]) and
        "block_sparse" (with the tile layouts, and edges["blk_plan"] when
        gradients are taken)."""
        impl = _route(impl or self.impl)
        H, D = self.heads, self.d_model
        q = split_heads(self.q_proj(x), H)
        k = split_heads(self.k_proj(x), H)
        v = split_heads(self.v_proj(x), H)
        ab = self.rel_proj(rel_vecs)
        if self.tp_cols is not None:
            from gtos_tpu_torch.parallel.comm import sum_grads
            ab = torch.index_select(sum_grads(ab, self.tp_group), -1,
                                    self.tp_cols)
        a, b = split_banks(ab, H)
        edges = edges or {}
        grad = torch.is_grad_enabled() and q.requires_grad
        mesh = self.cp_mesh
        if impl in ("sparse", "block_sparse") and mesh is not None \
                and mesh.size("graph") > 1:
            out = self._context_parallel(impl, q, k, v, a, b, edges)
        elif impl == "pallas_local":
            qkv = (q.contiguous(), k.contiguous(), v.contiguous())
            if grad:
                out = local_relation_attention_trainable(
                    *qkv, ab, edges["rel_index_loc"], node_mask,
                    edges.get("pair_order"), edges.get("slot_start"),
                    edges.get("bank_runs"))
            else:
                out = local_relation_attention(
                    *qkv, a, b, edges["rel_index_loc"], node_mask)
        elif impl == "pallas":
            # the bank halves as views: B3' reads their strided rows, and
            # build_tables and B4's contractions take them as they are
            args = (q.contiguous(), k.contiguous(), v.contiguous(), a, b,
                    rel_index, node_mask)
            if grad:
                out = relation_attention_trainable(
                    *args, edges.get("row_order"), edges.get("col_order"))
            else:
                out, _ = pallas_relation_attention(*args)
        elif impl == "block_sparse":
            args = (q.contiguous(), k.contiguous(), v.contiguous(),
                    a.contiguous(), b.contiguous(), edges["tile_src"],
                    edges["tile_rel"])
            if grad:
                out = block_sparse_relation_attention_trainable(
                    *args, *(edges.get("flat_edges") or (None,) * 4),
                    tile_dst=edges.get("tile_dst"),
                    tile_rel_src=edges.get("tile_rel_src"),
                    plan=edges.get("blk_plan"))
            else:
                out = block_sparse_attention(*args)
        elif impl == "sparse":
            out = sparse_relation_attention(q, k, v, a, b,
                                            *edges["flat_edges"])
        else:
            out, _ = bank_relation_attention(q, k, v, a, b, rel_index,
                                             node_mask)
        return self.out_proj(merge_heads(out.to(x.dtype)))

    def _context_parallel(self, impl, q, k, v, a, b, edges):
        """The CP attention over the mesh's 'graph' axis: whole q, k, v in,
        whole output out (module docstring)."""
        from gtos_tpu_torch.parallel import (
            a2a_attention, ring_attention, ring_block_sparse)
        mesh = self.cp_mesh
        cells = tuple(edges.get(name) for name in (
            "edge_src", "edge_dst", "edge_rel", "edge_mask"))
        if impl == "block_sparse":
            if "ctile_src" not in edges:
                raise ValueError(
                    "block_sparse under a graph mesh needs the per-cell tile "
                    "layout (batchify build_block_tiles with cp_shards > 1)")
            return ring_block_sparse.ring_block_sparse_relation_attention(
                mesh, q, k, v, a, b, edges["ctile_src"], edges["ctile_rel"],
                *cells, ctile_dst=edges.get("ctile_dst"),
                ctile_rel_src=edges.get("ctile_rel_src"),
                cells=edges.get("ring_cells"), plans=edges.get("ring_plans"))
        fn = (a2a_attention.a2a_sparse_relation_attention
              if self.cp_schedule == "a2a"
              else ring_attention.ring_sparse_relation_attention)
        return fn(mesh, q, k, v, a, b, *cells)


class GraphTransformerLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int, heads: int,
                 impl: str = "xla", dropout: float = 0.0):
        super().__init__()
        self.self_attn = RelationMultiheadAttention(d_model, heads, impl)
        self.attn_res = PostLNResidual(d_model, dropout)
        self.ffn = FeedForward(d_model, d_ff, dropout)
        self.ffn_res = PostLNResidual(d_model, dropout)

    def forward(self, x, rel_vecs, rel_index, node_mask, edges=None,
                impl=None):
        x = self.attn_res(x, self.self_attn(x, rel_vecs, rel_index,
                                            node_mask, edges, impl))
        return self.ffn_res(x, self.ffn(x))


class GraphTransformer(nn.Module):
    def __init__(self, layers: int, d_model: int, d_ff: int, heads: int,
                 impl: str = "xla", dropout: float = 0.0, cp_mesh=None,
                 cp_schedule: str = "ring"):
        super().__init__()
        check_impl(impl)
        if cp_schedule not in ("ring", "a2a"):
            raise ValueError(f"cp_schedule {cp_schedule!r}: 'ring' or 'a2a'")
        self.impl, self.cp_mesh = impl, cp_mesh
        for i in range(layers):
            self.add_module(f"layer{i}", GraphTransformerLayer(
                d_model, d_ff, heads, impl, dropout))
            attn = getattr(self, f"layer{i}").self_attn
            attn.cp_mesh, attn.cp_schedule = cp_mesh, cp_schedule
        self.layers = layers
        # the device flags of the last forward's backward plans (true: the
        # layouts agree), which Generator.forward hands on as "layout_ok"
        self.plan_checks = []

    def _cp_size(self) -> int:
        return 1 if self.cp_mesh is None else self.cp_mesh.size("graph")

    def forward(self, x, rel_vecs, rel_index, node_mask, edges=None,
                impl: Optional[str] = None):
        """impl: the route of this batch (default: the module's; "auto"
        must be resolved by the caller)."""
        impl = _route(impl or self.impl)
        self.plan_checks = []
        if impl == "pallas_local":
            if edges is None or "bank_map" not in edges:
                raise ValueError("attention_impl='pallas_local' needs "
                                 "batchify build_local_banks=True")
            # localize the relation vectors ONCE for the whole stack
            rel_vecs = localize_bank(rel_vecs, edges["bank_map"],
                                     edges.get("loc_perm"),
                                     edges.get("loc_bnd"))
            if torch.is_grad_enabled():
                order, start = slot_order(edges["rel_index_loc"],
                                          edges["bank_map"].shape[1])
                edges = dict(edges, pair_order=order, slot_start=start,
                             bank_runs=bank_runs(start, x.shape[1]))
        elif impl == "pallas" and torch.is_grad_enabled():
            rows, cols = walk_orders(rel_index)
            edges = dict(edges or {}, row_order=rows, col_order=cols)
        elif impl in ("sparse", "block_sparse"):
            edges = dict(edges or {})
            S = self._cp_size()
            need = ("edge_src" if impl == "sparse"
                    else "ctile_src" if S > 1 else "tile_src")
            if need not in edges:
                raise ValueError(
                    f"attention_impl={impl!r} needs batchify "
                    + ("build_edges=True" if impl == "sparse"
                       else "build_block_tiles=True")
                    + (f" with cp_shards={S}" if S > 1 else ""))
            if S > 1:
                if impl == "block_sparse":   # this rank's cells, once
                    from gtos_tpu_torch.parallel.ring_block_sparse import (
                        rank_cells, ring_plans)
                    cells = edges["ring_cells"] = rank_cells(
                        self.cp_mesh.index("graph"), S, edges["ctile_src"],
                        edges["ctile_rel"], edges.get("ctile_dst"),
                        edges.get("ctile_rel_src"))
                    if torch.is_grad_enabled() and "ctile_dst" in edges:
                        edges["ring_plans"] = ring_plans(
                            cells, x.shape[1] // S, rel_vecs.shape[0],
                            pair_cap(edges))
                        self.plan_checks = [p["ok"] for p in
                                            edges["ring_plans"]]
            elif "edge_src" in edges:   # the COO form, flattened once
                edges["flat_edges"] = flatten_edge_cells(
                    edges["edge_src"], edges["edge_dst"], edges["edge_rel"],
                    edges["edge_mask"], x.shape[1])
            if (S == 1 and impl == "block_sparse" and torch.is_grad_enabled()
                    and "tile_dst" in edges):
                edges["blk_plan"] = backward_plan(
                    edges["tile_src"], edges["tile_rel"], edges["tile_dst"],
                    edges["tile_rel_src"], x.shape[1], rel_vecs.shape[0],
                    pair_cap(edges))
                self.plan_checks = [edges["blk_plan"]["ok"]]
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x, rel_vecs, rel_index,
                                           node_mask, edges, impl)
        # zero padded nodes so downstream cross-attention sees clean memory
        return x.masked_fill(~node_mask[:, :, None], 0.0)
