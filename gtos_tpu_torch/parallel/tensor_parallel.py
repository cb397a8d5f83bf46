"""Tensor parallelism over the mesh's 'model' axis: Megatron's column and
row splits on the port's modules.

Port of gtos_tpu/parallel/tensor_parallel.py, whose rules are kept:

  q/k/v projections   [D, D]     column: each rank holds its heads' output
                                 columns and their bias;
  attention out_proj  [D, D]     row: each rank holds its heads' input
                                 columns, one all-reduce on the output, the
                                 bias added after it;
  ffn fc1             [D, d_ff]  column;
  ffn fc2             [d_ff, D]  row.

"out_proj" is row-split only inside an attention module (the relation
encoder's and the generator's stay whole); everything else stays whole
(embeddings, LayerNorms, the relation GRU, the char CNN, `rel_proj`). A
size that does not divide the model axis stays whole: an attention module
is split only when its heads divide it, the FFN when d_ff does. Where the
JAX package gets the collectives from GSPMD, here they are explicit
(parallel/comm.py): a column layer's input has its gradient summed over
the group, a row layer's output is all-reduced; the relation attention
takes its heads' columns from both halves of the whole `rel_proj` output
(gradient summed over the group), and the copy mechanism's alignment
probabilities are gathered over the heads. The FFN's dropout draws the
whole width's mask and keeps its columns. Adam's moments are made from
the sharded parameters, so they follow them. The parameters' gradients
are then equal on every rank of the group for the whole ones and the
shards' own for the split ones.
"""

from __future__ import annotations

from typing import Dict

import torch


def _attention_modules(model):
    from gtos_tpu_torch.models.components import MultiheadAttention
    from gtos_tpu_torch.models.graph_transformer import (
        RelationMultiheadAttention)
    return [m for m in model.modules()
            if isinstance(m, (MultiheadAttention,
                              RelationMultiheadAttention))]


def shard_model(model, mesh, axis: str = "model"):
    """Split `model`'s parameters in place by the rules above for this
    rank's coordinate on `axis`: each split parameter keeps its shard,
    marked `tp_dim`; each split layer gets `tp` = ("column" | "row",
    group). Call before the optimizer is built. Returns model."""
    from gtos_tpu_torch.models.components import FeedForward
    from gtos_tpu_torch.models.graph_transformer import (
        RelationMultiheadAttention)

    n = mesh.size(axis)
    if n <= 1:
        return model
    r, group = mesh.index(axis), mesh.group(axis)

    def split(dense, kind):
        dense.tp = (kind, group)
        for leaf in ("weight", "bias"):
            p = getattr(dense, leaf)
            dim = 0 if kind == "column" else (1 if leaf == "weight" else None)
            if dim is None:
                continue
            size = p.shape[dim] // n
            p.data = p.data.narrow(dim, r * size, size).clone()
            p.tp_dim, p.tp_group = dim, group

    for attn in _attention_modules(model):
        if attn.heads % n:
            continue   # heads that do not divide the axis: whole
        for name in ("q_proj", "k_proj", "v_proj"):
            split(getattr(attn, name), "column")
        split(attn.out_proj, "row")
        H = attn.heads
        attn.heads = H // n
        attn.tp_group = group
        if isinstance(attn, RelationMultiheadAttention):
            Dh = attn.d_model // H
            cols = torch.arange(r * (H // n) * Dh, (r + 1) * (H // n) * Dh)
            attn.tp_cols = torch.cat([cols, cols + attn.d_model]).to(
                attn.rel_proj.weight.device)
    for ffn in (m for m in model.modules() if isinstance(m, FeedForward)):
        if ffn.fc1.weight.shape[0] % n:
            continue
        split(ffn.fc1, "column")
        split(ffn.fc2, "row")
        ffn.drop.shard = (r, n)
    model.tp_group = group
    return model


def is_split(p) -> bool:
    return getattr(p, "tp_dim", None) is not None


def global_norm(grads, params, group):
    """optax.global_norm of the whole model's gradients: the whole
    parameters' once, the shards' summed over the group."""
    whole = [g for g, p in zip(grads, params) if not is_split(p)]
    split = [g for g, p in zip(grads, params) if is_split(p)]
    zero = grads[0].new_zeros((), dtype=torch.float32)
    sq = sum(((g.float() ** 2).sum() for g in split), zero)
    torch.distributed.all_reduce(sq, group=group)
    return torch.sqrt(sum(((g.float() ** 2).sum() for g in whole), zero)
                      + sq)


def gather_full(t, p):
    """The whole tensor of a split parameter's shard `t` (a parameter or a
    moment of it); `t` itself for a whole parameter."""
    if not is_split(p):
        return t
    n = torch.distributed.get_world_size(p.tp_group)
    parts = [torch.empty_like(t) for _ in range(n)]
    torch.distributed.all_gather(parts, t.contiguous(), group=p.tp_group)
    return torch.cat(parts, p.tp_dim)


def take_shard(full, p):
    """This rank's shard of a whole tensor for split parameter p."""
    if not is_split(p):
        return full
    n = torch.distributed.get_world_size(p.tp_group)
    r = torch.distributed.get_rank(p.tp_group)
    size = full.shape[p.tp_dim] // n
    return full.narrow(p.tp_dim, r * size, size)


def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's state_dict with every split parameter gathered whole
    (every rank of the group must call it)."""
    params = dict(model.named_parameters())
    return {k: (gather_full(v, params[k]) if k in params else v)
            for k, v in model.state_dict().items()}
