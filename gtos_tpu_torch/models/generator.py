"""The top graph-to-sequence model: token encoder + relation GRU + graph
transformer + copy decoder.

Port of gtos_tpu/models/generator.py: `forward(batch)` is the
teacher-forced loss for training; for search, encode once, then
`decode_step` repeatedly. The copy mechanism mixes the generation softmax
with the alignment layer's cross-attention scattered onto an extended
vocabulary:

    P(w) = g * P_vocab(w) + (1 - g) * sum_i alpha_i * [cp_seq_i == w]

The JAX package lands the copy mass either by a split-precision bf16
one-hot matmul (copy_impl="onehot", equal to an f32 scatter-add to about
1e-6) or by a scatter-add ("scatter"); the port computes both values with
one f32 scatter-add (`index_put` with accumulation while gradients are
taken, whose CUDA kernel sorts the indices and so adds colliding copy
targets in a fixed order; `scatter_add` otherwise).

Parameters are f32 (flax's param_dtype); each layer computes in
cfg.compute_dtype, rounding its weights at use. Search runs on
`serving_copy()`, the same weights rounded once to the compute type.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtos_tpu_torch.models.components import (
    Dense, Dropout, Embedding, LayerNorm,
)
from gtos_tpu_torch.models.decoder import Decoder
from gtos_tpu_torch.models.encoder import (
    Conv1d, GRUCell, RelationEncoder, TokenEncoder,
)
from gtos_tpu_torch.models.graph_transformer import GraphTransformer, check_impl
from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
    PAIR_CAP, with_pair_cap,
)
from gtos_tpu_torch.utils.config import ModelConfig
from gtos_tpu_torch.utils.device import resolve_device

EPS = 1e-9
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# "auto" sends a batch to the per-graph localized banks when they are at
# least this much smaller than the batch-global bank (P_loc * ratio <= P).
# The smallest P/P_loc at which the captured "pallas_local" train step was
# no slower than the "pallas" one on an H100 (chip_crossovers.py, PERF.md
# §6 "The route crossovers", table (b)): it was faster at every measured
# batch of the c2 corpus, from P/P_loc = 1 (P_loc = P) to 16, so every
# batch that carries local banks goes local. Serving disagrees: the
# captured encode under "pallas" (B3') was no slower than under
# "pallas_local" at 34 of those 35 batches (by 0-17%), so its
# crossover lies past 16. Training decides.
AUTO_LOCAL_RATIO = 1


def resolve_attention_impl(impl: str, arrays) -> str:
    """attention_impl "auto" -> the route for THIS batch, from the arrays
    it carries (numpy or torch, GraphBatch.arrays() names), in the JAX
    package's order: "block_sparse" when it carries tile layouts (batchify
    builds them under "auto" for a batch whose paths overflow the local
    bank ladder at a tile-aligned bucket); "pallas_local" when it
    carries localized banks of at most P / AUTO_LOCAL_RATIO rows (the
    card's ratio 1: every batch that carries them; the JAX package's 4);
    "pallas" (the global-bank kernels) otherwise. Other impls pass
    through unchanged."""
    if not impl.startswith("auto"):
        return impl
    suffix = "_interpret" if impl.endswith("_interpret") else ""
    if "tile_src" in arrays:
        return "block_sparse" + suffix
    if "bank_map" in arrays:
        P = arrays["rel_bank"].shape[0]
        P_loc = arrays["bank_map"].shape[1]
        if P_loc * AUTO_LOCAL_RATIO <= P:
            return "pallas_local" + suffix
    return "pallas" + suffix


def init_params(model: nn.Module, rng: torch.Generator):
    """Seeded random init following flax's defaults: LeCun-normal
    (truncated) kernels, zero biases, orthogonal GRU recurrent kernels,
    embeddings with std 1/sqrt(rows), unit LayerNorm scales."""

    def lecun(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=rng)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            lecun(mod.weight, mod.weight[0].numel())
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, 0.0, mod.num_embeddings ** -0.5,
                            generator=rng)
        elif isinstance(mod, GRUCell):
            for w in mod.weight_ih.chunk(3):
                lecun(w, w.shape[1])
            for w in mod.weight_hh.chunk(3):
                nn.init.orthogonal_(w, generator=rng)
            nn.init.zeros_(mod.bias_ih)
            nn.init.zeros_(mod.bias_hn)
        elif isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


class Generator(nn.Module):
    """cfg: the model config. device: where the model runs — the CUDA card
    unless "cpu" is passed (raises when no card is visible). rng: the
    torch.Generator of the init (default: seeded with 0). Parameters are
    f32; activations in cfg.compute_dtype. `dropout_rng` is the
    torch.Generator (on `device`, seeded with 0) that every dropout draws
    from in train mode; the model starts in eval mode. cp_mesh: the
    context-parallel mesh (parallel/mesh.py) of the encoder's sparse
    attention, with cfg.cp_schedule (models/graph_transformer.py)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 rng: Optional[torch.Generator] = None, cp_mesh=None):
        device = resolve_device(device)
        super().__init__()
        check_impl(cfg.attention_impl)
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.dtype = dt = _DTYPES[cfg.compute_dtype]
        self.token_encoder = TokenEncoder(
            cfg.concept_vocab, cfg.char_vocab, cfg.d_model, cfg.char_dim,
            cfg.char_filters, cfg.char_widths, cfg.dropout, dt,
            add_positions=cfg.use_node_positions)
        self.relation_encoder = RelationEncoder(
            cfg.relation_vocab, cfg.rel_emb_dim, cfg.rel_hidden, cfg.d_model,
            cfg.dropout, dt)
        self.graph_transformer = GraphTransformer(
            cfg.enc_layers, cfg.d_model, cfg.d_ff, cfg.heads,
            impl=cfg.attention_impl, dropout=cfg.dropout, cp_mesh=cp_mesh,
            cp_schedule=cfg.cp_schedule)
        self.decoder = Decoder(
            cfg.token_vocab, cfg.dec_layers, cfg.d_model, cfg.d_ff,
            cfg.heads, cfg.max_target_len, cfg.dropout, dt)
        if not cfg.tie_embeddings:
            self.out_proj = Dense(cfg.d_model, cfg.token_vocab)
        if cfg.use_copy:
            self.copy_gate = Dense(cfg.d_model, 1)
        # init on the CPU so a seed gives the same weights on every device
        init_params(self, rng if rng is not None
                    else torch.Generator().manual_seed(0))
        self.to(device)
        self.dropout_rng = torch.Generator(device=device).manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.rng = self.dropout_rng
        self._serving = [None, None]   # (parameter versions, rounded copy)
        self._updates = 0
        # the model's CUDA graphs (utils/graphs.py for_model) and its
        # searches' tensors by signature (infer/decode.py)
        self.graphs, self.searches = None, {}
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.embed.weight.device

    def mark_updated(self):
        """Note that the parameters changed where autograd's version
        counters do not see it (a CUDA graph's replay of an optimizer
        step), so that `serving_copy` rounds them anew."""
        self._updates += 1

    def serving_copy(self) -> "Generator":
        """The model for search: itself when it computes in f32, else a
        copy in eval mode with every parameter but the LayerNorms' rounded
        to the compute type (the values each layer would round them to)
        and its Dense/Conv1d/Embedding layers turned into the plain torch
        layers they extend, so that no layer casts a weight or checks a
        type per decode step. A layer that tensor parallelism split (`tp`
        set) stays a Dense: a row layer's output is the group's sum only
        after Dense.forward's all-reduce, before its bias. The tensor
        parallel groups are shared with the copy, not copied. The copy is
        kept until a parameter changes in place (an optimizer step,
        load_state_dict, a replayed train step: `mark_updated`); the
        search's CUDA graphs belong to the copy and go with it."""
        if self.dtype == torch.float32:
            return self
        key = (self._updates, tuple(p._version for p in self.parameters()))
        if self._serving[0] != key:
            self._serving[1] = None
            memo = {id(self.dropout_rng): None,   # not needed in eval
                    id(self.graphs): None,         # the copy's are its own
                    id(self.searches): {}}
            for mod in self.modules():   # tensor parallel groups: shared
                for group in (getattr(mod, "tp_group", None),
                              (getattr(mod, "tp", None) or (0, None))[1]):
                    if group is not None:
                        memo[id(group)] = group
            with torch.inference_mode(False):  # plain tensors, even in search
                clone = copy.deepcopy(self, memo)
                for mod in clone.modules():
                    if not isinstance(mod, LayerNorm):
                        for p in mod.parameters(recurse=False):
                            p.data = p.data.to(self.dtype)
                    if type(mod) in (Dense, Conv1d, Embedding) \
                            and getattr(mod, "tp", None) is None:
                        mod.__class__ = type(mod).__bases__[0]
            self._serving[:] = [key, clone.eval()]
        return self._serving[1]

    # ---------------- encoding ----------------

    def encode(self, concept, concept_char, concept_mask, rel_bank,
               rel_length, rel_index, edges=None, impl: Optional[str] = None):
        """-> concept representations [B, N, D] in the compute dtype.
        edges: the auxiliary arrays of the batch (batch_edges): localized
        banks, edge cells, tile layouts. impl: the attention route of this
        batch (default: cfg.attention_impl, with "auto" resolved from
        rel_bank and edges)."""
        if impl is None:
            impl = resolve_attention_impl(
                self.cfg.attention_impl, dict(edges or {}, rel_bank=rel_bank))
        check_impl(impl)
        x = self.token_encoder(concept, concept_char)
        rel_vecs = self.relation_encoder(rel_bank, rel_length)
        return self.graph_transformer(x, rel_vecs, rel_index, concept_mask,
                                      edges, impl)

    # ---------------- output distribution ----------------

    def _logits(self, h):
        if self.cfg.tie_embeddings:
            return self.decoder.output_logits(h)
        return self.out_proj(h)

    def ext_log_probs(self, h, align_probs, cp_seq, copy_mask):
        """Extended-vocabulary log P, f32 [..., ext_vocab]. On a CUDA card
        the copy mass lands in a fixed order while gradients are taken, so
        a training step gives the same bits on every run.

        h: [..., D]; align_probs: [..., H, N] cross-attn probs; cp_seq and
        copy_mask: [B, N], broadcast over the middle dims of h."""
        cfg = self.cfg
        p_vocab = torch.softmax(self._logits(h).float(), dim=-1)  # [..., V]
        pad_tail = cfg.ext_vocab - p_vocab.shape[-1]
        if not cfg.use_copy:
            return torch.log(F.pad(p_vocab, (0, pad_tail)) + EPS)

        # alpha: average heads, mask to copyable nodes, renormalize
        alpha = align_probs.float().mean(dim=-2)                  # [..., N]
        B, N = cp_seq.shape
        mid = [1] * (alpha.dim() - 2)
        alpha = alpha.masked_fill(~copy_mask.reshape(B, *mid, N), 0.0)
        alpha = alpha / (alpha.sum(-1, keepdim=True) + EPS)
        g = torch.sigmoid(self.copy_gate(h).float())              # [..., 1]
        ext = F.pad(g * p_vocab, (0, pad_tail))
        cp = cp_seq.long().reshape(B, *mid, N).expand_as(alpha)
        if torch.is_grad_enabled():
            lead = torch.meshgrid(
                *(torch.arange(n, device=cp.device) for n in cp.shape[:-1]),
                indexing="ij")
            ext = ext.index_put((*(i[..., None] for i in lead), cp),
                                (1.0 - g) * alpha, accumulate=True)
        else:
            ext = ext.scatter_add(-1, cp, (1.0 - g) * alpha)
        return torch.log(ext + EPS)

    # ---------------- training ----------------

    def forward(self, batch: Dict[str, torch.Tensor], data_group=None):
        """Teacher-forced loss of a batch (GraphBatch.arrays() on the
        model's device, batch_to_device): token NLL over the copy-mixed
        extended vocabulary, label-smoothed over the real token vocab
        (cfg.label_smoothing), averaged over real target positions.
        Dropout is active in train mode; attention_impl "auto" is resolved
        for this batch (encode). Returns (loss, {"loss", "acc", "n_tok"}),
        scalars on the device, and "layout_ok" where the encoder built
        block-sparse backward plans: their device flag that the batch's
        two tile layouts hold the same pairs (unread; the trainer raises
        on a false one when it reads the step's metrics).

        data_group: under data parallelism, the group over which the batch
        rows are split. The sums are then divided by the GLOBAL target
        token count (all-reduced), as the JAX package reduces over the
        whole sharded batch, so `loss` is this rank's term of the global
        loss (the terms, and their gradients, sum to the global ones) and
        the metrics are the global values."""
        cfg = self.cfg
        mem = self.encode(batch["concept"], batch["concept_char"],
                          batch["concept_mask"], batch["rel_bank"],
                          batch["rel_length"], batch["rel_index"],
                          batch_edges(batch))
        h, align = self.decoder(batch["token_in"], mem, batch["concept_mask"])
        # align: [B, H, T, N] -> per position [B, T, H, N]
        logp = self.ext_log_probs(h, align.transpose(1, 2), batch["cp_seq"],
                                  batch["copy_mask"])
        tgt = batch["token_out"].long()
        mask = batch["token_mask"].float()
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        count = mask.sum()
        if data_group is not None:
            count = count.detach().clone()
            torch.distributed.all_reduce(count, group=data_group)
        n_tok = count + EPS
        loss = (nll * mask).sum() / n_tok
        if cfg.label_smoothing > 0.0:
            # the uniform mass goes to the real token vocab only: the OOV
            # tail is per instance and mostly padding
            smooth = -(logp[..., :cfg.token_vocab].mean(-1)
                       * mask).sum() / n_tok
            loss = ((1.0 - cfg.label_smoothing) * loss
                    + cfg.label_smoothing * smooth)
        acc = ((logp.argmax(-1) == tgt) * mask).sum() / n_tok
        metrics = {"loss": loss, "acc": acc, "n_tok": count}
        checks = self.graph_transformer.plan_checks
        if checks:      # the backward plans' layout checks, unread
            metrics["layout_ok"] = torch.stack(checks).all()
        if data_group is not None:
            summed = torch.stack([loss.detach(), acc.detach()])
            torch.distributed.all_reduce(summed, group=data_group)
            metrics.update(loss=summed[0], acc=summed[1])
        return loss, metrics

    # ---------------- incremental decoding ----------------

    def init_cache(self, mem, horizon=None):
        """horizon: decode-step budget; sizes the self-KV buffers."""
        return self.decoder.init_cache(mem.shape[0], mem, horizon=horizon)

    def decode_step(self, token_t, pos, caches, concept_mask, cp_seq,
                    copy_mask):
        """One decode step. token_t: [B] previous tokens (token-vocab
        ids); pos: its position, a 0-d int64 tensor on the card (or an
        int). Returns (log_probs [B, ext_vocab] f32, caches)."""
        h, caches, align = self.decoder.step(token_t, pos, caches,
                                             concept_mask)
        return self.ext_log_probs(h, align, cp_seq, copy_mask), caches


def batch_edges(batch: Dict[str, torch.Tensor]):
    """The encoder's auxiliary arrays from a batch dict, if present: the
    edge cells of "sparse", the tile layouts of "block_sparse", the
    localized-bank arrays of "pallas_local" and the localize sort order of
    training batches."""
    keys = ("edge_src", "edge_dst", "edge_rel", "edge_mask", "tile_src",
            "tile_rel", "tile_dst", "tile_rel_src", "ctile_src", "ctile_rel",
            "ctile_dst", "ctile_rel_src", "bank_map", "rel_index_loc",
            "loc_perm", "loc_bnd", PAIR_CAP)
    out = {k: batch[k] for k in keys if k in batch}
    return out or None


def batch_to_device(arrays: Dict[str, np.ndarray], device,
                    train: bool = True) -> Dict[str, torch.Tensor]:
    """GraphBatch.arrays() -> tensors on `device` (dtypes kept: int32
    indices, bool masks). train: add the pair capacity that a block-sparse
    train step's backward plan needs (ops/block_sparse_attention_bwd.py
    with_pair_cap); False for a batch that only runs forward (serving)."""
    if train:
        arrays = with_pair_cap(arrays)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
