"""Model-facing decoding entry: encode once, beam-search the decoder.

Port of gtos_tpu/infer/decode.py. `decode_batch` is the one entry point
for serving a GraphBatch; it runs on the device of the model's parameters
(the CUDA card unless the model was built with device="cpu"), and it
resolves attention_impl "auto" per batch for every caller (work.py, the
dev-BLEU hook, user scripts): the same model runs either route.

The JAX package runs a whole search as one compiled program per batch
signature. On the card the port runs it as CUDA graphs per signature
(route, every array's shape, beam and horizon; utils/graphs.py), in the
serving copy's graph cache: `prep`, which encodes the batch (the route's
kernels, B1, B3/B3' or B5, inside it), projects the decoder's memory K/V
per beam into the search's own cache tensors and resets the search's
state, and one search step (infer/beam.py `Search.step`; one graph per
parity of the step, whose reorder gathers the self-KV buffers from one
of the search's two sets into the other), replayed until the host reads
that the search has ended. On the CPU, or with
compiled=False, the same functions run uncaptured. Under a tensor-parallel
mesh the search is captured the same way, its all-reduces and all-gathers
inside the graphs (a signature's first call, uncaptured, creates the
communicators); under a context-parallel mesh it runs uncaptured
(`EAGER_MESH`).

Spans (utils/profiling.py), each served batch's inside its
"gtos/decode/batch": "gtos/decode/to_device" (the batch's copy to the card
and into the graph's inputs), "gtos/decode/prep" (the encode's launch),
the search's "gtos/search/step" and "gtos/search/wait_flag" (infer/beam.py),
"gtos/decode/read" (the result's gathers and their read back, the wait for
the last steps) and "gtos/decode/detok".
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gtos_tpu_torch.infer.beam import (
    BeamResult, Search, detokenize, write_back,
)
from gtos_tpu_torch.models.generator import (
    Generator, batch_edges, batch_to_device, resolve_attention_impl,
)
from gtos_tpu_torch.utils import graphs as graphs_mod
from gtos_tpu_torch.utils.profiling import annotate

# why a search runs uncaptured on the card (ROADMAP A9)
EAGER_MESH = ("a search under a context-parallel mesh (graph > 1) runs "
              "uncaptured: its encoder's rings exchange node blocks point "
              "to point (parallel/comm.py), which one card cannot check "
              "(two NCCL ranks cannot share it); ROADMAP A9")
# the tiled batch arrays the decode step reads
_TILED = ("concept_mask", "cp_seq", "copy_mask")


class _Served:
    """One signature's tensors on the serving copy (`Generator.searches`):
    the search (state and caches) and the tiled masks."""

    def __init__(self, search: Search):
        self.search = search
        self.masks = None


def search_graphs(model: Generator, compiled: Optional[bool] = None):
    """The graph cache that `beam_decode_arrays` uses for `model` (that of
    its serving copy), or a disabled one where the search runs
    uncaptured. compiled=True where the search cannot be captured (the
    CPU, a context-parallel mesh) raises."""
    return _graphs(model.serving_copy(), compiled)


def _graphs(served, compiled):
    mesh = served.graph_transformer.cp_mesh
    if mesh is not None and mesh.size("graph") > 1:
        if compiled:
            raise ValueError(EAGER_MESH)
        compiled = False
    return graphs_mod.for_model(served, compiled)


def _prep(model, t, served: _Served, impl: str, steps: int):
    """Encode the batch `t`, write the decoder's memory K/V (tiled per
    beam) and the tiled masks into the search's tensors, and reset the
    search."""
    search = served.search
    K = search.K
    mem = model.encode(t["concept"], t["concept_char"], t["concept_mask"],
                       t["rel_bank"], t["rel_length"], t["rel_index"],
                       edges=batch_edges(t), impl=impl)
    # self-KV buffers sized to the search horizon, not max_target_len
    caches = model.init_cache(mem.repeat_interleave(K, dim=0), steps)
    masks = [t[k].repeat_interleave(K, dim=0) for k in _TILED]
    if search.caches is None:     # the first call: the search's own tensors
        first = [{k: v.clone() for k, v in c.items()} for c in caches]
        # the second set (K > 1) has its own self-KV buffers, the first
        # set's memory K/V
        second = first if K == 1 else [
            dict(c, self_k=torch.empty_like(c["self_k"]),
                 self_v=torch.empty_like(c["self_v"])) for c in first]
        search.caches = [first, second]
        served.masks = [m.clone() for m in masks]
        search.reorder_fn = _reorder
    else:
        write_back(search.caches[0], caches)
        write_back(served.masks, masks)
    search.reset()


def _reorder(caches, flat_parent, out):
    # mem_k/mem_v are identical across a graph's beams and never written:
    # reorder the self-KV buffers only
    for c, o in zip(caches, out):
        for k in ("self_k", "self_v"):
            torch.index_select(c[k], 0, flat_parent, out=o[k])


@torch.inference_mode()
def beam_decode_arrays(
    model: Generator,
    arrays: Dict[str, np.ndarray],
    beam_size: int = 8,
    max_steps: int = 64,
    alpha: float = 0.6,
    str_id: int = 2,
    end_id: int = 3,
    unk_id: int = 1,
    impl: Optional[str] = None,
    compiled: Optional[bool] = None,
) -> BeamResult:
    """arrays: the GraphBatch.arrays() payload. impl: the encoder's
    attention route (default: the model's, "auto" resolved from arrays).
    Returns BeamResult (on the model's device). Runs
    `model.serving_copy()`: the weights rounded once to the compute type.
    compiled: None captures the search on the card (module docstring);
    False runs it uncaptured there too. The search runs the model in eval
    mode (no dropout), as the JAX package decodes with
    deterministic=True."""
    model = model.serving_copy().eval()
    graphs = _graphs(model, compiled)
    cfg = model.cfg
    dev = model.device
    impl = impl or resolve_attention_impl(cfg.attention_impl, arrays)
    with annotate("gtos/decode/to_device"):
        t = batch_to_device(arrays, dev, train=False)
        B = t["concept"].shape[0]
        steps = min(max_steps, cfg.max_target_len - 1)
        key = ("search", impl, graphs_mod.signature(t), beam_size, steps,
               alpha, str_id, end_id, unk_id)
        cache = model.searches if graphs.enabled else {}
        served = cache.get(key)
        if served is None:
            served = cache[key] = _Served(Search(
                B, beam_size, steps, cfg.ext_vocab, cfg.token_vocab, str_id,
                end_id, unk_id, alpha, dev))
        static = graphs.inputs(key, t)
    search = served.search
    with annotate("gtos/decode/prep"):
        graphs.run(key + ("prep",), lambda: _prep(model, static, served,
                                                  impl, steps))
    masks = served.masks

    def step_fn(tokens, pos, caches):
        return model.decode_step(tokens, pos, caches, *masks)

    search.step_fn = step_fn
    search.run(lambda parity: graphs.run(
        key + ("step", parity), lambda: search.step(parity)))
    with annotate("gtos/decode/read"):
        return search.result()


def decode_batch(model: Generator, batch, token_vocab, beam_size: int = 8,
                 max_steps: int = 64, alpha: float = 0.6,
                 compiled: Optional[bool] = None) -> List[List[str]]:
    """GraphBatch -> best hypothesis token list per instance.

    token_vocab: the target-side Vocab (id -> string table and the
    STR/END/UNK ids). attention_impl "auto" is resolved here, per batch.
    compiled: as `beam_decode_arrays`."""
    with annotate("gtos/decode/batch"):
        arrays = batch.arrays()
        res = beam_decode_arrays(
            model, arrays, beam_size=beam_size, max_steps=max_steps,
            alpha=alpha, str_id=token_vocab.str_id,
            end_id=token_vocab.end_id, unk_id=token_vocab.unk_id,
            impl=resolve_attention_impl(model.cfg.attention_impl, arrays),
            compiled=compiled)
        with annotate("gtos/decode/read"):
            seqs = res.seqs[:, 0].cpu().numpy()
        with annotate("gtos/decode/detok"):
            return [detokenize(seqs[b], token_vocab.itos, batch.oov_lists[b],
                               end_id=token_vocab.end_id)
                    for b in range(len(batch.oov_lists))]
