"""Model-facing decoding entry: encode once, beam-search the decoder.

Port of gtos_tpu/infer/decode.py. `decode_batch` is the one entry point
for serving a GraphBatch; it runs on the device of the model's parameters
(the CUDA card unless the model was built with device="cpu"), and it
resolves attention_impl "auto" per batch for every caller (work.py, the
dev-BLEU hook, user scripts): the same model runs either route.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gtos_tpu_torch.infer.beam import BeamResult, beam_search, detokenize
from gtos_tpu_torch.models.generator import (
    Generator, batch_edges, batch_to_device, resolve_attention_impl,
)


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
) -> BeamResult:
    """arrays: the GraphBatch.arrays() payload. impl: the encoder's
    attention route (default: the model's, "auto" resolved from arrays).
    Returns BeamResult (on the model's device). Runs
    `model.serving_copy()`: the weights rounded once to the compute
    type."""
    model = model.serving_copy()
    cfg = model.cfg
    dev = model.device
    t = batch_to_device(arrays, dev)
    B = t["concept"].shape[0]
    K = beam_size

    mem = model.encode(t["concept"], t["concept_char"], t["concept_mask"],
                       t["rel_bank"], t["rel_length"], t["rel_index"],
                       edges=batch_edges(t), impl=impl)

    # tile per beam: [B, ...] -> [B*K, ...]
    concept_mask, cp_seq, copy_mask = (
        t[k].repeat_interleave(K, dim=0)
        for k in ("concept_mask", "cp_seq", "copy_mask"))
    steps = min(max_steps, cfg.max_target_len - 1)
    # self-KV buffers sized to the search horizon, not max_target_len
    caches = model.init_cache(mem.repeat_interleave(K, dim=0), steps)

    def step_fn(tokens, pos, caches):
        return model.decode_step(tokens, pos, caches, concept_mask, cp_seq,
                                 copy_mask)

    def reorder_fn(caches, flat_parent):
        # mem_k/mem_v are identical across a graph's beams and never
        # written: reorder the self-KV buffers only
        return [{k: (v[flat_parent] if k in ("self_k", "self_v") else v)
                 for k, v in c.items()} for c in caches]

    return beam_search(
        step_fn, caches, B, K, steps, cfg.ext_vocab, cfg.token_vocab,
        str_id=str_id, end_id=end_id, unk_id=unk_id, alpha=alpha,
        reorder_fn=reorder_fn, device=dev)


def decode_batch(model: Generator, batch, token_vocab, beam_size: int = 8,
                 max_steps: int = 64, alpha: float = 0.6) -> List[List[str]]:
    """GraphBatch -> best hypothesis token list per instance.

    token_vocab: the target-side Vocab (id -> string table and the
    STR/END/UNK ids). attention_impl "auto" is resolved here, per batch."""
    arrays = batch.arrays()
    res = beam_decode_arrays(
        model, arrays, beam_size=beam_size, max_steps=max_steps,
        alpha=alpha, str_id=token_vocab.str_id, end_id=token_vocab.end_id,
        unk_id=token_vocab.unk_id,
        impl=resolve_attention_impl(model.cfg.attention_impl, arrays))
    seqs = res.seqs[:, 0].cpu().numpy()
    return [detokenize(seqs[b], token_vocab.itos, batch.oov_lists[b],
                       end_id=token_vocab.end_id)
            for b in range(len(batch.oov_lists))]
