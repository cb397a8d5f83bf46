"""The yardstick's arithmetic: the card's peaks, the model's operations
counted from each batch's real content, and the kernels' least times.

The peaks and the bounds are frozen copies of the port's
gtos_tpu_torch/utils/benchlib.py (`bound`, `local_attention_bound`,
`local_attention_bwd_bound`), so that no change to the program moves
them. Operations are counted from what a batch holds, never from its
padded shapes: nodes, target tokens, each graph's distinct relation paths
and their lengths, the chars of each node; a multiply-add is two
operations. A layout that pads less, or computes a shared relation once,
does the same counted work in less time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

H100_BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, 700 W


# ---------------------------------------------------------------- bounds


def bound(nbytes, ops, dtype_name):
    """(bound_ms, bound_by): bytes over 3.35 TB/s against operations over
    the card's peak for the type, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bank_rows(rel_index_loc):
    """Bank rows these inputs reference: per graph, the distinct slots of
    rel_index_loc [B, N, N]."""
    return sum(len(np.unique(rel_index_loc[b]))
               for b in range(rel_index_loc.shape[0]))


def local_attention_bound(rel_index_loc, H, Dh, dtype_name,
                          with_probs=False):
    """(bound_ms, bound_by) of the localized relation attention's forward
    (B1; B1p with_probs). Bytes: q, k, v read and out written once, idx
    and mask read once, of the local banks only the referenced rows, and
    B1p's f32 probs written once. Operations: per pair and head, Dh
    multiply-adds for the score and Dh for the output."""
    B, N, _ = rel_index_loc.shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (4 * B * H * N * Dh * elt + B * N * N * 4 + B * N
              + 2 * _bank_rows(rel_index_loc) * H * Dh * elt)
    if with_probs:
        nbytes += B * H * N * N * 4
    return bound(nbytes, B * H * N * N * 4 * Dh, dtype_name)


def local_attention_bwd_bound(rel_index_loc, H, Dh, P_loc, dtype_name):
    """(bound_ms, bound_by) of its backward (B2). Bytes: q, k, v read
    once, the f32 cotangent and probs read once, idx and the walk arrays
    read once, of the local banks the referenced rows, gq/gk/gv written
    once and the dense bank gradients [B, P_loc, H, Dh] written in full.
    Operations: per pair and head, Dh multiply-adds each for g.v, gq, gk,
    gv, g_a, g_b."""
    B, N, _ = rel_index_loc.shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (3 * B * H * N * Dh * elt + B * H * N * Dh * 4
              + B * H * N * N * 4 + 2 * B * N * N * 4 + B * (P_loc + 1) * 4
              + 2 * _bank_rows(rel_index_loc) * H * Dh * elt
              + 3 * B * H * N * Dh * elt + 2 * B * P_loc * H * Dh * elt)
    return bound(nbytes, B * H * N * N * 12 * Dh, dtype_name)


def relattn_bound_s(arrays, cfg: dict, train: bool) -> float:
    """The least seconds of a batch's localized relation attention over
    every encoder layer: B1p and B2 (train) or B1 (serving). 0 for a
    batch without local banks (another route: no such kernel runs)."""
    idx = arrays.get("rel_index_loc")
    if idx is None:
        return 0.0
    H = cfg["heads"]
    Dh = cfg["d_model"] // H
    dt = cfg["compute_dtype"]
    ms = local_attention_bound(idx, H, Dh, dt, with_probs=train)[0]
    if train:
        ms += local_attention_bwd_bound(idx, H, Dh,
                                        arrays["bank_map"].shape[1], dt)[0]
    return ms * cfg["enc_layers"] / 1e3


# ---------------------------------------------------------------- operations


def content(arrays) -> Dict[str, np.ndarray]:
    """A batch's real content, per row: nodes (with the global node),
    target tokens, real chars, distinct relation paths; and the summed
    label-path length of those paths (per-row lists)."""
    mask = arrays["concept_mask"]
    nodes = mask.sum(1).astype(np.int64)
    tokens = arrays["token_mask"].sum(1).astype(np.int64)
    chars = (arrays["concept_char"] != 0).sum((1, 2)).astype(np.int64)
    length = arrays["rel_length"].astype(np.int64)
    paths, path_len = [], []
    for b in range(mask.shape[0]):
        n = int(nodes[b])
        rows = np.unique(arrays["rel_index"][b, :n, :n]) if n else \
            np.zeros(0, np.int64)
        paths.append(len(rows))
        path_len.append(int(length[rows].sum()))
    return dict(nodes=nodes, tokens=tokens, chars=chars,
                paths=np.array(paths, np.int64),
                path_len=np.array(path_len, np.int64))


def encode_flops(c, cfg: dict) -> float:
    """Forward operations of encoding the rows' graphs."""
    D, Fd, L = cfg["d_model"], cfg["d_ff"], cfg["enc_layers"]
    e, Hr = cfg["rel_emb_dim"], cfg["rel_hidden"]
    conv = sum(2 * w * cfg["char_dim"] * cfg["char_filters"]
               for w in cfg["char_widths"])
    per_node = (2 * cfg["char_filters"] * len(cfg["char_widths"]) * D
                + 2 * 2 * D * D + L * (2 * 4 * D * D + 2 * 2 * D * Fd))
    per_path = 2 * 2 * Hr * D + L * 2 * D * 2 * D
    per_label = 2 * 2 * (3 * Hr * e + 3 * Hr * Hr)
    n = c["nodes"].astype(np.float64)
    return float((c["chars"] * conv).sum() + (n * per_node).sum()
                 + (c["paths"] * per_path).sum()
                 + (c["path_len"] * per_label).sum()
                 + (L * 4 * D * n * n).sum())


def train_flops(arrays, cfg: dict) -> float:
    """Operations of one training step on the batch: three times the
    forward (backward twice the forward; nothing recomputed)."""
    c = content(arrays)
    D, Fd, L, V = cfg["d_model"], cfg["d_ff"], cfg["dec_layers"], \
        cfg["token_vocab"]
    t = c["tokens"].astype(np.float64)
    n = c["nodes"].astype(np.float64)
    dec = (t * (L * (2 * 6 * D * D + 2 * 2 * D * Fd + 4 * D * n)
                + 2 * D * V)
           + L * 4 * D * t * (t + 1) / 2 + L * 2 * 2 * D * D * n)
    return 3.0 * (encode_flops(c, cfg) + float(dec.sum()))


def serve_flops(arrays, rows: int, steps: int, beam: int,
                cfg: dict) -> float:
    """Operations of serving the batch's first `rows` requests: the
    encode, the memory projections once a request, and `steps` decode
    steps of each of `beam` beams (self-attention over the positions so
    far, cross-attention over the nodes, the output layer)."""
    c = {k: v[:rows] for k, v in content(arrays).items()}
    D, Fd, L, V = cfg["d_model"], cfg["d_ff"], cfg["dec_layers"], \
        cfg["token_vocab"]
    n = c["nodes"].astype(np.float64)
    S = float(steps)
    per_step = L * (2 * 6 * D * D + 2 * 2 * D * Fd + 4 * D * n) + 2 * D * V
    dec = beam * (S * per_step + L * 4 * D * S * (S + 1) / 2) \
        + L * 2 * 2 * D * D * n
    return encode_flops(c, cfg) + float(dec.sum())
