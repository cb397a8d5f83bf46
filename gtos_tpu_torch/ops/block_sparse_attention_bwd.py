"""Block-sparse relation-aware attention, backward.

Port of gtos_tpu/ops/pallas/block_sparse_attention_bwd.py. From the
forward's inputs, its output `out` (in v's type), its statistics m, l
[B, H, N] (B5s) and the output's cotangent g, for each kept pair (i <- j,
bank row r) and head:

    p_ij  = exp(e_ij - m_i) / l_i,  dp_ij = gp_i.v_j,  delta_i = g_i.out_i
    ge_ij = p_ij (dp_ij - delta_i) * scale
    dq_i  = sum_j ge'_ij (k_j + b_r)       dk_j = sum_i ge'_ij (q_i + a_r)
    dv_j  = sum_i p'_ij gp_i
    g_a[r] = sum ge'_ij k_j + dt4_r b_r    g_b[r] = sum ge'_ij q_i + dt4_r a_r

with e_ij the forward's scores, gp = g rounded to the input type (the JAX
package's `gp = g.astype(dt)`), delta from g in f32 and out in v's type,
ge' and p' rounded to the input type, dt4_r = sum ge'_ij over the pairs of
bank row r (finish_bank_grads's t4 redistribution), every sum in f32,
dq/dk/dv returned in the input type and g_a/g_b in the bank type.

Three hand-written CUDA kernels, one source (csrc/block_sparse_attention_
bwd.cu), each with a wrapper that launches it for CUDA tensors, runs its
plain torch version for CPU tensors and counts its launches:

  B6d `block_sparse_attention_bwd_dst`  dst-major over tile_src/tile_rel:
      dq, ge [H, E] (f32, per kept pair, E pairs in the planes' order) and
      pair_s [H, E, 2] (f32, each pair's ge and p at its src-major place);
  B6s `block_sparse_attention_bwd_src`  src-major over tile_dst/
      tile_rel_src: dk and dv from B6d's pair_s, with no score;
      both a block per own node whose warps, a head each, share one read
      of the plane rows and walk the kept pairs 8 lanes a pair, 16 bytes
      a lane, each row read once;
  B6b `block_sparse_bank_grads`         g_a and g_b from ge, summed over
      the pairs of each bank row in a fixed order: a run of at most
      SHORT_RUN pairs a lane group, a longer one cut into chunks of
      BANK_CHUNK pairs a block, whose sums a second launch adds in chunk
      order; every bank row written once, the unreferenced ones as 0.

`backward_plan` builds, from the two tile layouts, what B6d, B6s and B6b
walk: each plane row's first pair id in both orders, each pair's src-major
place, the pairs sorted by bank row and B6b's work list. It depends on the
batch only, so the encoder stack builds it once for all its layers. Its
shapes are fixed by the layouts' shapes, the bank size P and a pair
capacity E_cap >= E (pair_capacity: one class of E per power of two,
which a train batch carries in its signature, with_pair_cap), and it
reads nothing back from the card, so a train step that builds it can be
captured as a CUDA graph: the E real pairs fill the first E slots of each
[E_cap] array in today's order, the padding slots carry sentinels (bank
row P, a node key past every real key), E and the work list's counts stay
device scalars, and the check that both layouts hold the same pairs is a
device flag (`ok`) that the train step hands on with its metrics
(train/trainer.py raises the ValueError when it reads them); on the CPU
the plan raises at once. B6d and B6s take E_cap as the stride of ge and
pair_s and write only the real pairs; B6b's grid is sized from the work
list's bounds and its blocks past the device counts return at once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from gtos_tpu_torch.ops import build
from gtos_tpu_torch.ops.block_sparse_attention import (
    _DTYPES, _check, bank_t4, check_args, check_layout, pair_logits,
    tile_pairs, tile_pairs_padded,
)
from gtos_tpu_torch.ops.relation_attention import (
    _default_scale, _on_card, _raise_on, _stream,
)

BWD_SOURCE = "block_sparse_attention_bwd.cu"
# B6b: a bank row with at most SHORT_RUN kept pairs is one lane group's
# work; a longer one is cut into chunks of BANK_CHUNK pairs, a block each
# (the kernel's kShortRun and kChunk)
SHORT_RUN, BANK_CHUNK = 32, 256


def prep_bwd_invariants(q, g, out):
    """(gp, delta): the cotangent in the input type, and delta = sum_d
    g.out [B, H, N] f32 from g in f32 and out in v's type."""
    return (g.to(q.dtype).contiguous(),
            (g.float() * out.float()).sum(-1).contiguous())


def _row_base(valid):
    """[B, Tn, S, 128] int32: the place of each plane row's first kept
    pair, the pairs counted in the planes' order."""
    counts = valid.sum(-1, dtype=torch.int32)
    return (torch.cumsum(counts.flatten(), 0, dtype=torch.int32)
            - counts.flatten()).view(counts.shape).contiguous()


def bank_work(run_r, run_len):
    """B6b's work list (numpy, int32 [n, 4] each) for the runs of one bank
    row in the sorted pair order (bank rows `run_r`, lengths `run_len`):
    `chunks` (first place, pairs, bank row, workspace slot), the runs of
    more than SHORT_RUN pairs cut into BANK_CHUNK-pair pieces in order, the
    slot -1 for a run of one piece and the pieces of a run of several on
    consecutive slots; `shorts` (first place, pairs, bank row, 0), the other
    runs, longest first (stable); `multi` (first slot, slots, bank row, 0),
    the runs of several pieces."""
    run_r = np.asarray(run_r, np.int64)
    run_len = np.asarray(run_len, np.int64)
    start = np.cumsum(run_len) - run_len
    short = np.flatnonzero(run_len <= SHORT_RUN)
    short = short[np.argsort(-run_len[short], kind="stable")]
    zero = np.zeros(len(short), np.int64)
    shorts = np.stack([start[short], run_len[short], run_r[short], zero], 1)
    long = np.flatnonzero(run_len > SHORT_RUN)
    pieces = -(-run_len[long] // BANK_CHUNK)
    run_of = np.repeat(long, pieces)
    k = np.arange(len(run_of)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    lo = start[run_of] + k * BANK_CHUNK
    n = np.minimum(BANK_CHUNK, start[run_of] + run_len[run_of] - lo)
    several = np.repeat(pieces > 1, pieces)
    slot = np.full(len(run_of), -1, np.int64)
    slot[several] = np.arange(int(several.sum()))
    chunks = np.stack([lo, n, run_r[run_of], slot], 1)
    m = pieces > 1
    first = np.cumsum(pieces[m]) - pieces[m]
    multi = np.stack([first, pieces[m], run_r[long[m]],
                      np.zeros(int(m.sum()), np.int64)], 1)
    as_i32 = lambda x: x.reshape(-1, 4).astype(np.int32)  # noqa: E731
    return as_i32(chunks), as_i32(shorts), as_i32(multi)


LAYOUT_MISMATCH = ("the src-major tile layout does not hold the dst-major "
                   "layout's pairs")
# the batch array whose shape [0, E_cap] carries a train batch's pair
# capacity into its signature and to the encoder (with_pair_cap)
PAIR_CAP = "pair_cap"


def pair_capacity(rel) -> int:
    """The pair capacity E_cap of a tile layout `rel` (tile_rel, or the
    ring's ctile_rel, which bounds each of its cells; numpy, or a tensor,
    which is then read): the power of two at or above its entries >= 0 (a
    bound on the pairs it keeps), at most its size, at least 1. A class of
    E rather than E itself, so that batches of one bucket mostly share it;
    the layout's size would be 20-50x the kept pairs of the c5 model's
    batches."""
    n = int((rel >= 0).sum())
    size = rel.size if isinstance(rel, np.ndarray) else rel.numel()
    return max(1, min(1 << max(n - 1, 0).bit_length(), size))


def with_pair_cap(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`arrays` (GraphBatch.arrays(), numpy), and where they hold a
    src-major tile layout, which a train step walks through the backward
    plan, PAIR_CAP: a zero-element int32 [0, E_cap] array (pair_capacity)
    whose shape puts the capacity into the batch signature and hands it to
    the encoder (pair_cap). The batch's own arrays stay the JAX
    package's."""
    for src, rel in (("tile_rel_src", "tile_rel"),
                     ("ctile_rel_src", "ctile_rel")):
        if src in arrays and PAIR_CAP not in arrays:
            cap = pair_capacity(np.asarray(arrays[rel]))
            return dict(arrays, **{PAIR_CAP: np.zeros((0, cap), np.int32)})
    return arrays


def pair_cap(edges) -> int:
    """The pair capacity that with_pair_cap gave a batch."""
    if PAIR_CAP not in edges:
        raise ValueError("a block-sparse train step needs the batch's pair "
                         "capacity: batch_to_device(arrays, device) adds it")
    return edges[PAIR_CAP].shape[-1]


def work_bounds(cap: int, P: int):
    """(runs, chunks, multi, slots): how many entries B6b's work list can
    need for at most `cap` kept pairs over P bank rows, the sizes of the
    plan's buffers and of B6b's workspace. Runs: one per bank row a pair
    references; chunks: a run of n > SHORT_RUN pairs takes ceil(n /
    BANK_CHUNK) <= n / BANK_CHUNK + 1; multi: the runs of more than
    BANK_CHUNK pairs; slots: their chunks. Each at least 1."""
    runs = max(1, min(P, cap))
    multi = max(1, min(P, cap // (BANK_CHUNK + 1)))
    whole = -(-cap // BANK_CHUNK)
    return (runs, max(1, whole + min(P, cap // (SHORT_RUN + 1))), multi,
            max(1, whole + multi))


def bank_work_padded(rs, E, P: int):
    """bank_work on the card, with no host read: rs [cap] int64, the bank
    row of each place of the bank-row order (P at the padding places, from
    E on); E, the kept pairs (0-dim). Returns (chunks, shorts, multi) int32
    [n, 4] with n from work_bounds, each list's entries as bank_work gives
    them followed by no-op padding ((0, 0, P, -1) in chunks, (0, 0, P, 0)
    in the others); counts int32 [4]: the chunks, shorts and multi
    entries and the workspace slots they use; and run_r [n_runs bound]
    int64, the runs' bank rows in order (P past the last)."""
    cap = rs.numel()
    R, C, M, _ = work_bounds(cap, P)
    dev = rs.device
    x = torch.arange(cap, device=dev)
    prev = torch.cat([rs.new_full((1,), -1), rs[:-1]])
    starts = torch.cumsum((x < E) & (rs != prev), 0)
    # the k-th run starts where the count of starts reaches k + 1
    first = torch.minimum(torch.searchsorted(
        starts, torch.arange(1, R + 2, device=dev)), E)
    run_len = first[1:] - first[:-1]
    first = first[:R]
    run_r = torch.where(run_len > 0, rs[first.clamp_max(cap - 1)], P)
    i64 = lambda v: torch.full((), v, dtype=torch.long,  # noqa: E731
                               device=dev)

    def rows(live, cols, pad):      # pad: made on the card, no host copy
        pad = torch.stack([i64(v) for v in pad])
        return torch.where(live[:, None], torch.stack(cols, 1),
                           pad).to(torch.int32)

    short = (run_len > 0) & (run_len <= SHORT_RUN)
    by_len = torch.sort(torch.where(short, -run_len, 1), stable=True)[1]
    n_short = short.sum()
    shorts = rows(torch.arange(R, device=dev) < n_short,
                  [first[by_len], run_len[by_len], run_r[by_len],
                   i64(0).expand(R)], [0, 0, P, 0])
    pieces = torch.where(run_len > SHORT_RUN,
                         -(-run_len // BANK_CHUNK), 0)
    several = pieces > 1
    slots = pieces * several
    slot_first = torch.cumsum(slots, 0) - slots
    ends = torch.cumsum(pieces, 0)
    c = torch.arange(C, device=dev)
    k = torch.searchsorted(ends, c, right=True).clamp_max(R - 1)
    piece = c - (ends[k] - pieces[k])
    lo = first[k] + piece * BANK_CHUNK
    chunks = rows(c < ends[-1], [
        lo, torch.minimum(first[k] + run_len[k] - lo, i64(BANK_CHUNK)),
        run_r[k], torch.where(several[k], slot_first[k] + piece, -1)],
        [0, 0, P, -1])
    m = torch.arange(M, device=dev)
    multis = torch.cumsum(several, 0)
    k = torch.searchsorted(multis, m, right=True).clamp_max(R - 1)
    multi = rows(m < multis[-1], [slot_first[k], pieces[k], run_r[k],
                                  i64(0).expand(M)], [0, 0, P, 0])
    counts = torch.stack([ends[-1], n_short, multis[-1],
                          slots.sum()]).to(torch.int32)
    return chunks, shorts, multi, counts, run_r


def backward_plan(tile_src, tile_rel, tile_dst, tile_rel_src, N: int,
                  P: int, cap: int) -> Dict:
    """The pair orders of the backward for one batch (torch, on the
    layouts' device), built with no read of the card and shapes fixed by
    the layouts' shapes, P and `cap` (the pair capacity E_cap, at least
    the kept pairs E: pair_capacity). Keys:

      `cap`           E_cap, a host int: the length of the [E_cap] arrays
                      and the stride of B6d's ge [H, E_cap] and pair_s;
      `E`             int32 0-dim: the kept pairs, ids 0..E-1 in the
                      dst-major planes' order;
      `ok`            bool 0-dim: both layouts hold the same pairs (and
                      E <= E_cap); false raises ValueError at once on the
                      CPU and when the train step's metrics are read on
                      the card (train/trainer.py);
      `row_base`      [B, Td, Smax, 128] int32: each dst-major plane row's
                      first pair id;
      `src_row_base`  [B, Ts, Smax_s, 128] int32: the same over the
                      src-major planes, whose order gives each pair its
                      src-major place;
      `dst2src`       [E_cap] int32: each pair id's src-major place (a
                      padding id its own);
      `pid`, `qrow` (b*N + i), `krow` (b*N + j)  [E_cap] int32: the pairs
                      in bank-row order (stable), the padding last (pid its
                      ids, rows 0);
      `bank_chunks`, `bank_shorts`, `bank_multi`  int32 [n, 4] and
      `bank_counts`   int32 [4]: B6b's work list (bank_work_padded) and
                      its counts; `bank_slots` (host int) the workspace
                      slots it may use (work_bounds);
      `bank_used`     [P] uint8: 1 for a bank row some pair references;
      `pairs`         (b, i, j, r) int64 [E_cap] in pair-id order, the
                      padding (0, 0, 0, P), which the plain B6b sums
                      (real_pairs(plan) slices the real ones on the host,
                      for checks)."""
    cap = max(1, int(cap))
    bi, i, j, r, E, valid = tile_pairs_padded(tile_src, tile_rel, N, P,
                                              cap)
    sb, sj, si, sr, sE, svalid = tile_pairs_padded(tile_dst, tile_rel_src,
                                                   N, P, cap)
    x = torch.arange(cap, device=r.device)
    live = x < E
    past = tile_src.shape[0] * N * N       # a node key past every real one
    key = torch.where(live, (bi * N + i) * N + j, past)
    skey = torch.where(x < sE, (sb * N + si) * N + sj, past)
    sorted_skey, by_key = torch.sort(skey, stable=True)
    at = torch.searchsorted(sorted_skey, key).clamp_max(cap - 1)
    ok = ((E == sE) & (E <= cap)
          & ~(live & ((sorted_skey[at] != key) | (sr[by_key[at]] != r))
              ).any())
    if r.device.type == "cpu" and not bool(ok):
        raise ValueError(LAYOUT_MISMATCH if E <= cap else
                         f"{int(E)} kept pairs over the pair capacity {cap}")
    order = torch.sort(r, stable=True)[1]
    # a list within the capacity even where E > cap (`ok` false)
    chunks, shorts, multi, counts, run_r = bank_work_padded(
        r[order], E.clamp_max(cap), P)
    i32 = torch.int32
    return dict(cap=cap, E=E.to(i32), ok=ok, row_base=_row_base(valid),
                src_row_base=_row_base(svalid),
                dst2src=torch.where(live, by_key[at], x).to(i32),
                pid=order.to(i32), qrow=(bi * N + i)[order].to(i32),
                krow=(bi * N + j)[order].to(i32), bank_chunks=chunks,
                bank_shorts=shorts, bank_multi=multi, bank_counts=counts,
                bank_slots=work_bounds(cap, P)[3],
                bank_used=torch.zeros(P + 1, dtype=torch.uint8,
                                      device=r.device).index_fill_(
                                          0, run_r, 1)[:P],
                pairs=(bi, i, j, r))


def real_pairs(plan):
    """The plan's kept pairs (b, i, j, r) int64 [E] in pair-id order: a
    host read of E, for checks and plain versions outside a step."""
    E = int(plan["E"])
    return tuple(x[:E] for x in plan["pairs"])


# ---------------------------------------------------------- plain versions


def _pair_grads(q, k, v, a_bank, b_bank, t4, gp, m, l, delta, bi, i, j, r,
                scale):
    """(ge, p) [E, H] f32 of the pairs (bi, i <- j, r)."""
    N = q.shape[2]
    e = pair_logits(q, k, a_bank, b_bank, t4, bi, i, j, r, scale)
    rows = lambda x: x.transpose(1, 2).reshape(-1, x.shape[1])  # noqa: E731
    at = bi * N + i
    l_i = rows(l)[at]
    p = torch.exp(e - rows(m)[at]) / torch.where(l_i > 0, l_i, 1.0)
    dp = (gp[bi, :, i].float() * v[bi, :, j].float()).sum(-1)
    return p * (dp - rows(delta)[at]) * scale, p


def _scatter_rows(B, N, rows, w, x):
    """sum over pairs of w [E, H] * x [E, H, Dh] into node rows (ids
    b*N + n [E]): [B, H, N, Dh] f32."""
    H, Dh = x.shape[1:]
    acc = torch.zeros(B * N, H, Dh, dtype=torch.float32, device=x.device)
    acc.index_add_(0, rows, w[..., None] * x)
    return acc.view(B, N, H, Dh).transpose(1, 2)


def block_sparse_attention_bwd_dst_reference(q, k, v, a_bank, b_bank, t4, gp,
                                             m, l, delta, tile_src, tile_rel,
                                             scale=None):
    """Plain version of B6d: (dq [B, H, N, Dh] in q's type, ge [H, E] f32,
    the pairs in tile_pairs order)."""
    B, H, N, Dh = q.shape
    scale = _default_scale(q, scale)
    bi, i, j, r, _ = tile_pairs(tile_src, tile_rel, N, a_bank.shape[0])
    ge, _ = _pair_grads(q, k, v, a_bank, b_bank, t4, gp, m, l, delta, bi, i,
                        j, r, scale)
    geq = ge.to(q.dtype).float()
    dq = _scatter_rows(B, N, bi * N + i, geq,
                       k[bi, :, j].float() + b_bank[r].float())
    return dq.to(q.dtype).contiguous(), ge.T.contiguous()


def block_sparse_attention_bwd_src_reference(q, k, v, a_bank, b_bank, t4, gp,
                                             m, l, delta, tile_dst,
                                             tile_rel_src, scale=None):
    """Plain version of B6s: (dk, dv) [B, H, N, Dh] in the input types."""
    B, H, N, Dh = q.shape
    scale = _default_scale(q, scale)
    bi, j, i, r, _ = tile_pairs(tile_dst, tile_rel_src, N, a_bank.shape[0])
    ge, p = _pair_grads(q, k, v, a_bank, b_bank, t4, gp, m, l, delta, bi, i,
                        j, r, scale)
    rows = bi * N + j
    dk = _scatter_rows(B, N, rows, ge.to(q.dtype).float(),
                       q[bi, :, i].float() + a_bank[r].float())
    dv = _scatter_rows(B, N, rows, p.to(q.dtype).float(), gp[bi, :, i].float())
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def block_sparse_bank_grads_reference(q, k, a_bank, b_bank, ge, plan):
    """Plain version of B6b: (g_a, g_b) [P, H, Dh] in the bank type, from
    ge [H, >= E] (B6d's, pair ids in its columns) and backward_plan's
    padded pairs (b, i, j, r) in pair-id order, with no read of the card:
    each real pair summed into its bank row r, the padding (r = P) into a
    row that is dropped. It reads neither the pair orders nor the work
    list that the kernel walks (work_list_covers checks those)."""
    bi, i, j, r = plan["pairs"]
    P, H, Dh = a_bank.shape
    cap = r.numel()
    ge = ge[:, :cap]
    if ge.shape[1] < cap:           # the plain B6d's ge has E columns
        ge = torch.cat([ge, ge.new_zeros(H, cap - ge.shape[1])], 1)
    # the padding columns of the kernel's ge are never written
    geq = torch.where((r < P)[:, None], ge.T.to(q.dtype).float(), 0.0)
    f32 = torch.float32
    zero = lambda *s: torch.zeros(P + 1, *s, dtype=f32,  # noqa: E731
                                  device=q.device)
    dt4 = zero(H).index_add(0, r, geq)[:P]
    g_a = zero(H, Dh).index_add(0, r, geq[..., None] * k[bi, :, j].float())
    g_b = zero(H, Dh).index_add(0, r, geq[..., None] * q[bi, :, i].float())
    g_a = g_a[:P] + dt4[..., None] * b_bank.float()
    g_b = g_b[:P] + dt4[..., None] * a_bank.float()
    return g_a.to(a_bank.dtype), g_b.to(b_bank.dtype)


def work_list_covers(plan, P) -> torch.Tensor:
    """bool 0-dim, with no read of the card: whether B6b's work list, read
    as the kernel reads it (the entries below the device counts), sums
    each of the E real places of the bank-row order exactly once into that
    place's own bank row and nothing past them; a chunk on a workspace
    slot sums into the row of the `multi` entry that combines the slot,
    each slot is written by one chunk and combined by one entry, and no
    entry names a row outside [0, P)."""
    cap, slots = plan["pid"].numel(), plan["bank_slots"]
    dev = plan["pid"].device
    rs = plan["pairs"][3][plan["pid"].long()]    # each place's bank row
    n_chunks, n_short, n_multi, _ = plan["bank_counts"].long().unbind()

    def spread(items, n_items, width, size):
        """Each live entry's (first + o for o < its count) positions, the
        ones outside [0, size) at `size`; (live mask, positions)."""
        items = items.long()
        off = torch.arange(width, device=dev)
        live = ((torch.arange(len(items), device=dev) < n_items)[:, None]
                & (off < items[:, 1:2]))
        at = items[:, :1] + off
        at = torch.where(live & (at >= 0) & (at < size), at, size)
        return live, at

    def tally(at, live, size):
        return torch.zeros(size + 1, dtype=torch.long, device=dev
                           ).index_add_(0, at.flatten(), live.flatten().long())

    multi, chunks = plan["bank_multi"], plan["bank_chunks"].long()
    # a run of n <= cap pairs has at most ceil(cap / BANK_CHUNK) chunks
    m_live, m_at = spread(multi, n_multi, min(slots, -(-cap // BANK_CHUNK)),
                          slots)
    slot_row = torch.full((slots + 1,), -1, dtype=torch.long,
                          device=dev).scatter_(
        0, m_at.flatten(), torch.where(m_live, multi[:, 2:3].long(),
                                       -1).expand_as(m_at).flatten())
    c_live = torch.arange(len(chunks), device=dev) < n_chunks
    slot = torch.where(c_live & (chunks[:, 3] >= 0),
                       chunks[:, 3].clamp(0, slots), slots)
    slots_ok = (tally(slot, c_live & (chunks[:, 3] >= 0), slots)
                == tally(m_at, m_live, slots))[:slots].all()
    chunk_row = torch.where(chunks[:, 3] < 0, chunks[:, 2], slot_row[slot])
    seen, wrong = torch.zeros(cap + 1, dtype=torch.long, device=dev), 0
    for items, n_items, width, row in (
            (chunks, n_chunks, BANK_CHUNK, chunk_row),
            (plan["bank_shorts"], n_short, SHORT_RUN,
             plan["bank_shorts"][:, 2].long())):
        live, at = spread(items, n_items, width, cap)
        seen += tally(at, live, cap)
        rs_at = torch.cat([rs, rs.new_full((1,), -1)])[at]
        wrong = wrong + (live & (rs_at != row[:, None])).sum()
    for items, n_items in ((chunks, n_chunks), (plan["bank_shorts"],
                                                  n_short), (multi, n_multi)):
        row = items[:, 2].long()         # a live entry writes a real row
        live = torch.arange(len(items), device=dev) < n_items
        wrong = wrong + (live & ((row < 0) | (row >= P))).sum()
    real = torch.arange(cap + 1, device=dev) < plan["E"]
    return slots_ok & (seen == real.long()).all() & (wrong == 0)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    """B6d's, B6s's and B6b's C entry points, with argument types."""
    return kernel_entries(build.load(BWD_SOURCE))


def kernel_entries(lib):
    """(B6d, B6s, B6b, variant) entry points of a library built from
    BWD_SOURCE, with argument types; variant(v) forces B6d's, B6s's and
    B6b's bf16 variant v (-1: their own) and returns the number of
    variants, 0 unless the library was built with GTOS_B6_VARIANTS."""
    dst, src, bank, variant = (
        lib.gtos_blk_attn_bwd_dst, lib.gtos_blk_attn_bwd_src,
        lib.gtos_blk_bank_grads, lib.gtos_blk_attn_bwd_variant)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dst.argtypes = ([i32] + [ptr] * 17 + [i32] * 8
                    + [ctypes.c_float, ptr])
    src.argtypes = [i32] + [ptr] * 9 + [i32] * 8 + [ptr]
    bank.argtypes = ([i32] + [ptr] * 9 + [i32, ptr, i32, ptr, i32]
                     + [ptr] * 5 + [i32] * 5 + [ptr])
    variant.argtypes = [i32]
    for fn in (dst, src, bank, variant):
        fn.restype = ctypes.c_int
    return dst, src, bank, variant


def _check_bwd(q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tiles, rels):
    check_args(q, k, v, a_bank, b_bank, tiles, rels)
    B, H, N, Dh = q.shape
    _check("t4", t4, (a_bank.shape[0], H), torch.float32, q.device)
    _check("gp", gp, (B, H, N, Dh), q.dtype, q.device)
    for name, t in (("m", m), ("l", l), ("delta", delta)):
        _check(name, t, (B, H, N), torch.float32, q.device)


def _check_plan(plan, q, tiles, key):
    """The plan's row bases for this layout and its pair capacity."""
    if plan is None or key not in plan:
        raise ValueError("the block-sparse backward kernels need "
                         "backward_plan(tile_src, tile_rel, tile_dst, "
                         "tile_rel_src, N, P)")
    B, Tn, Smax = tiles.shape
    _check(key, plan[key], (B, Tn, Smax, 128), torch.int32, q.device)
    return plan["cap"]


def block_sparse_attention_bwd_dst(q, k, v, a_bank, b_bank, t4, gp, m, l,
                                   delta, tile_src, tile_rel, plan=None,
                                   scale=None):
    """B6d: (dq [B, H, N, Dh] in q's type, ge [H, E_cap] f32 (pair id
    columns; the padding columns left unwritten), pair_s [H, E_cap, 2]
    f32: each pair's ge and p at its src-major place, for B6s; for CPU
    tensors ge [H, E] and pair_s None, B6s recomputing them). t4: bank_t4;
    gp: the cotangent in q's type; m, l: B5s's statistics; delta
    [B, H, N] f32 (prep_bwd_invariants); plan: backward_plan (on the card;
    the CPU's plain version needs none). Same limits as B5."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return (*block_sparse_attention_bwd_dst_reference(
            q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_src, tile_rel,
            scale), None)
    check_layout(q, tile_src, tile_rel)
    _check_bwd(q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_src,
               tile_rel)
    B, H, N, Dh = q.shape
    Td, Smax = tile_src.shape[1:]
    E = _check_plan(plan, q, tile_src, "row_base")     # the capacity
    _check("dst2src", plan["dst2src"], (E,), torch.int32, q.device)
    dq = torch.empty_like(q)
    ge = torch.empty(H, E, dtype=torch.float32, device=q.device)
    pair_s = torch.empty(H, E, 2, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[0](
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            a_bank.data_ptr(), b_bank.data_ptr(), t4.data_ptr(),
            gp.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
            tile_src.data_ptr(), tile_rel.data_ptr(),
            plan["row_base"].data_ptr(), plan["dst2src"].data_ptr(),
            dq.data_ptr(), ge.data_ptr(), pair_s.data_ptr(), B, H, N, Dh,
            a_bank.shape[0], Td, Smax, E, float(scale), _stream(q))
    _raise_on(err, "block-sparse attention backward (dst pass)")
    block_sparse_attention_bwd_dst.launches += 1
    return dq, ge, pair_s


def block_sparse_attention_bwd_src(q, k, v, a_bank, b_bank, t4, gp, m, l,
                                   delta, tile_dst, tile_rel_src, plan=None,
                                   pair_s=None, scale=None):
    """B6s: (dk, dv) [B, H, N, Dh] in the input types, from the src-major
    layout. Arguments as B6d's, and on the card B6d's pair_s for the same
    inputs: the kernel reads each pair's ge and p there and gathers only
    q_i, gp_i and a_r. Same limits."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return block_sparse_attention_bwd_src_reference(
            q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_dst,
            tile_rel_src, scale)
    check_layout(q, tile_dst, tile_rel_src)
    _check_bwd(q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_dst,
               tile_rel_src)
    B, H, N, Dh = q.shape
    Ts, Smax = tile_dst.shape[1:]
    E = _check_plan(plan, q, tile_dst, "src_row_base")   # the capacity
    if pair_s is None:
        raise ValueError("B6s on the card reads B6d's pair_s")
    _check("pair_s", pair_s, (H, E, 2), torch.float32, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[1](
            _DTYPES[q.dtype], q.data_ptr(), gp.data_ptr(), a_bank.data_ptr(),
            tile_dst.data_ptr(), tile_rel_src.data_ptr(),
            plan["src_row_base"].data_ptr(), pair_s.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, N, Dh, a_bank.shape[0], Ts,
            Smax, E, _stream(q))
    _raise_on(err, "block-sparse attention backward (src pass)")
    block_sparse_attention_bwd_src.launches += 1
    return dk, dv


def block_sparse_bank_grads(q, k, a_bank, b_bank, ge, plan):
    """B6b: (g_a, g_b) [P, H, Dh] in the bank type from B6d's ge
    [H, E_cap] and backward_plan's pair orders and work list; the kernel
    reads the list's counts on the card, its grid is fixed by the list's
    bounds, and it writes every row (0 where no pair references it). CPU
    tensors take the plain version, which walks the same plan. Same
    limits as B5."""
    if not _on_card(q):
        return block_sparse_bank_grads_reference(q, k, a_bank, b_bank, ge,
                                                 plan)
    B, H, N, Dh = q.shape
    P = a_bank.shape[0]
    E = plan["cap"]
    _check("q", q, (B, H, N, Dh), q.dtype, q.device)
    _check("k", k, (B, H, N, Dh), q.dtype, q.device)
    for name, t in (("a_bank", a_bank), ("b_bank", b_bank)):
        _check(name, t, (P, H, Dh), q.dtype, q.device)
    _check("ge", ge, (H, E), torch.float32, q.device)
    for name in ("pid", "qrow", "krow"):
        _check(name, plan[name], (E,), torch.int32, q.device)
    runs, n_chunks, n_multi, slots = work_bounds(E, P)
    work = [plan[name] for name in ("bank_chunks", "bank_shorts",
                                    "bank_multi")]
    for name, t, n in zip(("bank_chunks", "bank_shorts", "bank_multi"),
                          work, (n_chunks, runs, n_multi)):
        _check(name, t, (n, 4), torch.int32, q.device)
    _check("bank_counts", plan["bank_counts"], (4,), torch.int32, q.device)
    _check("bank_used", plan["bank_used"], (P,), torch.uint8, q.device)
    g_a, g_b = torch.empty_like(a_bank), torch.empty_like(b_bank)
    part = torch.empty(slots, H, 2 * Dh + 4, dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[2](
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), a_bank.data_ptr(),
            b_bank.data_ptr(), ge.data_ptr(), plan["pid"].data_ptr(),
            plan["qrow"].data_ptr(), plan["krow"].data_ptr(),
            work[0].data_ptr(), n_chunks, work[1].data_ptr(), runs,
            work[2].data_ptr(), n_multi, plan["bank_counts"].data_ptr(),
            plan["bank_used"].data_ptr(), part.data_ptr(), g_a.data_ptr(),
            g_b.data_ptr(), H, N, Dh, E, P, _stream(q))
    _raise_on(err, "block-sparse attention bank gradients")
    block_sparse_bank_grads.launches += 1
    return g_a, g_b


block_sparse_attention_bwd_dst.launches = 0
block_sparse_attention_bwd_src.launches = 0
block_sparse_bank_grads.launches = 0


def block_sparse_attention_bwd(q, k, v, a_bank, b_bank, tile_src, tile_rel,
                               tile_dst, tile_rel_src, out, m, l, g,
                               plan: Optional[Dict] = None, scale=None,
                               t4=None):
    """-> (dq, dk, dv [B, H, N, Dh] in the input types, g_a, g_b [P, H, Dh]
    in the bank type): B6d, B6s and B6b (looked up at call time, by name).
    out: the forward's output in v's type; m, l: its statistics (B5s); g:
    the output's cotangent; t4: bank_t4 (the forward's)."""
    from gtos_tpu_torch.ops import block_sparse_attention_bwd as mod
    scale = _default_scale(q, scale)
    t4 = bank_t4(a_bank, b_bank) if t4 is None else t4
    if plan is None:            # a call outside a step: E_cap read here
        plan = backward_plan(tile_src, tile_rel, tile_dst, tile_rel_src,
                             q.shape[2], a_bank.shape[0],
                             pair_capacity(tile_rel))
    gp, delta = prep_bwd_invariants(q, g, out)
    dq, ge, pair_s = mod.block_sparse_attention_bwd_dst(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_src, tile_rel,
        plan, scale)
    dk, dv = mod.block_sparse_attention_bwd_src(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_dst, tile_rel_src,
        plan, pair_s, scale)
    g_a, g_b = mod.block_sparse_bank_grads(q, k, a_bank, b_bank, ge, plan)
    return dq, dk, dv, g_a, g_b
