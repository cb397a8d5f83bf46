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
batch only, so the encoder stack builds it once for all its layers.
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
    tile_pairs,
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


def backward_plan(tile_src, tile_rel, tile_dst, tile_rel_src, N: int,
                  P: int) -> Dict:
    """The pair orders of the backward for one batch (torch, on the
    layouts' device): `row_base` [B, Td, Smax, 128] int32, the id of each
    plane row's first kept pair, pair ids running in the dst-major planes'
    order; `E`, the number of kept pairs; `src_row_base` [B, Ts, Smax_s,
    128] int32, the same over the src-major planes, whose order gives each
    pair its src-major place, and `dst2src` [E] int32, the src-major place
    of each pair id; in bank-row order (stable) `pid`, `qrow` (b*N + i)
    and `krow` (b*N + j) [E] int32; B6b's work list over that order
    (`bank_work`: `bank_chunks`, `bank_shorts`, `bank_multi` int32 [n, 4],
    and `bank_slots`, the workspace slots) and `bank_used` [P] uint8, 1 for
    a bank row some pair references; `pairs`, (b, i, j, r) int64 in
    pair-id order, for the plain versions. Raises ValueError when the two
    layouts do not hold the same pairs."""
    bi, i, j, r, valid = tile_pairs(tile_src, tile_rel, N, P)
    sb, sj, si, sr, svalid = tile_pairs(tile_dst, tile_rel_src, N, P)
    key = (bi * N + i) * N + j
    skey = (sb * N + si) * N + sj
    sorted_skey, by_key = torch.sort(skey)
    at = torch.searchsorted(sorted_skey, key).clamp_max(max(len(skey) - 1, 0))
    if len(skey) != len(key) or not bool(
            (sorted_skey[at] == key).all() and (sr[by_key[at]] == r).all()):
        raise ValueError("the src-major tile layout does not hold the "
                         "dst-major layout's pairs")
    order = torch.argsort(r, stable=True)
    run_r, run_len = torch.unique_consecutive(r[order], return_counts=True)
    # one copy to the host, where the work list is cut
    work = bank_work(*torch.stack([run_r, run_len]).cpu().numpy())
    chunks, shorts, multi = (torch.from_numpy(x).to(r.device) for x in work)
    i32 = torch.int32
    return dict(row_base=_row_base(valid), E=int(r.numel()),
                src_row_base=_row_base(svalid), dst2src=by_key[at].to(i32),
                pid=order.to(i32), qrow=(bi * N + i)[order].to(i32),
                krow=(bi * N + j)[order].to(i32), bank_chunks=chunks,
                bank_shorts=shorts, bank_multi=multi,
                bank_slots=int(work[2][:, 1].sum()),
                bank_used=torch.zeros(P, dtype=torch.uint8,
                                      device=r.device).index_fill_(0, run_r, 1),
                pairs=(bi, i, j, r))


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


def block_sparse_bank_grads_reference(q, k, a_bank, b_bank, ge, pairs):
    """Plain version of B6b: (g_a, g_b) [P, H, Dh] in the bank type, from
    ge [H, E] and the pairs (b, i, j, r) of B6d's order."""
    bi, i, j, r = pairs
    P, H, Dh = a_bank.shape
    geq = ge.T.to(q.dtype).float()                          # [E, H]
    f32 = torch.float32
    zero = lambda: torch.zeros(P, H, Dh, dtype=f32, device=q.device)  # noqa
    dt4 = torch.zeros(P, H, dtype=f32, device=q.device).index_add(0, r, geq)
    g_a = zero().index_add(0, r, geq[..., None] * k[bi, :, j].float())
    g_b = zero().index_add(0, r, geq[..., None] * q[bi, :, i].float())
    g_a += dt4[..., None] * b_bank.float()
    g_b += dt4[..., None] * a_bank.float()
    return g_a.to(a_bank.dtype), g_b.to(b_bank.dtype)


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
                     + [ptr] * 4 + [i32] * 5 + [ptr])
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
    """The plan's row bases for this layout and its pair count."""
    if plan is None or key not in plan:
        raise ValueError("the block-sparse backward kernels need "
                         "backward_plan(tile_src, tile_rel, tile_dst, "
                         "tile_rel_src, N, P)")
    B, Tn, Smax = tiles.shape
    _check(key, plan[key], (B, Tn, Smax, 128), torch.int32, q.device)
    return plan["E"]


def block_sparse_attention_bwd_dst(q, k, v, a_bank, b_bank, t4, gp, m, l,
                                   delta, tile_src, tile_rel, plan=None,
                                   scale=None):
    """B6d: (dq [B, H, N, Dh] in q's type, ge [H, E] f32, pair_s [H, E, 2]
    f32: each pair's ge and p at its src-major place, for B6s; None for
    CPU tensors, whose B6s recomputes them). t4: bank_t4; gp: the
    cotangent in q's type; m, l: B5s's statistics; delta [B, H, N] f32
    (prep_bwd_invariants); plan: backward_plan (on the card; the CPU's
    plain version needs none). Same limits as B5."""
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
    E = _check_plan(plan, q, tile_src, "row_base")
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
    E = _check_plan(plan, q, tile_dst, "src_row_base")
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
    """B6b: (g_a, g_b) [P, H, Dh] in the bank type from B6d's ge [H, E] and
    backward_plan's pair orders and work list; the kernel writes every row
    (0 where no pair references it). Same limits as B5."""
    if not _on_card(q):
        return block_sparse_bank_grads_reference(q, k, a_bank, b_bank, ge,
                                                 plan["pairs"])
    B, H, N, Dh = q.shape
    P = a_bank.shape[0]
    E = plan["E"]
    _check("q", q, (B, H, N, Dh), q.dtype, q.device)
    _check("k", k, (B, H, N, Dh), q.dtype, q.device)
    for name, t in (("a_bank", a_bank), ("b_bank", b_bank)):
        _check(name, t, (P, H, Dh), q.dtype, q.device)
    _check("ge", ge, (H, E), torch.float32, q.device)
    for name in ("pid", "qrow", "krow"):
        _check(name, plan[name], (E,), torch.int32, q.device)
    work = [plan[name] for name in ("bank_chunks", "bank_shorts",
                                    "bank_multi")]
    for name, t in zip(("bank_chunks", "bank_shorts", "bank_multi"), work):
        _check(name, t, (len(t), 4), torch.int32, q.device)
    _check("bank_used", plan["bank_used"], (P,), torch.uint8, q.device)
    g_a, g_b = torch.empty_like(a_bank), torch.empty_like(b_bank)
    slots = plan["bank_slots"]
    part = (torch.empty(slots, H, 2 * Dh + 4, dtype=torch.float32,
                        device=q.device) if slots else None)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[2](
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), a_bank.data_ptr(),
            b_bank.data_ptr(), ge.data_ptr(), plan["pid"].data_ptr(),
            plan["qrow"].data_ptr(), plan["krow"].data_ptr(),
            work[0].data_ptr(), len(work[0]), work[1].data_ptr(),
            len(work[1]), work[2].data_ptr(), len(work[2]),
            plan["bank_used"].data_ptr(),
            part.data_ptr() if slots else None, g_a.data_ptr(),
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
    if plan is None:
        plan = backward_plan(tile_src, tile_rel, tile_dst, tile_rel_src,
                             q.shape[2], a_bank.shape[0])
    gp, delta = prep_bwd_invariants(q, g, out)
    dq, ge, pair_s = mod.block_sparse_attention_bwd_dst(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_src, tile_rel,
        plan, scale)
    dk, dv = mod.block_sparse_attention_bwd_src(
        q, k, v, a_bank, b_bank, t4, gp, m, l, delta, tile_dst, tile_rel_src,
        plan, pair_s, scale)
    g_a, g_b = mod.block_sparse_bank_grads(q, k, a_bank, b_bank, ge, plan)
    return dq, dk, dv, g_a, g_b
