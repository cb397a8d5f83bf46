"""Block-sparse relation-aware attention: the forward over the tile layout
and the differentiable entries.

Port of gtos_tpu/ops/pallas/block_sparse_attention.py. The kept pairs of
each graph are the nonempty 128x128 (dst-tile, src-tile) blocks of the
tile layout (ops/block_sparse.py): for dst node i, each slot s of its tile
with src tile tile_src[b, i // 128, s] >= 0 keeps the pairs (i, j) whose
bank row r = tile_rel[b, i // 128, s, i % 128, j % 128] is >= 0. With the
banks a_bank/b_bank [P, H, Dh] and t4_r = a_r.b_r summed in f32 and
rounded to the bank type (as the TPU kernel folds it into a padding lane),

    e_ij  = scale * (q_i.k_j + q_i.b_r + t4_r + k_j.a_r)          (f32)
    out_i = sum_j softmax_j(e_ij) v_j, over the kept pairs of row i

with the probabilities rounded to v's type before the product with v, and
out_i = 0 for a row with no kept pair. A pair whose r is not a bank row or
whose j is not a node (>= N) counts as dropped, in the kernels and their
plain versions alike.

Two hand-written CUDA kernels, one source (built for sm_90a at first use,
csrc/block_sparse_attention_fwd.cu), each with a wrapper that launches it
for CUDA tensors, runs its plain torch version for CPU tensors and raises
for anything else, and counts its launches in `.launches`:

  B5  `block_sparse_attention`             the output;
  B5s `block_sparse_attention_with_stats`  the output and the softmax
      statistics m, l [B, H, N] f32 per dst node (m = -1e9 and l = 0 for a
      row with no kept pair), which the backward recomputes p from.

The plain versions work on the list of kept pairs (`tile_pairs`), never on
[B, H, N, P] tables. The differentiable entry
`block_sparse_relation_attention_trainable` is the JAX package's: with the
src-major layout (tile_dst, tile_rel_src) forward B5s and backward the
kernels of ops/block_sparse_attention_bwd.py (B6d, B6s, B6b); without it
forward B5 and backward autograd of the plain edge-list attention
(ops/sparse_relation.py) over the same pairs in COO form.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gtos_tpu_torch.ops import build
from gtos_tpu_torch.ops.block_sparse import TILE
from gtos_tpu_torch.ops.relation_attention import (
    _default_scale, _on_card, _raise_on, _stream,
)

NEG_INF = -1e9
FWD_SOURCE = "block_sparse_attention_fwd.cu"
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------- pairs


def tile_pairs(tiles, rels, N, P):
    """The kept pairs of a tile layout, in the order of its planes (graph,
    tile, slot, plane row, plane column): (b, own, other, r, valid), int64
    [E] each, and valid [B, Tn, S, T, T] bool, the kept positions. For the
    dst-major layout (tile_src, tile_rel) own is the dst node i and other
    the src node j; for the src-major one (tile_dst, tile_rel_src) own is j
    and other i. Pairs with r outside [0, P) or a node >= N are dropped."""
    B, Tn, S = tiles.shape
    t = rels.shape[-1]
    dev = rels.device
    own = torch.arange(Tn * t, device=dev).view(Tn, 1, t, 1)
    other = tiles.long()[..., None, None] * t + torch.arange(t, device=dev)
    valid = ((rels >= 0) & (rels < P) & (tiles >= 0)[..., None, None]
             & (other < N) & (own < N))
    b, tn, s, row, col = valid.nonzero(as_tuple=True)
    return (b, tn * t + row, tiles[b, tn, s].long() * t + col,
            rels[b, tn, s, row, col].long(), valid)


def tile_pairs_padded(tiles, rels, N, P, cap: int):
    """tile_pairs with shapes fixed by the layout's shape and `cap` and no
    read of the card: (b, own, other, r) int64 [cap] each, the kept pairs
    in the planes' order (tile_pairs' order) then `cap - E` padding slots
    holding (0, 0, 0, P); E, the kept pairs, an int64 0-dim tensor; and
    valid. Slot x takes the kept position whose inclusive count first
    exceeds x (a cumsum and a searchsorted, no nonzero). Pairs past `cap`
    are left out: a caller that cannot bound E checks E <= cap."""
    B, Tn, S = tiles.shape
    t = rels.shape[-1]
    dev = rels.device
    own = torch.arange(Tn * t, device=dev).view(Tn, 1, t, 1)
    other = tiles.long()[..., None, None] * t + torch.arange(t, device=dev)
    valid = ((rels >= 0) & (rels < P) & (tiles >= 0)[..., None, None]
             & (other < N) & (own < N))
    count = torch.cumsum(valid.flatten(), 0)
    E = count[-1] if count.numel() else count.new_zeros(())
    x = torch.arange(cap, device=dev)
    src = torch.searchsorted(count, x, right=True).clamp_max(
        max(count.numel() - 1, 0))
    live = x < E
    col = src % t
    row = src // t % t
    s = src // (t * t) % S
    tn = src // (t * t * S) % Tn
    b = src // (t * t * S * Tn)
    tile = tiles.flatten()[(b * Tn + tn) * S + s].long()
    zero = torch.zeros((), dtype=torch.long, device=dev)
    return (torch.where(live, b, zero), torch.where(live, tn * t + row, zero),
            torch.where(live, tile * t + col, zero),
            torch.where(live, rels.flatten()[src].long(), zero + P), E,
            valid)


def bank_t4(a_bank, b_bank):
    """t4 [P, H] f32: a_r.b_r summed in f32 and rounded to the bank type
    (the TPU kernel's t4 lane). Computed once per call by the wrappers (or
    once per forward and backward by the trainable entry) and handed to
    kernel and plain version alike."""
    return torch.einsum("phd,phd->ph", a_bank.float(), b_bank.float()).to(
        b_bank.dtype).float().contiguous()


def pair_logits(q, k, a_bank, b_bank, t4, bi, i, j, r, scale):
    """e_ij [E, H] f32 of the pairs (bi, i <- j, r): products summed in
    f32; t4 from bank_t4."""
    f32 = torch.float32
    qi, kj = q[bi, :, i].to(f32), k[bi, :, j].to(f32)      # [E, H, Dh]
    ar, br = a_bank[r].to(f32), b_bank[r].to(f32)
    return ((qi * kj).sum(-1) + (qi * br).sum(-1) + t4[r]
            + (kj * ar).sum(-1)) * scale


def _row_softmax_stats(e, rows, n_rows):
    """Per row (ids `rows` [E] into n_rows): m = max e (NEG_INF without a
    pair) and l = sum exp(e - m), [n_rows, H] f32; and p = exp(e - m)."""
    H = e.shape[1]
    ids = rows[:, None].expand(-1, H)
    m = torch.full((n_rows, H), -torch.inf, dtype=e.dtype,
                   device=e.device).scatter_reduce(0, ids, e, "amax")
    p = torch.exp(e - m[rows])
    l = torch.zeros(n_rows, H, dtype=e.dtype, device=e.device).index_add(
        0, rows, p)
    return torch.where(l > 0, m, NEG_INF), l, p


def block_sparse_attention_with_stats_reference(q, k, v, a_bank, b_bank,
                                                tile_src, tile_rel,
                                                scale=None, t4=None):
    """Plain version of B5s: (out [B, H, N, Dh] in v's type, m, l
    [B, H, N] f32)."""
    B, H, N, Dh = q.shape
    scale = _default_scale(q, scale)
    t4 = bank_t4(a_bank, b_bank) if t4 is None else t4
    bi, i, j, r, _ = tile_pairs(tile_src, tile_rel, N, a_bank.shape[0])
    e = pair_logits(q, k, a_bank, b_bank, t4, bi, i, j, r, scale)
    rows = bi * N + i
    m, l, p = _row_softmax_stats(e, rows, B * N)
    pv = p.to(v.dtype).float()[..., None] * v[bi, :, j].float()
    acc = torch.zeros(B * N, H, Dh, dtype=torch.float32,
                      device=q.device).index_add(0, rows, pv)
    out = torch.where(l[..., None] > 0,
                      acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
    out = out.view(B, N, H, Dh).transpose(1, 2).to(v.dtype).contiguous()
    return (out, m.view(B, N, H).transpose(1, 2).contiguous(),
            l.view(B, N, H).transpose(1, 2).contiguous())


def block_sparse_attention_reference(q, k, v, a_bank, b_bank, tile_src,
                                     tile_rel, scale=None, t4=None):
    """Plain version of B5: its arguments and result."""
    return block_sparse_attention_with_stats_reference(
        q, k, v, a_bank, b_bank, tile_src, tile_rel, scale, t4)[0]


# ---------------------------------------------------------------- checks


def check_layout(q, tile_src, tile_rel):
    """A tile layout made for another batch or node count would be read as
    other graphs' tiles: refused, as the JAX package refuses it."""
    B, H, N, Dh = q.shape
    Bt, Td, Smax = tile_src.shape
    if Bt != B or Td != (N + TILE - 1) // TILE:
        raise ValueError(
            f"tile layout {tuple(tile_src.shape)} inconsistent with q "
            f"{tuple(q.shape)}: expected [{B}, {(N + TILE - 1) // TILE}, "
            "Smax]")
    if tuple(tile_rel.shape) != (B, Td, Smax, TILE, TILE):
        raise ValueError(f"tile_rel shape {tuple(tile_rel.shape)} != "
                         f"{(B, Td, Smax, TILE, TILE)}")


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned")


def check_args(q, k, v, a_bank, b_bank, tiles, rels):
    """What the block-sparse kernels take: refused here, before a launch
    (rows are read 16 bytes at a time)."""
    B, H, N, Dh = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if Dh > MAX_HEAD_DIM or Dh % 8:
        raise ValueError(f"head dim {Dh}: the kernels take multiples of 8 "
                         f"up to {MAX_HEAD_DIM}")
    P = a_bank.shape[0]
    Tn, S = tiles.shape[1:]
    for name, t, shape, dtype in (
            ("q", q, (B, H, N, Dh), q.dtype), ("k", k, (B, H, N, Dh), q.dtype),
            ("v", v, (B, H, N, Dh), q.dtype),
            ("a_bank", a_bank, (P, H, Dh), q.dtype),
            ("b_bank", b_bank, (P, H, Dh), q.dtype),
            ("tiles", tiles, (B, Tn, S), torch.int32),
            ("rels", rels, (B, Tn, S, TILE, TILE), torch.int32)):
        _check(name, t, shape, dtype, q.device)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    """B5's (and B5s's) C entry point in the built library, with argument
    types."""
    return fwd_entries(build.load(FWD_SOURCE))[0]


def fwd_entries(lib):
    """(B5/B5s, variant) entry points of a library built from FWD_SOURCE,
    with argument types; variant(v) forces the bf16 variant v (-1: the
    kernel's own) and returns the number of variants, 0 unless the library
    was built with GTOS_B5_VARIANTS."""
    fn, variant = lib.gtos_blk_attn_fwd, lib.gtos_blk_attn_fwd_variant
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    variant.argtypes = [ctypes.c_int]
    fn.restype = variant.restype = ctypes.c_int
    return fn, variant


def _launch_fwd(q, k, v, a_bank, b_bank, tile_src, tile_rel, scale, t4,
                stats):
    check_layout(q, tile_src, tile_rel)
    check_args(q, k, v, a_bank, b_bank, tile_src, tile_rel)
    B, H, N, Dh = q.shape
    _check("t4", t4, (a_bank.shape[0], H), torch.float32, q.device)
    Td, Smax = tile_src.shape[1:]
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m, l = (torch.empty(B, H, N, dtype=torch.float32, device=q.device)
                for _ in range(2))
    with torch.cuda.device(q.device):
        err = _fwd_kernel()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            a_bank.data_ptr(), b_bank.data_ptr(), t4.data_ptr(),
            tile_src.data_ptr(), tile_rel.data_ptr(), out.data_ptr(),
            m.data_ptr() if stats else None, l.data_ptr() if stats else None,
            B, H, N, Dh, a_bank.shape[0], Td, Smax, float(scale), _stream(q))
    _raise_on(err, "block-sparse attention forward")
    return out, m, l


def block_sparse_attention(q, k, v, a_bank, b_bank, tile_src, tile_rel,
                           scale=None, t4=None):
    """B5, the block-sparse forward. q, k, v: [B, H, N, Dh]; a_bank,
    b_bank: [P, H, Dh] in q's type; tile_src [B, Td, Smax] and tile_rel
    [B, Td, Smax, 128, 128] int32 with Td = ceil(N / 128). Returns out
    [B, H, N, Dh] in v's type. t4: bank_t4(a_bank, b_bank), computed here
    when not given. CUDA tensors go through the kernel (float32 or
    bfloat16, contiguous, Dh a multiple of 8 up to 128; anything else
    raises); CPU tensors through the plain version."""
    scale = _default_scale(q, scale)
    t4 = bank_t4(a_bank, b_bank) if t4 is None else t4
    if not _on_card(q):
        check_layout(q, tile_src, tile_rel)
        return block_sparse_attention_reference(
            q, k, v, a_bank, b_bank, tile_src, tile_rel, scale, t4)
    out = _launch_fwd(q, k, v, a_bank, b_bank, tile_src, tile_rel, scale,
                      t4, False)[0]
    block_sparse_attention.launches += 1
    return out


def block_sparse_attention_with_stats(q, k, v, a_bank, b_bank, tile_src,
                                      tile_rel, scale=None, t4=None):
    """B5s: B5's arguments; returns (out, m, l [B, H, N] f32). Same limits
    as B5; its own `.launches`."""
    scale = _default_scale(q, scale)
    t4 = bank_t4(a_bank, b_bank) if t4 is None else t4
    if not _on_card(q):
        check_layout(q, tile_src, tile_rel)
        return block_sparse_attention_with_stats_reference(
            q, k, v, a_bank, b_bank, tile_src, tile_rel, scale, t4)
    out = _launch_fwd(q, k, v, a_bank, b_bank, tile_src, tile_rel, scale,
                      t4, True)
    block_sparse_attention_with_stats.launches += 1
    return out


block_sparse_attention.launches = 0
block_sparse_attention_with_stats.launches = 0


# ------------------------------------------------------- trainable entries


class _BlockSparseAttention(torch.autograd.Function):
    """Forward B5s, backward B6d, B6s and B6b (the wrappers looked up at
    call time, by name)."""

    @staticmethod
    def forward(ctx, q, k, v, a_bank, b_bank, tile_src, tile_rel, tile_dst,
                tile_rel_src, plan, scale):
        from gtos_tpu_torch.ops import block_sparse_attention as fwd
        t4 = bank_t4(a_bank, b_bank)
        out, m, l = fwd.block_sparse_attention_with_stats(
            q, k, v, a_bank, b_bank, tile_src, tile_rel, scale, t4)
        ctx.save_for_backward(q, k, v, a_bank, b_bank, tile_src, tile_rel,
                              tile_dst, tile_rel_src, out, m, l, t4)
        ctx.plan, ctx.scale = plan, scale
        return out

    @staticmethod
    def backward(ctx, g):
        from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
            block_sparse_attention_bwd)
        *saved, t4 = ctx.saved_tensors
        grads = block_sparse_attention_bwd(*saved, g, plan=ctx.plan,
                                           scale=ctx.scale, t4=t4)
        return (*grads, None, None, None, None, None, None)


class _BlockSparseAttentionEdgeBwd(torch.autograd.Function):
    """Forward B5, backward autograd of the plain edge-list attention over
    the same pairs in flat COO form (src, dst, rel, mask [B, E])."""

    @staticmethod
    def forward(ctx, q, k, v, a_bank, b_bank, tile_src, tile_rel, src, dst,
                rel, mask, scale):
        from gtos_tpu_torch.ops import block_sparse_attention as fwd
        out = fwd.block_sparse_attention(q, k, v, a_bank, b_bank, tile_src,
                                         tile_rel, scale)
        ctx.save_for_backward(q, k, v, a_bank, b_bank, src, dst, rel, mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        from gtos_tpu_torch.ops.sparse_relation import (
            sparse_relation_attention)
        q, k, v, a_bank, b_bank, src, dst, rel, mask = ctx.saved_tensors
        leaves = [x.detach().requires_grad_()
                  for x in (q, k, v, a_bank, b_bank)]
        with torch.enable_grad():
            out = sparse_relation_attention(*leaves, src, dst, rel, mask,
                                            scale=ctx.scale)
            grads = torch.autograd.grad(out, leaves, g.float())
        return (*grads, None, None, None, None, None, None, None)


def block_sparse_relation_attention_trainable(
        q, k, v, a_bank, b_bank, tile_src, tile_rel, src=None, dst=None,
        rel=None, mask=None, tile_dst=None, tile_rel_src=None, plan=None,
        scale=None):
    """Differentiable block-sparse attention: B5's result, with gradients to
    q, k, v, a_bank and b_bank. With the src-major layout (tile_dst,
    tile_rel_src): forward B5s, backward B6d/B6s/B6b (`plan`: the
    backward's pair orders, ops/block_sparse_attention_bwd.backward_plan,
    built in the backward when not given). Otherwise: forward B5, backward
    autograd of sparse_relation_attention over the flat COO edges
    (src, dst, rel, mask [B, E]) of the same pair set."""
    scale = _default_scale(q, scale)
    if tile_dst is not None:
        return _BlockSparseAttention.apply(
            q, k, v, a_bank, b_bank, tile_src, tile_rel, tile_dst,
            tile_rel_src, plan, scale)
    if src is None:
        raise ValueError(
            "need either (tile_dst, tile_rel_src) for the kernel backward or "
            "the flat COO (src, dst, rel, mask) for the edge-list backward")
    return _BlockSparseAttentionEdgeBwd.apply(
        q, k, v, a_bank, b_bank, tile_src, tile_rel, src, dst, rel, mask,
        scale)
