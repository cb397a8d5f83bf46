"""Localized relation-aware graph attention: forward, and its backward.

Port of gtos_tpu/ops/pallas/local_relation_attention.py. Each graph b
carries its own local relation bank (batchify build_local_banks=True):
per-head rows a_loc/b_loc [B, P_loc, H, Dh] and the pair -> slot matrix
rel_index_loc [B, N, N]. For r = slot(i, j)

    e_ij = scale * (q_i.k_j + q_i.b_r + a_r.k_j + a_r.b_r) + mask_add_j
    out_i = sum_j softmax_j(e_ij) v_j

with mask_add_j = -1e9 at padded keys (so a padded query row comes out
uniform, never NaN), scores and softmax in f32 and the probabilities
rounded to the input type before the product with v.

Three hand-written CUDA kernels (built for sm_90a at first use), each with
a wrapper that launches it for CUDA tensors, runs its plain torch version
for CPU tensors and raises for anything else:

  B1  `local_relation_attention`             forward (serving),
      csrc/local_relation_attention_fwd.cu;
  B1p `local_relation_attention_with_probs`  the same kernel, also writing
      the f32 probabilities [B, H, N, N] (the forward of a training step);
  B2  `local_relation_attention_bwd`         the backward from those probs,
      csrc/local_relation_attention_bwd.cu (three launches, one count: a
      row pass that also zeroes the empty slots' bank rows; the column
      blocks and the long runs' chunks; the long runs' chunk sums and the
      short runs, from `bank_runs`' work list).

Each is a block per (graph, node) whose head warps share one read of the
node's slots and of each all-heads bank row, 8 lanes a pair. The banks
a_loc/b_loc may be strided views: rows of [H, Dh] contiguous values, any
row stride (the layer hands the two halves of its [B, P_loc, 2 H Dh]
projection `ab`, `split_banks`, without a copy), and B2 writes g_a_loc and
g_b_loc as the two halves of one [B, P_loc, 2 H Dh] tensor.

`local_relation_attention_trainable` is the differentiable entry: a
torch.autograd.Function of q, k, v and `ab`, whose forward is B1p and whose
backward is B2, returning the gradient of `ab` as that one tensor. The
cotangent enters B2 in f32 and the saved probabilities are f32, as the JAX
package's custom VJP has them. Each wrapper counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import types

import torch

from gtos_tpu_torch.ops import build

NEG_INF = -1e9
FWD_SOURCE = "local_relation_attention_fwd.cu"
BWD_SOURCE = "local_relation_attention_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)
MAX_NODES = 128   # node bucket limit of the kernels (and of the TPU kernel)
MAX_HEAD_DIM = 128
# B2's bank pass: a slot's run of at most SHORT_RUN pairs is one lane
# group's work; a longer one is cut into RUN_CHUNK-pair chunks, a block
# each (the kernel's kShortRun and kChunk)
SHORT_RUN, RUN_CHUNK = 8, 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _default_scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def local_relation_attention_with_probs_reference(
        q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale=None):
    """Plain version of B1p: gather the local banks per pair, four-term
    score, mask, f32 softmax, then the product with v. Returns (out in q's
    dtype, probs [B, H, N, N] f32 before rounding)."""
    B, H, N, Dh = q.shape
    scale = _default_scale(q, scale)
    f32 = torch.float32
    bidx = torch.arange(B, device=q.device)[:, None, None]
    idx = rel_index_loc.long()
    a_pair = a_loc[bidx, idx].to(f32)                    # [B, N, N, H, Dh]
    b_pair = b_loc[bidx, idx].to(f32)
    qf = q.to(f32).transpose(1, 2)                       # [B, N, H, Dh]
    kf = k.to(f32).transpose(1, 2)
    e = (torch.einsum("bihd,bjhd->bhij", qf, kf)
         + torch.einsum("bihd,bijhd->bhij", qf, b_pair)
         + torch.einsum("bijhd,bjhd->bhij", a_pair, kf)
         + (a_pair * b_pair).sum(-1).permute(0, 3, 1, 2))
    mask_add = torch.where(node_mask.bool(), 0.0, NEG_INF)
    probs = torch.softmax(e * scale + mask_add[:, None, None, :], dim=-1)
    attn = probs.to(v.dtype)
    return torch.matmul(attn.to(f32), v.to(f32)).to(v.dtype), probs


def local_relation_attention_reference(q, k, v, a_loc, b_loc, rel_index_loc,
                                       node_mask, scale=None):
    """Plain version of B1: `local_relation_attention`'s arguments and
    result."""
    return local_relation_attention_with_probs_reference(
        q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale)[0]


def local_relation_attention_bwd_reference(q, k, v, g, probs, a_loc, b_loc,
                                           rel_index_loc, scale=None):
    """Plain version of B2: the gradients of the localized attention from
    the forward's f32 probabilities and the output's cotangent g, all in
    f32: gv = p^T g; ge = scale * p * (g v^T - rowsum(p * g v^T)); per pair
    the terms ge_ij (k_j + b_r) (to gq_i and g_a[r]) and ge_ij (q_i + a_r)
    (to gk_j and g_b[r]). Returns (gq, gk, gv, g_a_loc, g_b_loc) in the
    types of q, k, v, a_loc, b_loc."""
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    scale = _default_scale(q, scale)
    f32 = torch.float32
    bidx = torch.arange(B, device=q.device)[:, None, None]
    idx = rel_index_loc.long()
    a_pair = a_loc[bidx, idx].to(f32)                    # [B, N, N, H, Dh]
    b_pair = b_loc[bidx, idx].to(f32)
    qf, kf, vf = (x.to(f32) for x in (q, k, v))
    g = g.to(f32)
    gv = torch.einsum("bhij,bhid->bhjd", probs, g)
    g_attn = torch.einsum("bhid,bhjd->bhij", g, vf)
    ge = scale * probs * (g_attn - (g_attn * probs).sum(-1, keepdim=True))
    ge_pair = ge.permute(0, 2, 3, 1)[..., None]          # [B, N, N, H, 1]
    to_a = ge_pair * (kf.transpose(1, 2)[:, None] + b_pair)  # gq_i, g_a[r]
    to_b = ge_pair * (qf.transpose(1, 2)[:, :, None] + a_pair)  # gk_j, g_b
    gq = to_a.sum(2).transpose(1, 2)
    gk = to_b.sum(1).transpose(1, 2)
    slot = (bidx * P_loc + idx).reshape(-1)

    def bank_grad(terms):
        out = torch.zeros(B * P_loc, H, Dh, dtype=f32, device=q.device)
        return out.index_add_(0, slot, terms.reshape(-1, H, Dh)).reshape(
            B, P_loc, H, Dh)

    return (gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype),
            bank_grad(to_a).to(a_loc.dtype), bank_grad(to_b).to(b_loc.dtype))


def split_banks(ab, heads: int):
    """(a_loc, b_loc) [B, P_loc, H, Dh]: the two halves of the per-graph
    bank projection ab [B, P_loc, 2 H Dh], as views (no copy)."""
    D = ab.shape[-1] // 2
    shape = (*ab.shape[:-1], heads, D // heads)
    return ab[..., :D].reshape(shape), ab[..., D:].reshape(shape)


def joined_bank_grads(g_a, g_b):
    """The [B, P_loc, 2 H Dh] gradient of `ab` whose halves are g_a and g_b
    [B, P_loc, H, Dh]: a view of B2's output, whose two halves are one
    tensor's, else a copy."""
    B, P, H, Dh = g_a.shape
    D = H * Dh
    strides = (P * 2 * D, 2 * D, Dh, 1)
    if (g_a.dtype == g_b.dtype and g_a.device == g_b.device
            and g_a.stride() == g_b.stride() == strides
            and g_b.data_ptr() == g_a.data_ptr() + D * g_a.element_size()):
        return g_a.as_strided((B, P, 2 * D), (P * 2 * D, 2 * D, 1))
    return torch.cat((g_a.reshape(B, P, D), g_b.reshape(B, P, D)), -1)


def slot_order(rel_index_loc, P_loc: int):
    """B2's walk order over each graph's pairs, from the local slot matrix
    [B, N, N]: (pair_order [B, N*N] int32, the flat pair i*N+j sorted by
    slot, stable; slot_start [B, P_loc + 1] int32, where each slot's run
    begins, the last entry N*N). The counterpart of the JAX package's
    device_sort_bnd; head- and layer-invariant, so built once per encoder
    stack."""
    B, N, _ = rel_index_loc.shape
    flat = rel_index_loc.reshape(B, N * N)
    order = torch.argsort(flat, dim=1, stable=True)
    slots = torch.arange(P_loc + 1, dtype=flat.dtype, device=flat.device)
    start = torch.searchsorted(torch.gather(flat, 1, order),
                               slots.expand(B, P_loc + 1).contiguous(),
                               out_int32=True)
    return order.to(torch.int32), start


def max_run_chunks(N: int) -> int:
    """The most chunks `bank_runs` lists for one graph of node bucket N: a
    run of L > SHORT_RUN pairs has ceil(L / RUN_CHUNK) <= L / (SHORT_RUN +
    1) of them, and a graph has N*N pairs (the kernel's cmax)."""
    return -(-N * N // (SHORT_RUN + 1))


def bank_runs(slot_start, N: int):
    """B2's work list over the slots' runs, from `slot_order`'s slot_start
    [B, P_loc + 1]: int32 [B, 1 + max_run_chunks(N) + P_loc, 4], per graph
    entry 0 (its number of chunks, its number of short runs, 0, 0); then
    max_run_chunks(N) entries, the runs of more than SHORT_RUN pairs cut
    into RUN_CHUNK-pair chunks (first place in pair_order, pairs, slot,
    chunk of its run), by slot and in order within a run, then zeros; then
    P_loc entries, the other non-empty runs whole (first place, pairs,
    slot, 0), longest first (stable), then zeros. Built on the slot starts'
    device with no copy to the host; head- and layer-invariant, so built
    once per encoder stack."""
    B, P = slot_start.shape[0], slot_start.shape[1] - 1
    start = slot_start.long()
    length = start[:, 1:] - start[:, :-1]
    chunks = torch.where(length > SHORT_RUN,
                         (length + RUN_CHUNK - 1) // RUN_CHUNK, 0)
    ends = torch.cumsum(chunks, 1)
    x = torch.arange(max_run_chunks(N), device=start.device).expand(
        B, -1).contiguous()
    slot = torch.searchsorted(ends, x, right=True).clamp_max(P - 1)
    k = x - ends.gather(1, slot) + chunks.gather(1, slot)
    first = start.gather(1, slot) + k * RUN_CHUNK
    pairs = (length.gather(1, slot) - k * RUN_CHUNK).clamp_max(RUN_CHUNK)
    pieces = torch.stack([first, pairs, slot, k], -1) * (
        x < ends[:, -1:])[..., None]
    short = (length > 0) & (length <= SHORT_RUN)
    order = torch.argsort(torch.where(short, SHORT_RUN - length,
                                      SHORT_RUN), dim=1, stable=True)
    runs = torch.stack([start.gather(1, order), length.gather(1, order),
                        order, torch.zeros_like(order)], -1) * short.gather(
        1, order)[..., None]
    count = torch.zeros(B, 1, 4, dtype=runs.dtype, device=runs.device)
    count[:, 0, 0] = ends[:, -1]
    count[:, 0, 1] = short.sum(1)
    return torch.cat([count, pieces, runs], 1).to(torch.int32)


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bank_row_stride(t):
    """Elements between two rows of a bank [B, P_loc, H, Dh] whose rows are
    H*Dh contiguous values and whose graphs lie P_loc rows apart (a
    contiguous bank, or a half of `ab` from split_banks); None for any other
    layout."""
    B, P, H, Dh = t.shape
    s0, s1, s2, s3 = t.stride()
    row = s1 if P > 1 else (s0 if B > 1 else H * Dh)
    if ((Dh > 1 and s3 != 1) or (H > 1 and s2 != Dh) or row < H * Dh
            or (B > 1 and s0 != P * row)):
        return None
    return row


def _check_banks(a_loc, b_loc, shape, dtype, device):
    """The banks as the kernels take them: of `shape`, `dtype` and
    `device`, rows of contiguous [H, Dh] values, one row stride for both;
    returns it."""
    for name, t in (("a_loc", a_loc), ("b_loc", b_loc)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, q on {device}")
    row = bank_row_stride(a_loc)
    if row is None or row != bank_row_stride(b_loc):
        raise ValueError("a_loc and b_loc must be [B, P_loc, H, Dh] banks of "
                         "contiguous rows with one row stride, got strides "
                         f"{a_loc.stride()} and {b_loc.stride()}")
    return row


def _check_sizes(q):
    B, H, N, Dh = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if N > MAX_NODES:
        raise ValueError(f"node bucket {N} > {MAX_NODES}: the localized "
                         "kernels are for node buckets <= 128")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {MAX_HEAD_DIM}")


def _check_cuda_args(q, k, v, a_loc, b_loc, rel_index_loc, node_mask):
    """What B1/B1p take: refused here, before a launch. Returns the banks'
    row stride."""
    _check_sizes(q)
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    for name, t, shape, dtype in (
            ("q", q, (B, H, N, Dh), q.dtype), ("k", k, (B, H, N, Dh), q.dtype),
            ("v", v, (B, H, N, Dh), q.dtype),
            ("rel_index_loc", rel_index_loc, (B, N, N), torch.int32),
            ("node_mask", node_mask, (B, N), torch.bool)):
        _check(name, t, shape, dtype, q.device)
    return _check_banks(a_loc, b_loc, (B, P_loc, H, Dh), q.dtype, q.device)


def _check_bwd_args(q, k, v, g, probs, a_loc, b_loc, rel_index_loc,
                    pair_order, slot_start, runs=None):
    """What B2 takes: refused here, before a launch. Returns the banks'
    row stride."""
    _check_sizes(q)
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    for name, t, shape, dtype in (
            ("q", q, (B, H, N, Dh), q.dtype), ("k", k, (B, H, N, Dh), q.dtype),
            ("v", v, (B, H, N, Dh), q.dtype),
            ("g", g, (B, H, N, Dh), torch.float32),
            ("probs", probs, (B, H, N, N), torch.float32),
            ("rel_index_loc", rel_index_loc, (B, N, N), torch.int32),
            ("pair_order", pair_order, (B, N * N), torch.int32),
            ("slot_start", slot_start, (B, P_loc + 1), torch.int32)):
        _check(name, t, shape, dtype, q.device)
    if runs is not None:
        _check("runs", runs, (B, 1 + max_run_chunks(N) + P_loc, 4),
               torch.int32, q.device)
    return _check_banks(a_loc, b_loc, (B, P_loc, H, Dh), q.dtype, q.device)


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    """B1/B1p's C entry point in the built library, with argument types."""
    fn = build.load(FWD_SOURCE).gtos_local_rel_attn_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """B2's C entry point in the built library, with argument types."""
    fn = build.load(BWD_SOURCE).gtos_local_rel_attn_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 11
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel: CUDA error {err} at launch")


def _launch_fwd(q, k, v, a_loc, b_loc, row_stride, rel_index_loc, node_mask,
                scale, with_probs):
    B, H, N, Dh = q.shape
    out = torch.empty_like(q)
    probs = (torch.empty(B, H, N, N, dtype=torch.float32, device=q.device)
             if with_probs else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fwd_kernel()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            a_loc.data_ptr(), b_loc.data_ptr(), row_stride,
            rel_index_loc.data_ptr(), node_mask.data_ptr(), out.data_ptr(),
            probs.data_ptr() if with_probs else None, B, H, N, Dh,
            a_loc.shape[1], float(scale), stream)
    _raise_on(err, "local relation attention forward")
    return out, probs


def _on_card(q):
    """True for a CUDA tensor, False for a CPU one (plain version)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return q.device.type == "cuda"


def local_relation_attention(q, k, v, a_loc, b_loc, rel_index_loc,
                             node_mask, scale=None):
    """B1, forward-only localized fused attention.

    q, k, v: [B, H, N, Dh]; a_loc/b_loc: [B, P_loc, H, Dh] (per-graph
    localized banks); rel_index_loc: [B, N, N] int32 local slots;
    node_mask: [B, N] bool. Returns out [B, H, N, Dh] in q's dtype.
    CUDA tensors go through the kernel (float32 or bfloat16, q/k/v
    contiguous, the banks rows of contiguous [H, Dh] values with one row
    stride, as `split_banks` gives them; N <= 128, Dh <= 128; anything else
    raises); CPU tensors through the plain version.
    `local_relation_attention.launches` counts launches."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return local_relation_attention_reference(
            q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale)
    row = _check_cuda_args(q, k, v, a_loc, b_loc, rel_index_loc, node_mask)
    out, _ = _launch_fwd(q, k, v, a_loc, b_loc, row, rel_index_loc,
                         node_mask, scale, with_probs=False)
    local_relation_attention.launches += 1
    return out


def local_relation_attention_with_probs(q, k, v, a_loc, b_loc,
                                        rel_index_loc, node_mask,
                                        scale=None):
    """B1p: B1 that also returns the f32 probabilities [B, H, N, N] (before
    their rounding to the input type), for B2. Same arguments and checks as
    `local_relation_attention`; its own `.launches`."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return local_relation_attention_with_probs_reference(
            q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale)
    row = _check_cuda_args(q, k, v, a_loc, b_loc, rel_index_loc, node_mask)
    out, probs = _launch_fwd(q, k, v, a_loc, b_loc, row, rel_index_loc,
                             node_mask, scale, with_probs=True)
    local_relation_attention_with_probs.launches += 1
    return out, probs


def local_relation_attention_bwd(q, k, v, g, probs, a_loc, b_loc,
                                 rel_index_loc, pair_order=None,
                                 slot_start=None, scale=None, runs=None):
    """B2: (gq, gk, gv, g_a_loc, g_b_loc) in the input type from the
    forward's f32 probs [B, H, N, N] and the f32 cotangent g [B, H, N, Dh].
    pair_order/slot_start: `slot_order(rel_index_loc, P_loc)`, runs:
    `bank_runs(slot_start, N)`, built here when not given (the CPU's
    plain version needs none). On the card g_a_loc and g_b_loc are the two
    halves of one [B, P_loc, 2 H Dh] tensor (`joined_bank_grads` hands it
    back without a copy). Same limits as B1; `.launches` counts calls (three
    kernel launches each)."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return local_relation_attention_bwd_reference(
            q, k, v, g, probs, a_loc, b_loc, rel_index_loc, scale)
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    if pair_order is None or slot_start is None:
        pair_order, slot_start = slot_order(rel_index_loc, P_loc)
    if runs is None:
        runs = bank_runs(slot_start, N)
    row = _check_bwd_args(q, k, v, g, probs, a_loc, b_loc, rel_index_loc,
                          pair_order, slot_start, runs)
    gq, gk, gv = (torch.empty_like(q) for _ in range(3))
    g_ab = torch.empty(B, P_loc, 2, H, Dh, dtype=q.dtype, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    gep = torch.empty(B, N, N, H, 2, **f32)
    part = torch.empty(B, max_run_chunks(N), H, 2 * Dh + 4, **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), probs.data_ptr(), a_loc.data_ptr(),
            b_loc.data_ptr(), row, rel_index_loc.data_ptr(),
            pair_order.data_ptr(), slot_start.data_ptr(), runs.data_ptr(),
            gep.data_ptr(), part.data_ptr(), gq.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), g_ab[:, :, 0].data_ptr(),
            g_ab[:, :, 1].data_ptr(), 2 * H * Dh, B, H, N, Dh, P_loc,
            float(scale), stream)
    _raise_on(err, "local relation attention backward")
    local_relation_attention_bwd.launches += 1
    return gq, gk, gv, g_ab[:, :, 0], g_ab[:, :, 1]


local_relation_attention.launches = 0
local_relation_attention_with_probs.launches = 0
local_relation_attention_bwd.launches = 0


class _LocalRelationAttention(torch.autograd.Function):
    """Forward B1p, backward B2 (looked up at call time, by name), over the
    two halves of `ab`."""

    @staticmethod
    def forward(ctx, q, k, v, ab, rel_index_loc, node_mask, pair_order,
                slot_start, runs, scale):
        a_loc, b_loc = split_banks(ab, q.shape[1])
        out, probs = local_relation_attention_with_probs(
            q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale)
        ctx.save_for_backward(q, k, v, ab, rel_index_loc, probs)
        ctx.walk = pair_order, slot_start, runs
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, ab, idx, probs = ctx.saved_tensors
        pair_order, slot_start, runs = ctx.walk
        gq, gk, gv, g_a, g_b = local_relation_attention_bwd(
            q, k, v, g.float().contiguous(), probs,
            *split_banks(ab, q.shape[1]), idx, pair_order, slot_start,
            ctx.scale, runs=runs)
        return (gq, gk, gv, joined_bank_grads(g_a, g_b), None, None, None,
                None, None, None)


def local_relation_attention_trainable(q, k, v, ab, rel_index_loc,
                                       node_mask, pair_order=None,
                                       slot_start=None, runs=None,
                                       scale=None):
    """Differentiable localized attention over the per-graph bank
    projection ab [B, P_loc, 2 H Dh] (a_loc = its first half, b_loc its
    second, per head; `split_banks`): `local_relation_attention`'s result,
    with gradients to q, k, v and ab, the last one [B, P_loc, 2 H Dh]
    tensor. Forward B1p, backward B2 (their plain versions for CPU
    tensors). pair_order/slot_start: `slot_order(...)`, runs:
    `bank_runs(...)`, when the caller has them."""
    return _LocalRelationAttention.apply(
        q, k, v, ab, rel_index_loc, node_mask, pair_order, slot_start, runs,
        _default_scale(q, scale))


class _CallableModule(types.ModuleType):
    """This module, callable as its `local_relation_attention`: the JAX
    package exports that function under the module's own name
    (gtos_tpu.ops.pallas.local_relation_attention, ops/__init__.py), and
    the port imports this module by that name. The function is looked up
    at call time, as the model looks up every wrapper."""

    def __call__(self, *args, **kw):
        return self.local_relation_attention(*args, **kw)


sys.modules[__name__].__class__ = _CallableModule
