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
      csrc/local_relation_attention_bwd.cu.

`local_relation_attention_trainable` is the differentiable entry: a
torch.autograd.Function whose forward is B1p and whose backward is B2. The
cotangent enters B2 in f32 and the saved probabilities are f32, as the JAX
package's custom VJP has them. Each wrapper counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gtos_tpu_torch.ops import build

NEG_INF = -1e9
FWD_SOURCE = "local_relation_attention_fwd.cu"
BWD_SOURCE = "local_relation_attention_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)
MAX_NODES = 128   # node bucket limit of the kernels (and of the TPU kernel)
MAX_HEAD_DIM = 128
# B2 stages ge [N, N], k and v^T (then q) [N, Dh] in f32 in shared memory;
# the kernel's static shared memory takes the rest of the card's 227 KB
MAX_BWD_SMEM = 232448 - 20 * 1024
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


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    """What B1/B1p take: refused here, before a launch."""
    _check_sizes(q)
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    for name, t, shape, dtype in (
            ("q", q, (B, H, N, Dh), q.dtype), ("k", k, (B, H, N, Dh), q.dtype),
            ("v", v, (B, H, N, Dh), q.dtype),
            ("a_loc", a_loc, (B, P_loc, H, Dh), q.dtype),
            ("b_loc", b_loc, (B, P_loc, H, Dh), q.dtype),
            ("rel_index_loc", rel_index_loc, (B, N, N), torch.int32),
            ("node_mask", node_mask, (B, N), torch.bool)):
        _check(name, t, shape, dtype, q.device)


def _check_bwd_args(q, k, v, g, probs, a_loc, b_loc, rel_index_loc,
                    pair_order, slot_start):
    """What B2 takes: refused here, before a launch."""
    _check_sizes(q)
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    for name, t, shape, dtype in (
            ("q", q, (B, H, N, Dh), q.dtype), ("k", k, (B, H, N, Dh), q.dtype),
            ("v", v, (B, H, N, Dh), q.dtype),
            ("g", g, (B, H, N, Dh), torch.float32),
            ("probs", probs, (B, H, N, N), torch.float32),
            ("a_loc", a_loc, (B, P_loc, H, Dh), q.dtype),
            ("b_loc", b_loc, (B, P_loc, H, Dh), q.dtype),
            ("rel_index_loc", rel_index_loc, (B, N, N), torch.int32),
            ("pair_order", pair_order, (B, N * N), torch.int32),
            ("slot_start", slot_start, (B, P_loc + 1), torch.int32)):
        _check(name, t, shape, dtype, q.device)
    smem = (N * N + 2 * N * Dh) * 4
    if smem > MAX_BWD_SMEM:
        raise ValueError(f"N={N}, Dh={Dh}: the backward's {smem} bytes of "
                         f"shared memory exceed {MAX_BWD_SMEM}")


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    """B1/B1p's C entry point in the built library, with argument types."""
    fn = build.load(FWD_SOURCE).gtos_local_rel_attn_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """B2's C entry point in the built library, with argument types."""
    fn = build.load(BWD_SOURCE).gtos_local_rel_attn_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel: CUDA error {err} at launch")


def _launch_fwd(q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale,
                with_probs):
    B, H, N, Dh = q.shape
    out = torch.empty_like(q)
    probs = (torch.empty(B, H, N, N, dtype=torch.float32, device=q.device)
             if with_probs else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fwd_kernel()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            a_loc.data_ptr(), b_loc.data_ptr(), rel_index_loc.data_ptr(),
            node_mask.data_ptr(), out.data_ptr(),
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
    CUDA tensors go through the kernel (float32 or bfloat16, contiguous,
    N <= 128, Dh <= 128; anything else raises); CPU tensors through the
    plain version. `local_relation_attention.launches` counts launches."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return local_relation_attention_reference(
            q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale)
    _check_cuda_args(q, k, v, a_loc, b_loc, rel_index_loc, node_mask)
    out, _ = _launch_fwd(q, k, v, a_loc, b_loc, rel_index_loc, node_mask,
                         scale, with_probs=False)
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
    _check_cuda_args(q, k, v, a_loc, b_loc, rel_index_loc, node_mask)
    out, probs = _launch_fwd(q, k, v, a_loc, b_loc, rel_index_loc,
                             node_mask, scale, with_probs=True)
    local_relation_attention_with_probs.launches += 1
    return out, probs


def local_relation_attention_bwd(q, k, v, g, probs, a_loc, b_loc,
                                 rel_index_loc, pair_order=None,
                                 slot_start=None, scale=None):
    """B2: (gq, gk, gv, g_a_loc, g_b_loc) in the input type from the
    forward's f32 probs [B, H, N, N] and the f32 cotangent g [B, H, N, Dh].
    pair_order/slot_start: `slot_order(rel_index_loc, P_loc)`, built here
    when not given (the CPU's plain version needs neither). Same limits as
    B1; `.launches` counts launches."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return local_relation_attention_bwd_reference(
            q, k, v, g, probs, a_loc, b_loc, rel_index_loc, scale)
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    if pair_order is None or slot_start is None:
        pair_order, slot_start = slot_order(rel_index_loc, P_loc)
    _check_bwd_args(q, k, v, g, probs, a_loc, b_loc, rel_index_loc,
                    pair_order, slot_start)
    gq, gk, gv = (torch.empty_like(q) for _ in range(3))
    ga, gb = torch.empty_like(a_loc), torch.empty_like(b_loc)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), probs.data_ptr(), a_loc.data_ptr(),
            b_loc.data_ptr(), rel_index_loc.data_ptr(), pair_order.data_ptr(),
            slot_start.data_ptr(), gq.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), ga.data_ptr(), gb.data_ptr(), B, H, N, Dh, P_loc,
            float(scale), stream)
    _raise_on(err, "local relation attention backward")
    local_relation_attention_bwd.launches += 1
    return gq, gk, gv, ga, gb


local_relation_attention.launches = 0
local_relation_attention_with_probs.launches = 0
local_relation_attention_bwd.launches = 0


class _LocalRelationAttention(torch.autograd.Function):
    """Forward B1p, backward B2 (looked up at call time, by name)."""

    @staticmethod
    def forward(ctx, q, k, v, a_loc, b_loc, rel_index_loc, node_mask,
                pair_order, slot_start, scale):
        out, probs = local_relation_attention_with_probs(
            q, k, v, a_loc, b_loc, rel_index_loc, node_mask, scale)
        ctx.save_for_backward(q, k, v, a_loc, b_loc, rel_index_loc, probs,
                              pair_order, slot_start)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, a_loc, b_loc, idx, probs, pair_order, slot_start = \
            ctx.saved_tensors
        grads = local_relation_attention_bwd(
            q, k, v, g.float().contiguous(), probs, a_loc, b_loc, idx,
            pair_order, slot_start, ctx.scale)
        return (*grads, None, None, None, None, None)


def local_relation_attention_trainable(q, k, v, a_loc, b_loc, rel_index_loc,
                                       node_mask, pair_order=None,
                                       slot_start=None, scale=None):
    """Differentiable localized attention: `local_relation_attention`'s
    arguments and result, with gradients to q, k, v, a_loc and b_loc.
    Forward B1p, backward B2 (their plain versions for CPU tensors).
    pair_order/slot_start: `slot_order(...)` when the caller has it."""
    return _LocalRelationAttention.apply(
        q, k, v, a_loc, b_loc, rel_index_loc, node_mask, pair_order,
        slot_start, _default_scale(q, scale))
