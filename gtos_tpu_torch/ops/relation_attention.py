"""Relation-aware graph attention over the batch-global relation bank:
the forward from score tables or from the banks, and its backward.

Port of gtos_tpu/ops/pallas/relation_attention.py and
relation_attention_bwd.py. The banks a_bank/b_bank [P, H, Dh] hold the
per-head projections of every relation path of the batch; rel_index
[B, N, N] names each pair's bank row r. With t4[r] = a_r.b_r,

    e_ij = scale * (q_i.k_j + q_i.b_r + t4_r + k_j.a_r) + mask_add_j
    out_i = sum_j softmax_j(e_ij) v_j

mask_add_j = -1e9 at padded keys, scores and softmax in f32, the
probabilities rounded to v's type before the product with v.

Three hand-written CUDA kernels (built for sm_90a at first use), each with
a wrapper that launches it for CUDA tensors, runs its plain torch version
for CPU tensors and raises for anything else, and counts its launches in
`.launches`:

  B3  `fused_relation_attention`         from the tables of `build_tables`
      (t2 = q.b_bank^T + t4 and t3 = k.a_bank^T, [B, H, N, P], rounded to
      q's type), csrc/relation_attention_fwd.cu;
  B3' `fused_relation_attention_inline`  the same function from the banks,
      no table in device memory (t4 formed in the kernel and rounded to the
      bank type, as the TPU kernel folds it into b_bank's padding lane);
      the banks may be strided views (`bank_row_stride`: the layer's halves
      of one [P, 2 H Dh] projection), same source;
  B4  `fused_relation_attention_bwd`     the backward from the tables:
      gq, gk, gv (f32) and the dense table gradients g_t2/g_t3
      ([B, N, H, P], table type), csrc/relation_attention_bwd.cu (a row
      pass and a column pass, two launches counted as one call).

`pallas_relation_attention` picks the forward by `_inline_fits`, the
card's rule: B3' at every shape the kernels take (measured on an H100,
PERF.md §6); B3 stays as the forward from tables, public and checked.
The differentiable entry `relation_attention_trainable` is a
torch.autograd.Function: forward B3 or
B3' (no probabilities saved), backward the JAX package's `_rel_attn_bwd`:
rebuild the tables, B4, then the table -> q/k/bank contractions and the
t4 redistribution in torch, in f32, gradients returned in the inputs'
types.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gtos_tpu_torch.ops import build
from gtos_tpu_torch.ops.local_relation_attention import bank_row_stride

NEG_INF = -1e9
FWD_SOURCE = "relation_attention_fwd.cu"
BWD_SOURCE = "relation_attention_bwd.cu"
SOURCES = (FWD_SOURCE, BWD_SOURCE)
MAX_NODES = 128   # node bucket limit of the kernels (and of the TPU kernels)
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _default_scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def build_tables(q, k, a_bank, b_bank):
    """B3's score tables [B, H, N, P] in q's type, t4 folded into t2:
    t2 = q.b_bank^T + t4, t3 = k.a_bank^T, products summed in f32."""
    f32 = torch.float32
    bf, af = b_bank.to(f32), a_bank.to(f32)
    t4 = torch.einsum("phd,phd->ph", af, bf)
    t2 = (torch.einsum("bhid,phd->bhip", q.to(f32), bf)
          + t4.T[None, :, None]).to(q.dtype)
    t3 = torch.einsum("bhjd,phd->bhjp", k.to(f32), af).to(q.dtype)
    return t2.contiguous(), t3.contiguous()


def _inline_tables(q, k, a_bank, b_bank):
    """B3''s score tables as its kernel forms them: f32, never rounded,
    with t4 rounded to the bank type."""
    f32 = torch.float32
    bf, af = b_bank.to(f32), a_bank.to(f32)
    t4 = torch.einsum("phd,phd->ph", af, bf).to(b_bank.dtype).to(f32)
    t2 = torch.einsum("bhid,phd->bhip", q.to(f32), bf) + t4.T[None, :, None]
    return t2, torch.einsum("bhjd,phd->bhjp", k.to(f32), af)


def _scores(q, k, t2, t3, rel_index, node_mask, scale):
    """f32 scores [B, H, N, N]: (q.k^T + t2[i, r] + t3[j, r]) * scale +
    mask_add, r = rel_index[b, i, j]."""
    B, H, N, _ = q.shape
    f32 = torch.float32
    idx = rel_index.long()[:, None].expand(B, H, N, N)
    e24 = torch.gather(t2.to(f32), 3, idx)                  # t2[., i, r]
    e3t = torch.gather(t3.to(f32), 3, idx.transpose(2, 3))  # t3[., j, r]
    t1 = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
    mask_add = torch.where(node_mask.bool(), 0.0, NEG_INF)[:, None, None, :]
    return (t1 + e24 + e3t.transpose(2, 3)) * scale + mask_add


def _attend(e, v):
    attn = torch.softmax(e, dim=-1).to(v.dtype)
    return torch.matmul(attn.to(torch.float32), v.to(torch.float32)).to(
        v.dtype)


def fused_relation_attention_reference(q, k, v, t2, t3, rel_index,
                                       node_mask, scale=None):
    """Plain version of B3: `fused_relation_attention`'s arguments and
    result."""
    return _attend(_scores(q, k, t2, t3, rel_index, node_mask,
                           _default_scale(q, scale)), v)


def fused_relation_attention_inline_reference(q, k, v, a_bank, b_bank,
                                              rel_index, node_mask,
                                              scale=None):
    """Plain version of B3': `fused_relation_attention_inline`'s arguments
    and result."""
    t2, t3 = _inline_tables(q, k, a_bank, b_bank)
    return _attend(_scores(q, k, t2, t3, rel_index, node_mask,
                           _default_scale(q, scale)), v)


def fused_relation_attention_bwd_reference(q, k, v, g, t2, t3, rel_index,
                                           node_mask, scale=None):
    """Plain version of B4: recompute attn (f32) from the tables, then
    gv = attn^T g, ge = scale * attn * (g v^T - rowsum(attn * g v^T)),
    gq = ge k, gk = ge^T q (all f32), and the table gradients
    g_t2[b, i, h, p] = sum_{j: r=p} ge_ij, g_t3[b, j, h, p] =
    sum_{i: r=p} ge_ij, each ge_ij rounded to the table type before the sum
    and the sum rounded to it after, [B, N, H, P]."""
    B, H, N, _ = q.shape
    P = t2.shape[-1]
    f32 = torch.float32
    scale = _default_scale(q, scale)
    attn = torch.softmax(_scores(q, k, t2, t3, rel_index, node_mask, scale),
                         dim=-1)
    gf, qf, kf, vf = (x.to(f32) for x in (g, q, k, v))
    g_attn = torch.matmul(gf, vf.transpose(-1, -2))
    gv = torch.matmul(attn.transpose(-1, -2), gf)
    ge = attn * (g_attn - (g_attn * attn).sum(-1, keepdim=True)) * scale
    gq = torch.matmul(ge, kf)
    gk = torch.matmul(ge.transpose(-1, -2), qf)
    gm = ge.to(t2.dtype).to(f32)
    idx = rel_index.long()[:, None].expand(B, H, N, N)
    gt2 = torch.zeros(B, H, N, P, dtype=f32, device=q.device).scatter_add_(
        3, idx, gm)
    gt3 = torch.zeros(B, H, N, P, dtype=f32, device=q.device).scatter_add_(
        3, idx.transpose(2, 3), gm.transpose(2, 3))
    return (gq, gk, gv,
            gt2.transpose(1, 2).to(t2.dtype).contiguous(),
            gt3.transpose(1, 2).to(t3.dtype).contiguous())


def walk_orders(rel_index):
    """B4's walk orders from rel_index [B, N, N]: (row_order, col_order),
    each [B, N, N] int32: each row of rel_index argsorted (stable), and
    each column (each row of its transpose). Head- and layer-invariant, so
    built once per encoder stack."""
    row = torch.argsort(rel_index, dim=2, stable=True)
    col = torch.argsort(rel_index.transpose(1, 2).contiguous(), dim=2,
                        stable=True)
    return row.to(torch.int32), col.to(torch.int32)


def _inline_fits(q, a_bank) -> bool:
    """The card's rule for the global-bank forward: B3' when True, B3 on
    `build_tables` otherwise. B3' reads each pair's bank rows from device
    memory and keeps no bank in shared memory, so no bank size bounds it.
    At every shape `chip_crossovers.py` timed on an H100 (PERF.md §6, "The
    route crossovers", table (a): H=8, Dh=64, N 16-128 at the c2 loader's
    batch sizes, P 128-8192, bf16 and f32) B3' took 1.5-118x less device
    time than build_tables + B3, and forward plus backward (whose
    backward is the same on both) 1.08-1.5x less. So B3' within the
    kernels' own limits (node bucket up to MAX_NODES, head dim up to
    MAX_HEAD_DIM), which B3 shares: past them both refuse, and the CPU's
    plain versions compute the same function. A function of the shapes
    alone, so a captured step's signature fixes its kernel."""
    N, Dh = q.shape[2], q.shape[3]
    return N <= MAX_NODES and Dh <= MAX_HEAD_DIM


# ---------------------------------------------------------------- checks


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
        raise ValueError(f"node bucket {N} > {MAX_NODES}: the global-bank "
                         "kernels are for node buckets <= 128")
    if Dh > MAX_HEAD_DIM or Dh % 8:
        raise ValueError(f"head dim {Dh}: the kernels take multiples of 8 "
                         f"up to {MAX_HEAD_DIM}")


def _qkv_checks(q, k, v, rel_index, node_mask):
    B, H, N, Dh = q.shape
    return [("q", q, (B, H, N, Dh), q.dtype), ("k", k, (B, H, N, Dh), q.dtype),
            ("v", v, (B, H, N, Dh), q.dtype),
            ("rel_index", rel_index, (B, N, N), torch.int32),
            ("node_mask", node_mask, (B, N), torch.bool)]


def _check_aligned(*named):
    """Each (name, tensor) starts 16-byte aligned: the kernels read and
    write its rows 16 bytes at a time."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")


def _check_tables_args(q, k, v, t2, t3, rel_index, node_mask):
    """What B3 takes: refused here, before a launch. q, k and v are read
    16 bytes at a time, so each must start 16-byte aligned; the tables are
    read a value at a time, any P >= 1."""
    _check_sizes(q)
    B, H, N, _ = q.shape
    P = t2.shape[-1]
    if P < 1:
        raise ValueError("the tables need P >= 1 bank rows")
    for name, t, shape, dtype in _qkv_checks(q, k, v, rel_index, node_mask) + [
            ("t2", t2, (B, H, N, P), q.dtype),
            ("t3", t3, (B, H, N, P), q.dtype)]:
        _check(name, t, shape, dtype, q.device)
    _check_aligned(("q", q), ("k", k), ("v", v))


def _check_inline_args(q, k, v, a_bank, b_bank, rel_index, node_mask):
    """What B3' takes: refused here, before a launch. The banks are read 16
    bytes at a time, so each must start 16-byte aligned and their rows
    (H*Dh contiguous values, one row stride for both) must lie a multiple
    of 16 bytes apart. Returns that row stride in elements."""
    _check_sizes(q)
    B, H, N, Dh = q.shape
    P = a_bank.shape[0]
    for name, t, shape, dtype in _qkv_checks(q, k, v, rel_index, node_mask):
        _check(name, t, shape, dtype, q.device)
    for name, t in (("a_bank", a_bank), ("b_bank", b_bank)):
        if tuple(t.shape) != (P, H, Dh) or t.dtype != q.dtype:
            raise ValueError(f"{name}: expected {(P, H, Dh)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    _check_aligned(("q", q), ("k", k), ("v", v), ("a_bank", a_bank),
                   ("b_bank", b_bank))
    row = bank_row_stride(a_bank[None])
    if row is None or row != bank_row_stride(b_bank[None]):
        raise ValueError("a_bank and b_bank must be [P, H, Dh] banks of "
                         "contiguous rows with one row stride, got strides "
                         f"{a_bank.stride()} and {b_bank.stride()}")
    if row * a_bank.element_size() % 16:
        raise ValueError(f"bank row stride {row} elements is not a multiple "
                         "of 16 bytes")
    return row


def _check_bwd_args(q, k, v, g, t2, t3, rel_index, node_mask, row_order,
                    col_order):
    """What B4 takes: refused here, before a launch."""
    _check_tables_args(q, k, v, t2, t3, rel_index, node_mask)
    B, H, N, Dh = q.shape
    for name, t, shape, dtype in (
            ("g", g, (B, H, N, Dh), q.dtype),
            ("row_order", row_order, (B, N, N), torch.int32),
            ("col_order", col_order, (B, N, N), torch.int32)):
        _check(name, t, shape, dtype, q.device)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _fwd_kernels():
    """B3's and B3''s C entry points in the built library, with argument
    types."""
    return fwd_entries(build.load(FWD_SOURCE))[:2]


def fwd_entries(lib):
    """(B3, B3', variant) entry points of a library built from
    FWD_SOURCE, with argument types; variant(v) forces B3's design v (-1:
    the kernel's own) and returns the number of designs, 0 unless the
    library was built with GTOS_B3_VARIANTS."""
    tables, inline = lib.gtos_rel_attn_fwd_tables, lib.gtos_rel_attn_fwd_inline
    variant = lib.gtos_rel_attn_fwd_tables_variant
    tables.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    inline.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    variant.argtypes = [ctypes.c_int]
    tables.restype = inline.restype = variant.restype = ctypes.c_int
    return tables, inline, variant


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """B4's C entry point in the built library, with argument types."""
    fn = build.load(BWD_SOURCE).gtos_rel_attn_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel: CUDA error {err} at launch")


def _on_card(q):
    """True for a CUDA tensor, False for a CPU one (plain version)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return q.device.type == "cuda"


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def fused_relation_attention(q, k, v, t2, t3, rel_index, node_mask,
                             scale=None):
    """B3, the global-bank forward from score tables.

    q, k, v: [B, H, N, Dh]; t2, t3: [B, H, N, P] in q's type (`build_tables`);
    rel_index: [B, N, N] int32 bank rows; node_mask: [B, N] bool. Returns
    out [B, H, N, Dh] in v's type. CUDA tensors go through the kernel
    (float32 or bfloat16, contiguous, q, k, v 16-byte aligned, N <= 128,
    Dh a multiple of 8 up to 128, any P; anything else raises); CPU tensors
    through the plain version."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return fused_relation_attention_reference(
            q, k, v, t2, t3, rel_index, node_mask, scale)
    _check_tables_args(q, k, v, t2, t3, rel_index, node_mask)
    B, H, N, Dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fwd_kernels()[0](
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            t2.data_ptr(), t3.data_ptr(), rel_index.data_ptr(),
            node_mask.data_ptr(), out.data_ptr(), B, H, N, Dh, t2.shape[-1],
            float(scale), _stream(q))
    _raise_on(err, "relation attention forward (tables)")
    fused_relation_attention.launches += 1
    return out


def fused_relation_attention_inline(q, k, v, a_bank, b_bank, rel_index,
                                    node_mask, scale=None):
    """B3', the global-bank forward from the banks themselves.

    q, k, v: [B, H, N, Dh]; a_bank, b_bank: [P, H, Dh] in q's type, rows
    of H*Dh contiguous values with one row stride for both (contiguous
    banks, or the halves of one [P, 2 H Dh] projection from `split_banks`),
    16-byte aligned; rel_index, node_mask as B3. Returns out [B, H, N, Dh]
    in v's type. Same limits as B3; its own `.launches`."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return fused_relation_attention_inline_reference(
            q, k, v, a_bank, b_bank, rel_index, node_mask, scale)
    row = _check_inline_args(q, k, v, a_bank, b_bank, rel_index, node_mask)
    B, H, N, Dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fwd_kernels()[1](
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            a_bank.data_ptr(), b_bank.data_ptr(), row,
            rel_index.data_ptr(), node_mask.data_ptr(), out.data_ptr(), B, H,
            N, Dh, a_bank.shape[0], float(scale), _stream(q))
    _raise_on(err, "relation attention forward (inline)")
    fused_relation_attention_inline.launches += 1
    return out


def fused_relation_attention_bwd(q, k, v, g, t2, t3, rel_index, node_mask,
                                 row_order=None, col_order=None, scale=None):
    """B4: (gq, gk, gv [B, H, N, Dh] f32, g_t2, g_t3 [B, N, H, P] in the
    table type; note the row-major table-gradient layout) from B3's inputs
    and the output's cotangent g [B, H, N, Dh] in q's type. row_order /
    col_order: `walk_orders(rel_index)`, built here when not given (the
    CPU's plain version needs neither). Same limits as B3. Its kernel is two
    launches (a row pass and a column pass, with a [B, N, N, H] (ge, p)
    workspace between them), which `.launches` counts as one call."""
    scale = _default_scale(q, scale)
    if not _on_card(q):
        return fused_relation_attention_bwd_reference(
            q, k, v, g, t2, t3, rel_index, node_mask, scale)
    if row_order is None or col_order is None:
        row_order, col_order = walk_orders(rel_index)
    _check_bwd_args(q, k, v, g, t2, t3, rel_index, node_mask, row_order,
                    col_order)
    B, H, N, Dh = q.shape
    P = t2.shape[-1]
    gq, gk, gv = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    gt2, gt3 = (torch.empty(B, N, H, P, dtype=t2.dtype, device=q.device)
                for _ in range(2))
    gep = torch.empty(B, N, N, H, 2, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_kernel()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), t2.data_ptr(), t3.data_ptr(), rel_index.data_ptr(),
            node_mask.data_ptr(), row_order.data_ptr(), col_order.data_ptr(),
            gep.data_ptr(), gq.data_ptr(), gk.data_ptr(), gv.data_ptr(),
            gt2.data_ptr(), gt3.data_ptr(), B, H, N, Dh, P, float(scale),
            _stream(q))
    _raise_on(err, "relation attention backward")
    fused_relation_attention_bwd.launches += 1
    return gq, gk, gv, gt2, gt3


fused_relation_attention.launches = 0
fused_relation_attention_inline.launches = 0
fused_relation_attention_bwd.launches = 0


def pallas_relation_attention(q, k, v, a_bank, b_bank, rel_index, node_mask,
                              scale=None):
    """The global-bank forward, output only (no probabilities: the
    fusion's point): B3' where `_inline_fits` (the card's rule) says so,
    else B3 on `build_tables`. q, k, v: [B, H, N, Dh]; a_bank/b_bank:
    [P, H, Dh], as B3' takes them (strided views such as `split_banks`'
    halves too); rel_index: [B, N, N] int32. Returns (out [B, H, N, Dh], None), as the
    JAX package's."""
    if _inline_fits(q, a_bank):
        return fused_relation_attention_inline(
            q, k, v, a_bank, b_bank, rel_index, node_mask, scale), None
    t2, t3 = build_tables(q, k, a_bank, b_bank)
    return fused_relation_attention(q, k, v, t2, t3, rel_index, node_mask,
                                    scale), None


class _RelationAttention(torch.autograd.Function):
    """Forward B3 or B3', backward B4 and the table contractions (the
    wrappers looked up at call time, by name)."""

    @staticmethod
    def forward(ctx, q, k, v, a_bank, b_bank, rel_index, node_mask,
                row_order, col_order, scale):
        out, _ = pallas_relation_attention(q, k, v, a_bank, b_bank,
                                           rel_index, node_mask, scale)
        ctx.save_for_backward(q, k, v, a_bank, b_bank, rel_index, node_mask,
                              row_order, col_order)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, a_bank, b_bank, idx, mask, row_order, col_order = \
            ctx.saved_tensors
        t2, t3 = build_tables(q, k, a_bank, b_bank)
        gq1, gk1, gv, g_t2, g_t3 = fused_relation_attention_bwd(
            q, k, v, g.to(q.dtype).contiguous(), t2, t3, idx, mask,
            row_order, col_order, ctx.scale)
        f32 = torch.float32
        # t2 = q.b_bank + t4; t3 = k.a_bank; t4 = sum_d a_bank * b_bank
        # (table gradients row-major: [B, N, H, P])
        g_t2, g_t3 = g_t2.to(f32), g_t3.to(f32)
        af, bf = a_bank.to(f32), b_bank.to(f32)
        gq = gq1 + torch.einsum("bihp,phd->bhid", g_t2, bf)
        gk = gk1 + torch.einsum("bjhp,phd->bhjd", g_t3, af)
        g_b = torch.einsum("bihp,bhid->phd", g_t2, q.to(f32))
        g_a = torch.einsum("bjhp,bhjd->phd", g_t3, k.to(f32))
        g_t4 = g_t2.sum((0, 1)).T                              # [P, H]
        g_a = g_a + g_t4[:, :, None] * bf
        g_b = g_b + g_t4[:, :, None] * af
        return (gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype),
                g_a.to(a_bank.dtype), g_b.to(b_bank.dtype),
                None, None, None, None, None)


def relation_attention_trainable(q, k, v, a_bank, b_bank, rel_index,
                                 node_mask, row_order=None, col_order=None,
                                 scale=None):
    """Differentiable global-bank attention: `pallas_relation_attention`'s
    arguments, its output alone, with gradients to q, k, v, a_bank and
    b_bank. Forward B3/B3', backward B4 (their plain versions for CPU
    tensors). row_order/col_order: `walk_orders(...)` when the caller has
    them."""
    return _RelationAttention.apply(
        q, k, v, a_bank, b_bank, rel_index, node_mask, row_order, col_order,
        _default_scale(q, scale))
