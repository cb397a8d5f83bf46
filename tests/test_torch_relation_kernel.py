"""The port's global-bank relation attention (ops/relation_attention.py:
B3 from the tables, B3' from the banks, the backward B4 and the trainable
entry around them) against the JAX package on the CPU (the CUDA kernels
themselves are held against their plain versions in
tests/test_torch_cuda.py, on a card).

Inputs are made with numpy from a seed (tests/test_torch_cuda.py
make_global_case) and handed to both packages. The JAX kernels run as
their own tests run them, under the Pallas interpreter (interpret=True).
Tolerance: 2e-4 absolute and relative in f32, as tests/test_pallas_kernel.py
holds the JAX kernel against the XLA path (f32 sums in another order).
Outputs are compared on the real query rows of the padded graph, as that
test does; the backward's outputs on every row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.ops.pallas import relation_attention as jax_ra
from gtos_tpu.ops.pallas.relation_attention_bwd import (
    fused_relation_attention_bwd as jax_bwd,
)
from gtos_tpu_torch.ops.relation_attention import (
    _check_bwd_args, _check_inline_args, _check_tables_args, _inline_fits,
    build_tables, fused_relation_attention, fused_relation_attention_bwd,
    fused_relation_attention_bwd_reference, fused_relation_attention_inline,
    fused_relation_attention_inline_reference,
    fused_relation_attention_reference, pallas_relation_attention,
    relation_attention_trainable, walk_orders,
)
from test_torch_cuda import PAD, make_global_case, port_global_args

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(N, P) for N in (16, 128) for P in (128, 256)]
B, H, DH = 2, 4, 32


def _jax(c, *names):
    return tuple(jnp.asarray(c[n]) for n in names)


def _real_rows(x, N):
    """Graph 0's real query rows and all of graph 1, [B, H, N, Dh]."""
    x = np.asarray(x)
    return np.concatenate([x[0, :, : N - PAD].ravel(), x[1].ravel()])


@pytest.mark.parametrize("N,P", SHAPES + [(32, 4096)])
def test_tables_and_plain_b3_match_jax(N, P):
    """build_tables against the JAX package's _build_tables, and the
    plain B3 (what a CPU tensor runs) against fused_relation_attention
    under the interpreter, on the JAX tables; last at the c2 batches'
    bank size (P=4096, N=32), where the TPU's rule takes B3. The JAX
    kernel takes P a multiple of 128 only, so B3 at other P is held on
    the card, against the plain version."""
    c = make_global_case(B, H, N, DH, P)
    q, k, v, ab, bb, idx, mask = _jax(c, "q", "k", "v", "a_bank", "b_bank",
                                      "rel_index", "mask")
    jt2, jt3 = jax_ra._build_tables(q, k, ab, bb)
    ref = jax_ra.fused_relation_attention(
        q, k, v, jt2, jt3, idx, jnp.swapaxes(idx, 1, 2), mask,
        interpret=True)
    args = port_global_args(c)
    t2, t3 = build_tables(*args[:2], *args[3:5])
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt2), **TOL)
    np.testing.assert_allclose(t3.numpy(), np.asarray(jt3), **TOL)
    t2, t3 = torch.from_numpy(np.asarray(jt2)), torch.from_numpy(
        np.asarray(jt3))
    out = fused_relation_attention_reference(*args[:3], t2, t3, *args[5:])
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_real_rows(out, N), _real_rows(ref, N), **TOL)


@pytest.mark.parametrize("N,P", SHAPES)
def test_plain_b3_inline_matches_jax(N, P):
    """The plain B3' against fused_relation_attention_inline under the
    interpreter, and against the plain B3 (the same function)."""
    c = make_global_case(B, H, N, DH, P, seed=1)
    ref = jax_ra.fused_relation_attention_inline(
        *_jax(c, "q", "k", "v", "a_bank", "b_bank", "rel_index", "mask"),
        interpret=True)
    args = port_global_args(c)
    out = fused_relation_attention_inline_reference(*args)
    np.testing.assert_allclose(_real_rows(out, N), _real_rows(ref, N), **TOL)
    t2, t3 = build_tables(*args[:2], *args[3:5])
    tables = fused_relation_attention_reference(*args[:3], t2, t3, *args[5:])
    np.testing.assert_allclose(out.numpy(), tables.numpy(), **TOL)


@pytest.mark.parametrize("N,P", SHAPES)
def test_plain_b4_matches_jax(N, P):
    """The plain B4 against fused_relation_attention_bwd under the
    interpreter on the same tables and cotangent: gq, gk, gv (f32) and the
    dense table gradients in the row-major [B, N, H, P] layout, every
    row."""
    c = make_global_case(B, H, N, DH, P, seed=2)
    q, k, v, ab, bb, idx, mask, g = _jax(
        c, "q", "k", "v", "a_bank", "b_bank", "rel_index", "mask", "g")
    jt2, jt3 = jax_ra._build_tables(q, k, ab, bb)
    ref = jax_bwd(q, k, v, g, jt2, jt3, idx, jnp.swapaxes(idx, 1, 2), mask,
                  interpret=True)
    args = port_global_args(c)
    t2, t3 = (torch.from_numpy(np.asarray(x)) for x in (jt2, jt3))
    out = fused_relation_attention_bwd_reference(
        *args[:3], torch.from_numpy(c["g"]), t2, t3, *args[5:])
    for name, x, y in zip(("gq", "gk", "gv", "g_t2", "g_t3"), out, ref):
        assert x.dtype == torch.float32 and x.shape == y.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL,
                                   err_msg=name)
    assert out[3].shape == (B, N, H, P)


@pytest.mark.parametrize("N,P", SHAPES)
def test_trainable_grads_match_jax(N, P):
    """relation_attention_trainable on CPU tensors (forward: the plain B3'
    or B3 as _inline_fits picks; backward: the plain B4 and the table
    contractions) against jax.grad of the JAX relation_attention_trainable
    under the interpreter: the output and the gradients of sum(out^2) to q,
    k, v, a_bank and b_bank."""
    c = make_global_case(B, H, N, DH, P, seed=3)
    idx, mask = _jax(c, "rel_index", "mask")

    def jax_loss(q, k, v, ab, bb):
        o = jax_ra.relation_attention_trainable(q, k, v, ab, bb, idx, mask,
                                                interpret=True)
        return (o ** 2).sum(), o

    (_, jout), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *_jax(c, "q", "k", "v", "a_bank", "b_bank"))
    args = port_global_args(c)
    leaves = [x.clone().requires_grad_() for x in args[:5]]
    before = (fused_relation_attention.launches,
              fused_relation_attention_inline.launches,
              fused_relation_attention_bwd.launches)
    out = relation_attention_trainable(*leaves, *args[5:])
    (out ** 2).sum().backward()
    assert (fused_relation_attention.launches,
            fused_relation_attention_inline.launches,
            fused_relation_attention_bwd.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name, leaf, ref in zip(("q", "k", "v", "a_bank", "b_bank"), leaves,
                               jgrads):
        assert leaf.grad.dtype == torch.float32
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   **TOL, err_msg=name)


# where the card's rule and the JAX package's (the TPU's VMEM budget)
# part, at the shapes chip_crossovers.py times (H=8, Dh=64, N at the c2
# loader's largest batch per bucket, P on the bank ladder and 8192):
# (dtype, N) -> the smallest P at which the JAX rule takes B3
JAX_TAKES_B3_FROM = {("float32", 16): 2048, ("float32", 32): 2048,
                     ("float32", 64): 2048, ("float32", 128): 2048,
                     ("bfloat16", 16): 4096, ("bfloat16", 32): 4096,
                     ("bfloat16", 64): 4096, ("bfloat16", 128): 4096}
SWEEP_B = {16: 128, 32: 16, 64: 8, 128: 1}


def test_inline_fits_matches_jax():
    """The port's _inline_fits (which of B3'/B3 a forward takes) is the
    card's rule, set from chip_crossovers.py's sweep on an H100 (PERF.md
    §6): B3' at every shape the sweep timed, in both types, and at every
    shape within the kernels' limits (node bucket up to MAX_NODES, head
    dim up to MAX_HEAD_DIM); B3 only past them. The JAX package's rule
    (both banks within the TPU's VMEM) differs, shape by shape, where it
    takes B3 (JAX_TAKES_B3_FROM); the two forwards compute the same
    function, so only the choice differs."""
    from gtos_tpu_torch.ops.relation_attention import MAX_HEAD_DIM, MAX_NODES

    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        name = str(dtype).replace("torch.", "")
        for N, Bq in SWEEP_B.items():
            for P in (128, 256, 512, 1024, 2048, 4096, 8192):
                q = torch.zeros(Bq, 8, N, 64, dtype=dtype)
                a = torch.zeros(P, 8, 64, dtype=dtype)
                jq = jax.ShapeDtypeStruct((Bq, 8, N, 64), jdt)
                ja = jax.ShapeDtypeStruct((P, 8, 64), jdt)
                assert _inline_fits(q, a), (name, Bq, N, P)
                assert jax_ra._inline_fits(jq, ja) == (
                    P < JAX_TAKES_B3_FROM[name, N]), (name, Bq, N, P)
        for Bq, H, N, Dh in ((2, 4, 16, 32), (32, 2, 64, 128),
                             (8, 12, 128, 128)):
            for P in (128, 1000, 65536):
                assert _inline_fits(torch.zeros(Bq, H, N, Dh, dtype=dtype),
                                    torch.zeros(P, H, Dh, dtype=dtype))
    for N, Dh in ((MAX_NODES * 2, 64), (32, MAX_HEAD_DIM * 2)):
        assert not _inline_fits(torch.zeros(1, 2, N, Dh),
                                torch.zeros(128, 2, Dh))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors run the plain versions and launch nothing; the
    dispatcher returns (out, None) from B3' or B3 as _inline_fits says,
    the same function either way; a device without a kernel raises."""
    c = make_global_case(B, H, 16, DH, 128)
    args = port_global_args(c)
    before = (fused_relation_attention.launches,
              fused_relation_attention_inline.launches)
    out, probs = pallas_relation_attention(*args)
    assert probs is None and _inline_fits(args[0], args[3])
    torch.testing.assert_close(
        out, fused_relation_attention_inline_reference(*args), rtol=0,
        atol=0)
    t2, t3 = build_tables(*args[:2], *args[3:5])
    torch.testing.assert_close(
        fused_relation_attention(*args[:3], t2, t3, *args[5:]), out, **TOL)
    assert (fused_relation_attention.launches,
            fused_relation_attention_inline.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        fused_relation_attention_inline(*(a.to("meta") for a in args))


def test_walk_orders_sort_each_row_and_column():
    """B4's walk orders: each row of rel_index and each column argsorted,
    stable (ties in index order), int32."""
    c = make_global_case(B, H, 16, DH, 128)
    idx = torch.from_numpy(c["rel_index"])
    rows, cols = walk_orders(idx)
    assert rows.dtype == cols.dtype == torch.int32
    for b in range(B):
        for i in range(16):
            np.testing.assert_array_equal(
                rows[b, i].numpy(),
                np.argsort(c["rel_index"][b, i], kind="stable"))
            np.testing.assert_array_equal(
                cols[b, i].numpy(),
                np.argsort(c["rel_index"][b, :, i], kind="stable"))


@pytest.mark.parametrize("which", ["dtype", "idx_dtype", "table_shape",
                                   "head_dim", "too_many_nodes",
                                   "bank_dtype", "g_dtype", "order_shape",
                                   "bank_row_stride", "bank_layout",
                                   "bank_strides_differ", "bank_misaligned",
                                   "order_dtype", "q_misaligned",
                                   "k_misaligned", "v_misaligned"])
def test_kernel_argument_checks_raise(which):
    """What the CUDA kernels do not take is refused before a launch: B3'
    takes strided banks only as rows of contiguous [H, Dh] values with one
    row stride for both, a multiple of 16 bytes, starting 16-byte
    aligned; B3 (and B4, which checks B3's arguments) takes q, k and v
    only 16-byte aligned (here bf16 views at storage offset 1)."""
    c = make_global_case(B, H, 16, DH, 128)
    q, k, v, a, b, idx, mask = port_global_args(c)
    t2, t3 = build_tables(q, k, a, b)
    g = torch.zeros_like(q)
    rows, cols = walk_orders(idx)
    _check_tables_args(q, k, v, t2, t3, idx, mask)
    _check_inline_args(q, k, v, a, b, idx, mask)
    _check_bwd_args(q, k, v, g, t2, t3, idx, mask, rows, cols)
    if which == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif which == "idx_dtype":
        idx = idx.long()
    elif which == "table_shape":
        t2 = t2[..., :-1].contiguous()
    elif which == "head_dim":
        q = k = v = g = torch.zeros(B, H, 16, 12)
        a = b = torch.zeros(128, H, 12)
    elif which == "too_many_nodes":
        q = k = v = g = torch.zeros(1, 1, 136, 16)
        idx = torch.zeros(1, 136, 136, dtype=torch.int32)
        mask = torch.ones(1, 136, dtype=torch.bool)
    elif which == "bank_dtype":
        a = a.double()
    elif which == "g_dtype":
        g = g.double()
    elif which == "bank_row_stride":   # rows H*Dh + 1 f32 values apart
        a, b = (torch.zeros(128, H * DH + 1)[:, :H * DH].reshape(128, H, DH)
                for _ in range(2))
    elif which == "bank_layout":       # heads not contiguous within a row
        a = torch.zeros(128, DH, H).transpose(1, 2)
    elif which == "bank_strides_differ":
        a = torch.zeros(128, 2 * H * DH)[:, :H * DH].reshape(128, H, DH)
    elif which == "bank_misaligned":
        a = torch.zeros(128 * H * DH + 1)[1:].view(128, H, DH)
    elif which == "order_dtype":
        rows = rows.long()
    elif which.endswith("_misaligned"):
        q, k, v, t2, t3 = (x.bfloat16() for x in (q, k, v, t2, t3))
        moved = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:]
        moved = moved.view(q.shape)
        assert moved.is_contiguous() and moved.data_ptr() % 16
        q, k, v = (moved if which[0] == name else x
                   for name, x in zip("qkv", (q, k, v)))
    else:
        rows = rows[:, :-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        if which.startswith("bank_"):
            _check_inline_args(q, k, v, a, b, idx, mask)
        elif which in ("g_dtype", "order_shape", "order_dtype"):
            _check_bwd_args(q, k, v, g, t2, t3, idx, mask, rows, cols)
        else:
            _check_tables_args(q, k, v, t2, t3, idx, mask)


@pytest.mark.parametrize("P", [1, 7, 1001, 4096])
def test_tables_check_takes_any_bank_size(P):
    """B3 reads its tables a value at a time, so _check_tables_args (and
    B4's check around it) takes tables of any P >= 1, aligned or not."""
    c = make_global_case(B, H, 16, DH, P)
    q, k, v, a, b, idx, mask = port_global_args(c)
    t2, t3 = build_tables(q, k, a, b)
    assert t2.shape == t3.shape == (B, H, 16, P)
    _check_tables_args(q, k, v, t2, t3, idx, mask)
    _check_tables_args(*(x.bfloat16() for x in (q, k, v, t2, t3)), idx,
                       mask)
    _check_bwd_args(q, k, v, torch.zeros_like(q), t2, t3, idx, mask,
                    *walk_orders(idx))
