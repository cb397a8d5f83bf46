"""The port's localized relation attention (ops/local_relation_attention.py:
the forward, the forward with probabilities and the backward), the bank
localization and the attention ops around them, against the JAX package
on the CPU (the CUDA kernels themselves are held against their plain
versions in tests/test_torch_cuda.py, on a card).

Inputs are made with numpy from a seed (tests/test_torch_cuda.py
make_case) and handed to both packages. The
JAX kernel runs as its own tests run it, under the Pallas interpreter
(interpret=True). Tolerances: 2e-5 absolute and relative, as
tests/test_local_kernel.py holds the JAX kernel against its dense
reference (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.ops.attention import (
    bank_relation_attention as jax_bank_relation_attention,
)
from gtos_tpu.ops.localize import build_localize_aux as jax_localize_aux
from gtos_tpu.ops.localize import localize_bank as jax_localize_bank
from gtos_tpu.ops.pallas.local_relation_attention import (
    local_relation_attention as jax_local_relation_attention,
    local_relation_attention_trainable as jax_trainable,
)
from gtos_tpu_torch.ops.attention import bank_relation_attention
from gtos_tpu_torch.ops.local_relation_attention import (
    RUN_CHUNK, SHORT_RUN, _check_bwd_args, _check_cuda_args,
    bank_row_stride, bank_runs, joined_bank_grads, local_relation_attention,
    local_relation_attention_bwd, local_relation_attention_bwd_reference,
    local_relation_attention_reference, local_relation_attention_trainable,
    local_relation_attention_with_probs, max_run_chunks, slot_order,
    split_banks,
)
from gtos_tpu_torch.ops.localize import build_localize_aux, localize_bank
from test_local_kernel import build_case
from test_torch_cuda import CASES, make_case, port_local_args

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,N,Dh,P,P_loc", CASES)
def test_plain_local_attention_matches_jax_kernel(B, H, N, Dh, P, P_loc):
    """The plain B1 (what a CPU tensor runs) against the JAX Pallas
    kernel in interpret mode, padded rows included."""
    c = make_case(B, H, N, Dh, P, P_loc)
    bm = c["bank_map"]
    ref = jax_local_relation_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["a_bank"][bm]), jnp.asarray(c["b_bank"][bm]),
        jnp.asarray(c["idx_loc"]), jnp.asarray(c["mask"]), interpret=True)
    out = local_relation_attention_reference(*port_local_args(c))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,H,N,Dh,P,P_loc", CASES)
def test_bank_attention_matches_jax_and_the_local_form(B, H, N, Dh, P,
                                                       P_loc):
    """ops/attention.py (the "xla" impl) against the JAX package's, and
    the localized plain version against it: the same function over the
    global bank and over the per-graph banks (localize_bank)."""
    c = make_case(B, H, N, Dh, P, P_loc, seed=1)
    names = ("q", "k", "v", "a_bank", "b_bank", "rel_index", "mask")
    ref_out, ref_attn = jax_bank_relation_attention(
        *(jnp.asarray(c[n]) for n in names))
    out, attn = bank_relation_attention(
        *(torch.from_numpy(c[n]) for n in names))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), **TOL)
    local = local_relation_attention_reference(*port_local_args(c))
    np.testing.assert_allclose(local.numpy(), out.numpy(), **TOL)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version and launches nothing; a device
    without a kernel raises."""
    args = port_local_args(make_case(*CASES[0]))
    before = local_relation_attention.launches
    out = local_relation_attention(*args)
    assert local_relation_attention.launches == before
    torch.testing.assert_close(out, local_relation_attention_reference(*args),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel"):
        local_relation_attention(*(a.to("meta") for a in args))


def _bad(args, which):
    q, k, v, a, b, idx, mask = args
    if which == "dtype":
        q, k, v, a, b = (x.half() for x in (q, k, v, a, b))
    elif which == "idx_dtype":
        idx = idx.long()
    elif which == "mask_shape":
        mask = mask[:, :-1]
    elif which == "not_contiguous":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif which == "too_many_nodes":
        n = 136
        q, k, v = (torch.zeros(1, 1, n, 16) for _ in range(3))
        a = b = torch.zeros(1, 128, 1, 16)
        idx = torch.zeros(1, n, n, dtype=torch.int32)
        mask = torch.ones(1, n, dtype=torch.bool)
    return q, k, v, a, b, idx, mask


@pytest.mark.parametrize("which", ["dtype", "idx_dtype", "mask_shape",
                                   "not_contiguous", "too_many_nodes"])
def test_kernel_argument_checks_raise(which):
    """What the CUDA kernel does not take is refused before a launch."""
    args = port_local_args(make_case(*CASES[0]))
    with pytest.raises((TypeError, ValueError)):
        _check_cuda_args(*_bad(args, which))


# the two cases of tests/test_local_kernel.py's gradient test
GRAD_CASES = [(2, 2, 32, 16, 200, 128), (1, 3, 64, 32, 300, 256)]


@pytest.mark.parametrize("B,H,N,Dh,P,P_loc", GRAD_CASES)
def test_plain_b1p_and_b2_match_jax_trainable(B, H, N, Dh, P, P_loc):
    """The differentiable entry on CPU tensors (forward: the plain B1p;
    backward: the plain B2) against the JAX package's
    local_relation_attention_trainable under the Pallas interpreter, on
    tests/test_local_kernel.py's build_case: the output, B1p's f32
    probabilities against the JAX kernel's (its lane-padded columns cut
    off), the gradient of sum(out^2) to the per-graph bank projection ab
    [B, P_loc, 2 H Dh] (the entry's input: the local banks side by side)
    against the custom VJP's gradients to its a_loc and b_loc, and to q, k,
    v and both GLOBAL banks through the bank_map gather, at that test's
    5e-4."""
    (q, k, v, a_bank, b_bank, _, mask, bank_map, idx_loc,
     srt, bnd, srtT, bndT) = build_case(B, H, N, Dh, P, P_loc)

    def jax_loss(q, k, v, ab, bb):
        o = jax_trainable(q, k, v, ab[bank_map], bb[bank_map], idx_loc, mask,
                          srt, bnd, srtT, bndT, interpret=True)
        return (o ** 2).sum(), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            q, k, v, a_bank, b_bank)
    jloc = jax.jit(jax.grad(lambda a, b: (jax_trainable(
        q, k, v, a, b, idx_loc, mask, srt, bnd, srtT, bndT,
        interpret=True) ** 2).sum(), argnums=(0, 1)))(
            a_bank[bank_map], b_bank[bank_map])
    _, jprobs = jax_local_relation_attention(
        q, k, v, a_bank[bank_map], b_bank[bank_map], idx_loc, mask,
        interpret=True, with_probs=True)

    leaves = [torch.tensor(np.asarray(x), requires_grad=True)
              for x in (q, k, v, a_bank, b_bank)]
    bm, idx, nmask = (torch.from_numpy(np.array(x))
                      for x in (bank_map, idx_loc, mask))
    ab = torch.cat([localize_bank(x.flatten(1), bm) for x in leaves[3:]], -1)
    ab.retain_grad()
    a_loc, b_loc = split_banks(ab, H)
    before = (local_relation_attention_with_probs.launches,
              local_relation_attention_bwd.launches)
    out = local_relation_attention_trainable(*leaves[:3], ab, idx, nmask)
    (out ** 2).sum().backward()
    _, probs = local_relation_attention_with_probs(
        *(x.detach() for x in (*leaves[:3], a_loc, b_loc)), idx, nmask)
    assert (local_relation_attention_with_probs.launches,
            local_relation_attention_bwd.launches) == before
    tol = dict(rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs)[..., :N],
                               rtol=2e-5, atol=2e-6)
    for name, leaf, ref in zip("qkvab", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   **tol, err_msg=name)
    ref_ab = np.concatenate([np.asarray(x).reshape(B, P_loc, H * Dh)
                             for x in jloc], -1)
    np.testing.assert_allclose(ab.grad.numpy(), ref_ab, **tol)


@pytest.mark.parametrize("sorted_aux", [False, True])
def test_localize_bank_grads_match_the_scatter_free_backward(sorted_aux):
    """The port's localize_bank backward, a scatter-add of [B*P_loc, D]
    into [P, D] (autograd of the gather, or with loc_perm/loc_bnd the
    sorted prefix sum), against the JAX package's scatter-free backward
    over the host sort order (_localize_aux), with colliding rows across
    graphs and pad slots on row 0, to 1e-5 (f32 sums in another order);
    build_localize_aux's arrays equal the JAX package's."""
    rng = np.random.default_rng(0)
    B, P_loc, P, D = 5, 96, 300, 24
    bank_map = np.zeros((B, P_loc), np.int32)
    for b in range(B):
        rows = np.unique(rng.integers(0, P, size=rng.integers(10, P_loc)))
        bank_map[b, 1:1 + len(rows)] = rows
    perm, bnd = jax_localize_aux(bank_map, P)
    p_perm, p_bnd = build_localize_aux(bank_map, P)
    np.testing.assert_array_equal(p_perm, perm)
    np.testing.assert_array_equal(p_bnd, bnd)
    rel_vecs = rng.standard_normal((P, D)).astype(np.float32)
    g_out = rng.standard_normal((B, P_loc, D)).astype(np.float32)
    ref = jax.grad(lambda rv: (jax_localize_bank(
        rv, jnp.asarray(bank_map), jnp.asarray(perm), jnp.asarray(bnd))
        * g_out).sum())(jnp.asarray(rel_vecs))
    rv = torch.tensor(rel_vecs, requires_grad=True)
    aux = ((torch.from_numpy(p_perm), torch.from_numpy(p_bnd)) if sorted_aux
           else ())
    out = localize_bank(rv, torch.from_numpy(bank_map), *aux)
    (out * torch.from_numpy(g_out)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), rel_vecs[bank_map])
    np.testing.assert_allclose(rv.grad.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_slot_order_walks_each_graphs_pairs_by_slot():
    """B2's walk order: per graph, the flat pairs i*N+j sorted by slot
    (stable, so by pair within a slot) and each slot's run bounds, the
    last at N*N; empty slots have empty runs."""
    c = make_case(*CASES[2])
    idx = torch.from_numpy(c["idx_loc"])
    P_loc = c["bank_map"].shape[1]
    order, start = slot_order(idx, P_loc)
    assert order.dtype == start.dtype == torch.int32
    flat = c["idx_loc"].reshape(len(idx), -1)
    for b in range(len(idx)):
        np.testing.assert_array_equal(
            order[b].numpy(), np.argsort(flat[b], kind="stable"))
        counts = np.bincount(flat[b], minlength=P_loc)
        np.testing.assert_array_equal(
            start[b].numpy(), np.concatenate([[0], np.cumsum(counts)]))


@pytest.mark.parametrize("which", ["g_dtype", "probs_shape", "order_dtype",
                                   "start_shape", "too_many_nodes"])
def test_backward_argument_checks_raise(which):
    """What B2 does not take is refused before a launch: an f32 cotangent
    and f32 probabilities [B, H, N, N], int32 walk arrays of their shapes,
    node buckets up to 128."""
    q, k, v, a, b, idx, mask = port_local_args(make_case(*CASES[0]))
    g = torch.zeros_like(q)
    _, probs = local_relation_attention_with_probs(q, k, v, a, b, idx, mask)
    order, start = slot_order(idx, a.shape[1])
    _check_bwd_args(q, k, v, g, probs, a, b, idx, order, start)
    if which == "g_dtype":
        g = g.double()
    elif which == "probs_shape":
        probs = probs[..., :-1].contiguous()
    elif which == "order_dtype":
        order = order.long()
    elif which == "start_shape":
        start = start[:, :-1].contiguous()
    else:
        q = k = v = g = torch.zeros(1, 1, 136, 16)
        a = b = torch.zeros(1, 128, 1, 16)
        idx = torch.zeros(1, 136, 136, dtype=torch.int32)
        probs = torch.zeros(1, 1, 136, 136)
        order, start = slot_order(idx, 128)
    with pytest.raises((TypeError, ValueError)):
        _check_bwd_args(q, k, v, g, probs, a, b, idx, order, start)


def _walk(order, runs, N):
    """Every pair that B2's bank pass visits, per graph, as (slot, pair) in
    its order: the chunks of bank_runs' list in list order, then its short
    runs whole."""
    seen = []
    cmax = max_run_chunks(N)
    for b in range(len(order)):
        ids = order[b].tolist()
        n_chunks, n_short = runs[b, 0, :2].tolist()
        pairs = []
        for first, count, r, _ in runs[b, 1:1 + n_chunks].tolist():
            assert 0 < count <= RUN_CHUNK
            pairs += [(r, p) for p in ids[first:first + count]]
        for first, count, r, k in runs[b, 1 + cmax:1 + cmax + n_short].tolist():
            assert 0 < count <= SHORT_RUN and k == 0
            pairs += [(r, p) for p in ids[first:first + count]]
        seen.append(pairs)
    return seen


@pytest.mark.parametrize("case", ["random", "one_slot", "pad_slot", "tiny"])
def test_bank_runs_cover_every_pair_once(case):
    """B2's bank pass over slot_order's order and bank_runs' list visits
    every pair of every graph exactly once, under the slot the pair maps
    to: a run of more than SHORT_RUN pairs as chunks that stand one after
    the other in chunk order, each starting RUN_CHUNK places after the one
    before, the other non-empty runs whole, longest first; the counts in
    entry 0, zeros past them. Cases: a random slot matrix (runs of every
    length), all N*N pairs on one slot (a run of 16384 pairs at N=128), the
    pad slot 0 holding the pairs of padded nodes, and N=1."""
    rng = np.random.default_rng(3)
    B, N, P_loc = {"random": (3, 32, 64), "one_slot": (2, 128, 4096),
                   "pad_slot": (4, 48, 512), "tiny": (2, 1, 128)}[case]
    if case == "random":
        idx = rng.integers(0, 8, (B, N, N)) ** 2
    elif case == "pad_slot":
        idx = rng.integers(1, P_loc, (B, N, N))
        for b in range(B):
            n = int(rng.integers(5, N))
            idx[b, n:] = 0
            idx[b, :, n:] = 0
    else:
        idx = np.zeros((B, N, N), np.int64)
    idx = torch.from_numpy(idx.astype(np.int32))
    order, start = slot_order(idx, P_loc)
    runs = bank_runs(start, N)
    cmax = max_run_chunks(N)
    assert runs.dtype == torch.int32
    assert tuple(runs.shape) == (B, 1 + cmax + P_loc, 4)
    for b, pairs in enumerate(_walk(order, runs, N)):
        flat = idx[b].flatten().tolist()
        assert sorted(p for _, p in pairs) == list(range(N * N))
        assert all(flat[p] == r for r, p in pairs)
        n_chunks, n_short = runs[b, 0, :2].tolist()
        assert not runs[b, 0, 2:].any()
        assert not runs[b, 1 + n_chunks:1 + cmax].any()
        assert not runs[b, 1 + cmax + n_short:].any()
        items = runs[b, 1:1 + n_chunks].tolist()
        for (f0, _, r0, k0), (f1, _, r1, k1) in zip(items, items[1:]):
            assert (r1 == r0 and k1 == k0 + 1 and f1 == f0 + RUN_CHUNK) or (
                r1 > r0 and k1 == 0)
        lengths = runs[b, 1 + cmax:1 + cmax + n_short, 1].tolist()
        assert lengths == sorted(lengths, reverse=True)
    if case == "one_slot":
        assert runs[0, 0, :2].tolist() == [N * N // RUN_CHUNK, 0]


def test_split_banks_are_views_the_kernels_take():
    """The layer's bank projection ab [B, P_loc, 2 H Dh] splits into a_loc
    and b_loc without a copy, rows 2 H Dh apart, which the kernels' checks
    take (B1/B1p and B2); the halves of one [B, P_loc, 2, H, Dh] gradient
    join back into ab's gradient as a view, two separate tensors by a copy;
    a bank whose heads are not contiguous within a row is refused."""
    q, k, v, a, b, idx, mask = port_local_args(make_case(*CASES[0]))
    B, H, N, Dh = q.shape
    P_loc = a.shape[1]
    ab = torch.cat([a.flatten(2), b.flatten(2)], -1)
    a_v, b_v = split_banks(ab, H)
    assert a_v.data_ptr() == ab.data_ptr() and not a_v.is_contiguous()
    assert torch.equal(a_v, a) and torch.equal(b_v, b)
    assert bank_row_stride(a_v) == bank_row_stride(b_v) == 2 * H * Dh
    assert bank_row_stride(a) == H * Dh
    assert _check_cuda_args(q, k, v, a_v, b_v, idx, mask) == 2 * H * Dh
    g = torch.zeros_like(q)
    _, probs = local_relation_attention_with_probs(q, k, v, a, b, idx, mask)
    order, start = slot_order(idx, P_loc)
    assert _check_bwd_args(q, k, v, g, probs, a_v, b_v, idx, order, start,
                           bank_runs(start, N)) == 2 * H * Dh
    with pytest.raises(ValueError, match="one row stride"):
        _check_cuda_args(q, k, v, a_v, b, idx, mask)
    with pytest.raises(ValueError, match="contiguous rows"):
        _check_cuda_args(q, k, v, a.transpose(0, 1).contiguous().transpose(
            0, 1), b, idx, mask)
    grad = torch.randn(B, P_loc, 2, H, Dh)
    joined = joined_bank_grads(grad[:, :, 0], grad[:, :, 1])
    assert joined.data_ptr() == grad.data_ptr()
    assert torch.equal(joined, grad.reshape(B, P_loc, 2 * H * Dh))
    copied = joined_bank_grads(grad[:, :, 0].clone(), grad[:, :, 1].clone())
    assert torch.equal(copied, joined)


def test_plain_b2_on_strided_banks_matches_contiguous():
    """The plain B1 and B2 (what CPU tensors run) give the same bits on the
    halves of ab as on contiguous copies of them."""
    q, k, v, a, b, idx, mask = port_local_args(make_case(*CASES[2]))
    ab = torch.cat([a.flatten(2), b.flatten(2)], -1)
    a_v, b_v = split_banks(ab, q.shape[1])
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    out, probs = local_relation_attention_with_probs(q, k, v, a_v, b_v, idx,
                                                     mask)
    assert torch.equal(out, local_relation_attention(q, k, v, a, b, idx,
                                                     mask))
    for x, y in zip(local_relation_attention_bwd_reference(
            q, k, v, g, probs, a_v, b_v, idx),
            local_relation_attention_bwd_reference(q, k, v, g, probs, a, b,
                                                   idx)):
        assert torch.equal(x, y)
