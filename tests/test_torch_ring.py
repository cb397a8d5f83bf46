"""The port's context-parallel layouts and schedules against the JAX
package on the CPU: the per-cell packers, batchify's cp_shards > 1 and
host_shard arrays, and the three CP schedules (the edge-cell ring, a2a
and the ring with B5s/B6 per step, their plain versions here), both
emulated in one process through the loops of the distributed modules and
on spawned gloo ranks, against the JAX package's single-device sparse
attention on the same kept pairs: outputs within 1e-5, gradients within
rtol 5e-4 / atol 1e-6. Arrays are compared exactly (the data layer has
no floating point)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gtos_tpu.data import BucketSpec as JaxBucketSpec
from gtos_tpu.data import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_corpus
from gtos_tpu.ops import block_sparse as jax_bs
from gtos_tpu.ops.sparse_relation import (
    flatten_edge_cells as jax_flatten, sparse_relation_attention as jax_sparse)
from gtos_tpu_torch.data import BucketSpec, batchify
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
from gtos_tpu_torch.ops import block_sparse as bs
from gtos_tpu_torch.parallel import a2a_attention, ring_attention
from gtos_tpu_torch.parallel import ring_block_sparse
import torch_mesh_ranks as ranks

torch.set_num_threads(2)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)
# N = 256 for two node blocks, 512 for four (each block a multiple of 128)
CASES = {2: dict(n=2, seed=17, min_nodes=150, max_nodes=220, N=256),
         4: dict(n=2, seed=5, min_nodes=300, max_nodes=480, N=512)}


def _corpora(n, seed, min_nodes, max_nodes, **_):
    jg, jt = jax_corpus(n, seed=seed, min_nodes=min_nodes,
                        max_nodes=max_nodes)
    pg, pt = synthetic_amr_corpus(n, seed=seed, min_nodes=min_nodes,
                                  max_nodes=max_nodes)
    return ((jax_preprocess(jg, jt), jax_build_vocabs(jg, jt)),
            (preprocess(pg, pt), build_vocabs(pg, pt)))


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def cells(request):
    """(S, JAX batches at cp_shards S and 1, the port's at S and 1): edge
    cells and tiles at khop 2, training batches (the src-major cells)."""
    S = request.param
    case = CASES[S]
    (ji, jv), (pi, pv) = _corpora(**case)
    kw = dict(batch_size_bucket=case["n"], build_edges=True,
              build_block_tiles=True, sparse_khop=2, for_train=True)
    jspec = JaxBucketSpec(nodes=(case["N"],), bank=(16384, 65536))
    pspec = BucketSpec(nodes=(case["N"],), bank=(16384, 65536))
    return (S, jax_batchify(ji, *jv, spec=jspec, cp_shards=S, **kw),
            jax_batchify(ji, *jv, spec=jspec, cp_shards=1, **kw),
            batchify(pi, *pv, spec=pspec, cp_shards=S, **kw),
            batchify(pi, *pv, spec=pspec, cp_shards=1, **kw))


def _same(ja, pa):
    assert ja.keys() == pa.keys()
    for k in ja:
        assert ja[k].dtype == pa[k].dtype, k
        np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)


def test_batchify_cp_shards_equals_jax(cells):
    """batchify(cp_shards=S) gives the JAX package's arrays, the edge
    cells [B, S, S, Ec] and the four per-cell tile layouts among them."""
    S, jcp, _, pcp, _ = cells
    assert pcp.edge_src.shape[1:3] == (S, S)
    assert pcp.ctile_rel_src.shape[1:3] == (S, S)
    _same(jcp.arrays(), pcp.arrays())


@pytest.mark.parametrize("own", [None, (1, 2)])
def test_cell_packers_equal_jax(cells, own):
    """pack_block_sparse_cells and its src-major twin against the JAX
    package's, whole and for an owned row slice (the other rows -1)."""
    S, _, _, pcp, _ = cells
    B, N = pcp.concept_mask.shape
    rng = np.random.default_rng(S)
    keep = rng.random((B, N, N)) < 0.02
    rel = rng.integers(1, 50, (B, N, N)).astype(np.int32)
    for jfn, pfn in ((jax_bs.pack_block_sparse_cells,
                      bs.pack_block_sparse_cells),
                     (jax_bs.pack_block_sparse_cells_src,
                      bs.pack_block_sparse_cells_src)):
        for j, p in zip(jfn(keep, rel, S, own=own), pfn(keep, rel, S,
                                                        own=own)):
            np.testing.assert_array_equal(j, p)


def test_batchify_refuses_unaligned_cp_tiles():
    """Tile cells need N to be a multiple of cp_shards*128, as in the JAX
    package."""
    from gtos_tpu_torch.data.batching import BatchCapacityError
    (_, _), (pi, pv) = _corpora(2, seed=17, min_nodes=150, max_nodes=220)
    with pytest.raises(BatchCapacityError, match="cp_shards"):
        batchify(pi, *pv, spec=BucketSpec(nodes=(256,), bank=(16384,)),
                 build_block_tiles=True, sparse_khop=2, cp_shards=4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("flags", [
    dict(build_local_banks=True, for_train=True),
    dict(build_edges=True, build_block_tiles=True, sparse_khop=2,
         cp_shards=2, for_train=True),
], ids=["local", "cells"])
def test_host_shard_equals_jax(world, flags):
    """batchify(host_shard=(r, W)) gives the JAX package's arrays for every
    rank r: the row arrays filled for r's rows only, the relation bank,
    the local banks and the sizes from every row."""
    n = 8
    jg, jt = jax_corpus(n, seed=4)
    pg, pt = synthetic_amr_corpus(n, seed=4)
    if flags.get("cp_shards"):
        jg, jt = jax_corpus(n, seed=4, min_nodes=30, max_nodes=120)
        pg, pt = synthetic_amr_corpus(n, seed=4, min_nodes=30,
                                      max_nodes=120)
    ji, jv = jax_preprocess(jg, jt), jax_build_vocabs(jg, jt)
    pi, pv = preprocess(pg, pt), build_vocabs(pg, pt)
    spec = dict(nodes=(256,)) if flags.get("cp_shards") else {}
    for r in range(world):
        ja = jax_batchify(ji, *jv, spec=JaxBucketSpec(**spec),
                          batch_size_bucket=n, host_shard=(r, world),
                          **flags)
        pb = batchify(pi, *pv, spec=BucketSpec(**spec), batch_size_bucket=n,
                      host_shard=(r, world), **flags)
        pa = pb.arrays()
        _same(ja.arrays(), pa)
        assert pb.oov_lists == ja.oov_lists
        lo, hi = r * n // world, (r + 1) * n // world
        assert pa["concept"][:lo].max(initial=0) == 0
        assert pa["concept"][hi:].max(initial=0) == 0
        assert pa["concept"][lo:hi].max() > 0


# ------------------------------------------------------- the schedules


def _inputs(batch, H=2, Dh=16, seed=3):
    """q, k, v [B, H, N, Dh], banks [P, H, Dh] (0.5 scale) and a cotangent,
    f32 numpy from one seed."""
    B, N = batch.concept_mask.shape
    P = batch.rel_bank.shape[0]
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v, cot = (rng.standard_normal((B, H, N, Dh)).astype(f)
                    for _ in range(4))
    a, b = (0.5 * rng.standard_normal((P, H, Dh)).astype(f)
            for _ in range(2))
    return dict(q=q, k=k, v=v, a=a, b=b, cot=cot)


def _jax_reference(x, one):
    """JAX's single-device sparse attention on the cp_shards=1 cells: out
    and the gradients of sum(out * cot) to q, k, v, a, b."""
    flat = jax_flatten(*(jnp.asarray(getattr(one, k)) for k in (
        "edge_src", "edge_dst", "edge_rel", "edge_mask")),
        num_nodes=x["q"].shape[2])

    def f(q, k, v, a, b):
        out = jax_sparse(q, k, v, a, b, *flat)
        return (out * x["cot"]).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(
        *(jnp.asarray(x[k]) for k in "qkvab"))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _hold(got, ref, names="out dq dk dv g_a g_b".split()):
    np.testing.assert_allclose(got[0], ref[0], **OUT_TOL, err_msg=names[0])
    for name, g, r in zip(names[1:], got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, **GRAD_TOL, err_msg=name)


@pytest.fixture(scope="module")
def reference(cells):
    S, _, jone, pcp, _ = cells
    x = _inputs(pcp)
    return x, _jax_reference(x, jone)


def _tensors(x):
    return [torch.from_numpy(x[k]).requires_grad_() for k in "qkvab"]


def _cells(batch, *names):
    return [torch.from_numpy(getattr(batch, n)) for n in names]


EDGES = ("edge_src", "edge_dst", "edge_rel", "edge_mask")
CTILES = ("ctile_src", "ctile_rel", "ctile_dst", "ctile_rel_src")


@pytest.mark.parametrize("schedule", ["ring", "a2a"])
def test_emulated_edge_schedules_match_jax(cells, reference, schedule):
    """The edge-cell ring and a2a of S ranks in one process (the loops the
    distributed modules run) against the JAX package's
    single-device sparse attention: output and every gradient."""
    S, _, _, pcp, _ = cells
    x, ref = reference
    leaves = _tensors(x)
    fn = (ring_attention.emulate_ring if schedule == "ring"
          else a2a_attention.emulate_a2a)
    out = fn(*leaves, *_cells(pcp, *EDGES), S)
    grads = torch.autograd.grad((out * torch.from_numpy(x["cot"])).sum(),
                                leaves)
    _hold([out.detach().numpy()] + [g.numpy() for g in grads], ref)


@pytest.mark.parametrize("schedule", ["ring", "a2a"])
def test_edge_schedules_round_bf16_gradients_once(cells, reference,
                                                  schedule):
    """The edge schedules compute in f32, the exchanges too: with bf16
    inputs the output and every gradient are the bits of the same
    schedule on the same values in f32, the gradients rounded once to
    bf16 (no gradient is summed in bf16)."""
    S, _, _, pcp, _ = cells
    x, _ = reference
    fn = (ring_attention.emulate_ring if schedule == "ring"
          else a2a_attention.emulate_a2a)
    cot = torch.from_numpy(x["cot"]).bfloat16()
    runs = []
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [torch.from_numpy(x[k]).bfloat16().to(dtype)
                  .requires_grad_() for k in "qkvab"]
        out = fn(*leaves, *_cells(pcp, *EDGES), S)
        runs.append([out] + list(torch.autograd.grad(
            out, leaves, cot.to(out.dtype))))
    (out16, *g16), (out32, *g32) = runs
    assert torch.equal(out16, out32)
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.bfloat16())


def test_emulated_ring_block_sparse_matches_jax(cells, reference):
    """The ring with B5s per step and the B6 reverse ring (plain versions
    on the CPU), S ranks in one process, against the JAX package's
    single-device sparse attention on the same pairs."""
    S, _, _, pcp, _ = cells
    x, ref = reference
    got = ring_block_sparse.emulate(
        *(torch.from_numpy(x[k]) for k in "qkvab"),
        *_cells(pcp, *CTILES[:2]), S, *_cells(pcp, *CTILES[2:]),
        g_out=torch.from_numpy(x["cot"]))
    _hold([t.numpy() for t in got], ref)


def test_planted_wrong_merge_fails(cells, reference):
    """A merge without the alpha rescale of the running partials (the
    planted fault chip_smoke's gate must catch) misses the reference."""
    S, _, _, pcp, _ = cells
    x, ref = reference

    def no_alpha(state, out_t, m_t, l_t):
        m, l, o = state
        new_m = torch.maximum(m, m_t)
        beta = torch.where(l_t > 0, torch.exp(m_t - new_m), 0.0)
        return (new_m, l + l_t * beta,
                o + out_t.float() * (l_t * beta)[..., None])

    out = ring_block_sparse.emulate(
        *(torch.from_numpy(x[k]) for k in "qkvab"),
        *_cells(pcp, *CTILES[:2]), S, merge_fn=no_alpha)
    assert not np.allclose(out.numpy(), ref[0], **OUT_TOL)


def test_ring_block_sparse_empty_cell():
    """A cell with no kept pair at all (and rows with none in any cell):
    B5s gives its rows m = -1e9, l = 0, the merge weighs them 0, the
    final division leaves those rows 0, and the gradients match the JAX
    package's sparse attention on the same pairs."""
    B, N, S, P, H, Dh = 2, 256, 2, 40, 2, 16
    rng = np.random.default_rng(11)
    keep = rng.random((B, N, N)) < 0.03
    keep[:, :128, 128:] = False           # cell (0, 1) empty
    keep[:, 5] = False                    # node 5: no incoming pair
    rel = rng.integers(1, P, (B, N, N)).astype(np.int32)
    cts, ctr = bs.pack_block_sparse_cells(keep, rel, S)
    ctd, ctrs = bs.pack_block_sparse_cells_src(keep, rel, S)
    assert (cts[:, 0, 1] < 0).all()
    ii = [np.nonzero(keep[b]) for b in range(B)]
    E = max(len(i) for i, _ in ii)
    dst, src, rr, mask = (np.zeros((B, E), t) for t in
                          (np.int32, np.int32, np.int32, bool))
    for b, (i, j) in enumerate(ii):
        dst[b, :len(i)], src[b, :len(i)] = i, j
        rr[b, :len(i)], mask[b, :len(i)] = rel[b, i, j], True
    f = np.float32
    x = {k: rng.standard_normal((B, H, N, Dh)).astype(f) for k in "qkv"}
    x.update({k: 0.5 * rng.standard_normal((P, H, Dh)).astype(f)
              for k in "ab"}, cot=rng.standard_normal((B, H, N, Dh))
             .astype(f))

    def f_ref(q, k, v, a, b):
        out = jax_sparse(q, k, v, a, b, *(jnp.asarray(t) for t in
                                          (src, dst, rr, mask)))
        return (out * x["cot"]).sum(), out

    (_, out), grads = jax.value_and_grad(f_ref, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(
        *(jnp.asarray(x[k]) for k in "qkvab"))
    got = ring_block_sparse.emulate(
        *(torch.from_numpy(x[k]) for k in "qkvab"),
        *(torch.from_numpy(t) for t in (cts, ctr)), S,
        *(torch.from_numpy(t) for t in (ctd, ctrs)),
        g_out=torch.from_numpy(x["cot"]))
    assert (got[0][:, :, 5] == 0).all()
    _hold([t.numpy() for t in got],
          [np.asarray(out)] + [np.asarray(g) for g in grads])


def test_distributed_schedules_match_jax(cells, reference, tmp_path):
    """On S spawned gloo ranks (graph = S): the edge-cell ring, a2a, the
    B5s/B6 ring and its edge-cell backward (a batch without the src-major
    cells) each give every rank the whole output and the whole gradients
    of the JAX package's single-device sparse attention."""
    S, _, _, pcp, _ = cells
    x, ref = reference
    path = tmp_path / "cp.npz"
    np.savez(path, **x, **{k: getattr(pcp, k) for k in EDGES + CTILES})
    schedules = (["ring", "a2a", "block_sparse", "block_sparse_edge_bwd"]
                 if S == 2 else ["ring", "block_sparse"])
    results = ranks.spawn("cp_attention", S, tmp_path, path=str(path),
                          schedules=schedules)
    for per_rank in results:
        for schedule in schedules:
            _hold(per_rank[schedule], ref)
