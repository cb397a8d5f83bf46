"""The PyTorch port's sparse tier against the JAX package's, on the CPU: the
tile packing, the sparse batches (edge cells, tile layouts, k-hop pruning,
"auto"'s tile fallback), the edge-list attention and its gradients, the
plain versions of the block-sparse kernels B5/B5s and B6 against the Pallas
kernels in interpret mode, and the whole model under "block_sparse" and
"sparse". Inputs are seeded numpy arrays handed to both packages; each
tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.data import DataLoader as JaxDataLoader
from gtos_tpu.data.batching import BucketSpec as JaxBucketSpec
from gtos_tpu.data.batching import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_corpus
from gtos_tpu.models import Generator as JaxGenerator
from gtos_tpu.ops import segment as jax_segment
from gtos_tpu.ops.block_sparse import pack_block_sparse as jax_pack
from gtos_tpu.ops.block_sparse import pack_block_sparse_src as jax_pack_src
from gtos_tpu.ops.pallas.block_sparse_attention import (
    _blk_vjp_pallas, block_sparse_relation_attention as jax_blk,
    block_sparse_relation_attention_trainable as jax_blk_trainable,
)
from gtos_tpu.ops.sparse_relation import (
    flatten_edge_cells as jax_flatten,
    sparse_relation_attention as jax_sparse_attention,
)
from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu_torch.convert import state_dict_from_flax
from gtos_tpu_torch.data import BucketSpec, DataLoader, batchify
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.generator import batch_to_device
from gtos_tpu_torch.ops import segment
from gtos_tpu_torch.ops.block_sparse import (
    keep_from_edge_cells, pack_block_sparse, pack_block_sparse_src,
)
from gtos_tpu_torch.ops.block_sparse_attention import (
    block_sparse_attention, block_sparse_attention_with_stats,
    block_sparse_relation_attention_trainable, tile_pairs,
)
from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
    BANK_CHUNK, PAIR_CAP, SHORT_RUN, backward_plan, bank_work,
    block_sparse_bank_grads_reference, pair_cap, pair_capacity, real_pairs,
    work_bounds, work_list_covers,
)
from gtos_tpu_torch.ops.sparse_relation import (
    flatten_edge_cells, sparse_relation_attention,
)
from gtos_tpu_torch.train.trainer import check_metrics
from gtos_tpu_torch.utils.config import ModelConfig
from test_torch_cuda import make_block_case, port_block_args

torch.set_num_threads(2)

GRADS = ("q", "k", "v", "a_bank", "b_bank")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jax_args(c):
    return (*(jnp.asarray(c[n]) for n in ("q", "k", "v", "a_bank",
                                          "b_bank")),
            jnp.asarray(c["tile_src"]), jnp.asarray(c["tile_rel"]))


def _same_arrays(ja, pa, keys=None):
    assert ja.keys() == pa.keys()
    for k in keys or ja:
        assert ja[k].dtype == pa[k].dtype, k
        np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)


# ---------------------------------------------------------------- packing


@pytest.mark.parametrize("N,p_pair,banded", [(256, 0.02, False),
                                             (512, 0.1, True),
                                             (128, 1.0, False)])
def test_packing_equals_jax(N, p_pair, banded):
    """pack_block_sparse and pack_block_sparse_src give the JAX package's
    arrays, array for array; keep_from_edge_cells inverts batchify's
    cells."""
    c = make_block_case(2, 1, N, 8, 37, p_pair, banded, seed=N)
    keep, rel = c["keep"], c["rel_index"]
    for port, ref in ((pack_block_sparse, jax_pack),
                      (pack_block_sparse_src, jax_pack_src)):
        for a, b in zip(port(keep, rel), ref(keep, rel)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- batches


@pytest.fixture(scope="module")
def corpora():
    """The same synthetic AMR corpus in both packages, graphs of 30-140
    nodes (node buckets 64 to 256), with vocabularies."""
    jg, jt = jax_corpus(10, seed=11, min_nodes=30, max_nodes=140)
    pg, pt = synthetic_amr_corpus(10, seed=11, min_nodes=30, max_nodes=140)
    return ((jax_preprocess(jg, jt), jax_build_vocabs(jg, jt)),
            (preprocess(pg, pt), build_vocabs(pg, pt)))


SPEC = dict(nodes=(64, 128, 256), bank=(1024, 4096, 16384, 65536),
            edge_cells=(1024, 4096, 16384, 65536))


@pytest.mark.parametrize("khop", [0, 2, 4])
@pytest.mark.parametrize("for_train", [False, True])
def test_sparse_batches_equal_jax(corpora, khop, for_train):
    """batchify with build_edges and build_block_tiles=True at sparse_khop
    0, 2 and 4: every array equal to the JAX package's (edge cells, the
    four tile arrays, the bank with pruned paths on the NONE row); the
    edge cells describe the tile layout's kept pairs."""
    (ji, jv), (pi, pv) = corpora
    kw = dict(for_train=for_train, build_edges=True, build_block_tiles=True,
              sparse_khop=khop)
    for sl in (slice(0, 3), slice(5, 8)):
        ja = jax_batchify(ji[sl], *jv, spec=JaxBucketSpec(**SPEC),
                          **kw).arrays()
        pb = batchify(pi[sl], *pv, spec=BucketSpec(**SPEC), **kw)
        pa = pb.arrays()
        assert {"edge_src", "tile_src", "tile_rel_src"} <= pa.keys()
        _same_arrays(ja, pa)
        N = pb.concept_mask.shape[1]
        keep = keep_from_edge_cells(pb.edge_src, pb.edge_dst, pb.edge_mask, N)
        assert int(keep.sum()) == int((pb.tile_rel >= 0).sum())


def test_sparse_dataloader_equals_jax(corpora):
    """The DataLoader passes build_edges, cp_shards, sparse_khop and
    build_block_tiles to batchify: the same plan and arrays as the JAX
    package's loader, over a training epoch with bank-overflow bisects."""
    (ji, jv), (pi, pv) = corpora
    kw = dict(batch_size_tokens=1024, for_train=True, seed=5,
              build_edges=True, cp_shards=1, sparse_khop=4,
              build_block_tiles=True)
    jl = JaxDataLoader(ji, *jv, spec=JaxBucketSpec(
        nodes=SPEC["nodes"], bank=(1024, 2048)), **kw)
    pl = DataLoader(pi, *pv, spec=BucketSpec(nodes=SPEC["nodes"],
                                             bank=(1024, 2048)), **kw)
    jbs, pbs = list(jl.iter_with_instances()), list(pl.iter_with_instances())
    assert len(jbs) == len(pbs) > 2
    for (jb, jg), (pb, pg) in zip(jbs, pbs):
        assert [i.orig_index for i in jg] == [i.orig_index for i in pg]
        _same_arrays(jb.arrays(), pb.arrays())


def test_sparse_khop_needs_a_sparse_consumer(corpora):
    """sparse_khop > 0 without edge cells or tiles is refused, as in the
    JAX package; more than one node block (ported since, ROADMAP A9)
    builds [B, S, S, Ec] cells equal to the JAX package's."""
    (ji, jv), (pi, pv) = corpora
    with pytest.raises(ValueError, match="sparse_khop"):
        batchify(pi[:2], *pv, spec=BucketSpec(**SPEC), sparse_khop=2)
    pb = batchify(pi[:2], *pv, spec=BucketSpec(**SPEC), build_edges=True,
                  cp_shards=2, sparse_khop=2)
    jb = jax_batchify(ji[:2], *jv, spec=JaxBucketSpec(**SPEC),
                      build_edges=True, cp_shards=2, sparse_khop=2)
    assert pb.edge_src.shape[1:3] == (2, 2)
    _same_arrays(jb.arrays(), pb.arrays())


# ---------------------------------------------------- edge-list attention


def _edge_case(seed=0, B=2, H=2, N=24, D=8, P=30, E=100):
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v = (rng.standard_normal((B, H, N, D)).astype(f) for _ in range(3))
    a, b = ((rng.standard_normal((P, H, D)) * 0.5).astype(f)
            for _ in range(2))
    src = rng.integers(0, N, (B, E)).astype(np.int32)
    dst = rng.integers(0, N - 4, (B, E)).astype(np.int32)  # 4 empty rows
    rel = rng.integers(0, P, (B, E)).astype(np.int32)
    mask = rng.random((B, E)) < 0.8
    return [q, k, v, a, b], [src, dst, rel, mask]


def test_sparse_relation_attention_matches_jax():
    """The edge-list attention and its gradients (q, k, v, banks) against
    the JAX package's (XLA) on the same edges, in f32 to 1e-5 (sums in
    another order); nodes without an incoming edge give 0."""
    xs, edges = _edge_case()
    g = np.random.default_rng(1).standard_normal(
        xs[0].shape).astype(np.float32)
    jedges = [jnp.asarray(e) for e in edges]
    jout, jvjp = jax.vjp(lambda *x: jax_sparse_attention(*x, *jedges),
                         *(jnp.asarray(x) for x in xs))
    leaves = [_t(x).requires_grad_() for x in xs]
    out = sparse_relation_attention(*leaves, *(_t(e) for e in edges))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    assert float(out[:, :, -4:].abs().max()) == 0.0
    grads = torch.autograd.grad(out, leaves, _t(g))
    for name, x, y in zip(GRADS, grads, jvjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    cells = [e.reshape(2, 1, 1, -1) for e in edges]
    cells = [cells[0], cells[1], cells[2], cells[3]]
    for x, y in zip(flatten_edge_cells(*(_t(c) for c in cells), 24),
                    jax_flatten(*(jnp.asarray(c) for c in cells), 24)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_segment_ops_match_jax():
    """SDDMM, segment softmax, SpMM and the pipeline of ops/segment.py
    against the JAX package's on one dst-sorted edge list, f32 to 1e-6."""
    rng = np.random.default_rng(2)
    N, D, E = 12, 8, 40
    q, k, v = (rng.standard_normal((N, D)).astype(np.float32)
               for _ in range(3))
    dst = np.sort(rng.integers(0, N - 2, E)).astype(np.int32)
    src = rng.integers(0, N, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    w = rng.random(E).astype(np.float32)
    J = {n: jnp.asarray(x) for n, x in dict(q=q, k=k, v=v, src=src, dst=dst,
                                            mask=mask, w=w).items()}
    P = {n: _t(x) for n, x in dict(q=q, k=k, v=v, src=src, dst=dst,
                                   mask=mask, w=w).items()}
    pairs = [
        (segment.sparse_sddmm(P["q"], P["k"], P["src"], P["dst"], P["mask"]),
         jax_segment.sparse_sddmm(J["q"], J["k"], J["src"], J["dst"],
                                  J["mask"])),
        (segment.segment_softmax(P["w"], P["dst"], N),
         jax_segment.segment_softmax(J["w"], J["dst"], N)),
        (segment.sparse_spmm(P["w"], P["v"], P["src"], P["dst"], N),
         jax_segment.sparse_spmm(J["w"], J["v"], J["src"], J["dst"], N)),
        (segment.sparse_graph_attention(P["q"], P["k"], P["v"], P["src"],
                                        P["dst"], P["mask"], N),
         jax_segment.sparse_graph_attention(J["q"], J["k"], J["v"], J["src"],
                                            J["dst"], J["mask"], N))]
    for x, y in pairs:
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------ block-sparse B5, B5s, B6


@pytest.mark.parametrize("N,p_pair,banded", [(128, 1.0, False),
                                             (128, 0.3, False),
                                             (256, 0.05, False),
                                             (512, 0.2, True)])
def test_b5_plain_matches_pallas_interpret(N, p_pair, banded):
    """B5's and B5s's plain versions against the Pallas kernel in interpret
    mode (B=2/1, H=2, Dh=32, P=200; the banded N=512 case has empty tiles),
    f32 to 2e-4 (the JAX test's own); B5s's m and l agree with the Pallas
    stats (laid out [B, Td, H, 128] there) at every row with a kept pair
    to 1e-5."""
    B = 1 if banded else 2
    c = make_block_case(B, 2, N, 32, 200, p_pair, banded, seed=N)
    args = port_block_args(c)[0]
    jout, jm, jl = jax_blk(*_jax_args(c), interpret=True, with_stats=True)
    out = block_sparse_attention(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4,
                               atol=2e-4)
    out_s, m, l = block_sparse_attention_with_stats(*args)
    assert torch.equal(out, out_s)
    to_bhn = lambda x: np.asarray(x).transpose(0, 2, 1, 3).reshape(  # noqa
        B, 2, -1)[:, :, :N]
    jm, jl = to_bhn(jm), to_bhn(jl)
    kept = jl > 0
    np.testing.assert_array_equal(l.numpy() > 0, kept)
    np.testing.assert_allclose(m.numpy()[kept], jm[kept], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy()[kept], jl[kept], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("N,p_pair", [(128, 0.4), (256, 0.05)])
def test_b6_plain_matches_pallas_vjp(N, p_pair):
    """The trainable entry's backward (B6d, B6s, B6b's plain versions)
    against jax.vjp of the Pallas forward and two-pass backward
    (`_blk_vjp_pallas`, interpret mode) with the same cotangent: gradients
    to q, k, v and both banks at rtol 2e-3, atol 2e-4 (the JAX test's
    own)."""
    c = make_block_case(2, 2, N, 32, 200, p_pair, seed=4)
    args, (td, trs), g = port_block_args(c)
    leaves = [x.clone().requires_grad_() for x in args[:5]]
    out = block_sparse_relation_attention_trainable(
        *leaves, *args[5:], tile_dst=td, tile_rel_src=trs)
    grads = torch.autograd.grad(out, leaves, g)
    ja = _jax_args(c)
    _, vjp = jax.vjp(lambda *x: _blk_vjp_pallas(
        True, *x, *ja[5:], jnp.asarray(c["tile_dst"]),
        jnp.asarray(c["tile_rel_src"])), *ja[:5])
    for name, x, y in zip(GRADS, grads, vjp(jnp.asarray(c["g"]))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def test_edge_list_backward_fallback_matches_jax():
    """Without the src-major layout the trainable entry runs B5 forward and
    autograd of the edge-list attention over the flat COO edges (the JAX
    package's `_blk_vjp`): gradients against the JAX entry's, f32 to
    1e-5."""
    c = make_block_case(2, 2, 128, 16, 60, 0.3, seed=9)
    keep, rel = c["keep"], c["rel_index"]
    bi, ii, jj = np.nonzero(keep)
    E = max(int((bi == b).sum()) for b in range(2))
    edges = [np.zeros((2, E), np.int32) for _ in range(3)]
    mask = np.zeros((2, E), bool)
    for b in range(2):
        s = bi == b
        n = int(s.sum())
        edges[0][b, :n], edges[1][b, :n] = jj[s], ii[s]
        edges[2][b, :n], mask[b, :n] = rel[b, ii[s], jj[s]], True
    args, _, g = port_block_args(c)
    leaves = [x.clone().requires_grad_() for x in args[:5]]
    out = block_sparse_relation_attention_trainable(
        *leaves, *args[5:], *(_t(e) for e in edges), _t(mask))
    grads = torch.autograd.grad(out, leaves, g)
    ja = _jax_args(c)
    jedges = [jnp.asarray(e) for e in (*edges, mask)]
    _, vjp = jax.vjp(lambda *x: jax_blk_trainable(
        *x, *ja[5:], *jedges, interpret=True), *ja[:5])
    for name, x, y in zip(GRADS, grads, vjp(jnp.asarray(c["g"]))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_tile_layout_mismatch_is_rejected():
    """A tile layout made for another node count is refused with the JAX
    package's ValueError, before any work."""
    c = make_block_case(1, 2, 128, 16, 32, 0.2, seed=5)
    q, k, v, a, b, ts, tr = port_block_args(c)[0]
    two = lambda x: torch.cat([x, x], dim=2)  # noqa: E731
    with pytest.raises(ValueError, match="tile layout"):
        block_sparse_attention(two(q), two(k), two(v), a, b, ts, tr)
    with pytest.raises(ValueError, match="tile_rel shape"):
        block_sparse_attention(q, k, v, a, b, ts, tr[..., :64, :])


def test_backward_plan_src_major_order():
    """backward_plan's src-major order on N=200 layouts with -1 slots (the
    second graph keeps no pair outside its diagonal blocks): dst2src is a
    permutation that takes every dst-major pair id to the place of the same
    (graph, i, j, r) among tile_pairs of the transposed planes, and each
    plane row's base in both orders is the count of the kept pairs before
    it; layouts that hold different pairs are refused."""
    c = make_block_case(2, 1, 200, 8, 37, 0.05, seed=11)
    keep, rel = c["keep"], c["rel_index"]
    keep[1, :128, 128:] = keep[1, 128:, :128] = False
    kp = np.zeros((2, 256, 256), bool)
    kp[:, :200, :200] = keep
    rp = np.zeros((2, 256, 256), np.int32)
    rp[:, :200, :200] = rel
    ts, tr = (_t(x) for x in pack_block_sparse(kp, rp))
    td, trs = (_t(x) for x in pack_block_sparse_src(kp, rp))
    assert bool((ts < 0).any()) and bool((td < 0).any())
    plan = backward_plan(ts, tr, td, trs, 200, 37, pair_capacity(tr))
    *dst, valid = tile_pairs(ts, tr, 200, 37)
    sb, sj, si, sr, svalid = tile_pairs(td, trs, 200, 37)
    E = int(plan["E"])
    d2s = plan["dst2src"].long()[:E]
    assert E == int(keep.sum())
    assert torch.equal(torch.sort(d2s)[0], torch.arange(E))
    for x, y in zip(dst, (sb, si, sj, sr)):
        assert torch.equal(x, y[d2s])
    for key, v in (("row_base", valid), ("src_row_base", svalid)):
        counts = v.sum(-1).flatten()
        assert plan[key].dtype == torch.int32
        assert plan[key].shape == v.shape[:-1]
        assert torch.equal(plan[key].flatten().long(),
                           torch.cumsum(counts, 0) - counts)
    trs[trs >= 0] = -1
    with pytest.raises(ValueError, match="src-major"):
        backward_plan(ts, tr, td, trs, 200, 37, pair_capacity(tr))


def test_bank_work_list():
    """bank_work on runs of every kind: the runs of at most SHORT_RUN pairs
    whole, longest first (ties in run order); the longer ones cut into
    BANK_CHUNK-pair chunks, contiguous and in order, a slot each (on
    consecutive slots) where a run has several and -1 where it has one;
    `multi` naming each run of several chunks with its slots."""
    lens = np.array([1, 40, 600, 32, 33, 256, 257, 5, 32])
    rows = np.arange(len(lens)) * 3 + 1
    chunks, shorts, multi = bank_work(rows, lens)
    start = np.cumsum(lens) - lens
    assert [tuple(x) for x in shorts] == [
        (start[i], lens[i], rows[i], 0) for i in (3, 8, 7, 0)]
    want, slot = [], 0
    for i in (1, 2, 4, 5, 6):
        n = -(-lens[i] // BANK_CHUNK)
        for c in range(n):
            lo = start[i] + c * BANK_CHUNK
            want.append((lo, min(BANK_CHUNK, start[i] + lens[i] - lo),
                         rows[i], slot + c if n > 1 else -1))
        slot += n if n > 1 else 0
    assert [tuple(x) for x in chunks] == want
    assert [tuple(x) for x in multi] == [(0, 3, rows[2], 0),
                                         (3, 2, rows[6], 0)]
    assert all(x.dtype == np.int32 and x.shape[1:] == (4,)
               for x in (chunks, shorts, multi))
    empty = bank_work(np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert [x.shape for x in empty] == [(0, 4)] * 3


def test_backward_plan_bank_work():
    """backward_plan's bank-row order and B6b work list on a layout with a
    run of ~4k pairs (a third of the pairs on bank row 0) and rows no pair
    references: pid is the stable sort of the pairs by bank row, qrow and
    krow follow it; the chunks and short runs cover every sorted place
    once, each holding only its bank row's pairs; bank_used marks the
    referenced rows; and walking the list as B6b does (each item's sums,
    the several-chunk runs' partial sums added in chunk order) gives the
    plain version's bank gradients."""
    c = make_block_case(2, 2, 256, 16, 300, 0.1, seed=3, rows=200, hot=0.3)
    (q, k, _, a, b, ts, tr), (td, trs), _ = port_block_args(c)
    plan = backward_plan(ts, tr, td, trs, 256, 300, pair_capacity(tr))
    bi, i, j, r = real_pairs(plan)
    E = len(r)
    pid = plan["pid"].long()[:E]
    assert torch.equal(pid, torch.argsort(r, stable=True))
    assert torch.equal(plan["qrow"].long()[:E], (bi * 256 + i)[pid])
    assert torch.equal(plan["krow"].long()[:E], (bi * 256 + j)[pid])
    rs = r[pid]
    counts = plan["bank_counts"].tolist()
    chunks, shorts, multi = (plan[n][:c] for n, c in zip(
        ("bank_chunks", "bank_shorts", "bank_multi"), counts))
    assert int((chunks[:, 1] > SHORT_RUN).sum()) > 0 and len(multi) > 0
    assert bool((shorts[:, 1] <= SHORT_RUN).all())
    assert bool((chunks[:, 1] <= BANK_CHUNK).all())
    seen = torch.zeros(E, dtype=torch.int64)
    for lo, n, row, _ in torch.cat([chunks, shorts]).tolist():
        seen[lo:lo + n] += 1
        assert bool((rs[lo:lo + n] == row).all())
    assert bool((seen == 1).all())
    used = torch.zeros(300, dtype=torch.uint8)
    used[r] = 1
    assert torch.equal(plan["bank_used"], used)
    assert counts[3] == int(multi[:, 1].sum()) <= plan["bank_slots"]
    # B6b's walk over the list, in f32
    geq = torch.randn(2, E).T.float()                           # [E, H]
    H, Dh = q.shape[1], q.shape[3]
    qr, kr = q[bi, :, i][pid], k[bi, :, j][pid]                 # [E, H, Dh]
    w = geq[pid][..., None]

    def sums(lo, n):
        return (w[lo:lo + n] * qr[lo:lo + n]).sum(0), \
            (w[lo:lo + n] * kr[lo:lo + n]).sum(0), w[lo:lo + n, :, 0].sum(0)
    g_a = torch.zeros(300, H, Dh)
    g_b = torch.zeros(300, H, Dh)
    part = [None] * counts[3]

    def write(row, sq, sk, dt4):
        g_b[row] = sq + dt4[:, None] * a[row]
        g_a[row] = sk + dt4[:, None] * b[row]
    for lo, n, row, slot in chunks.tolist():
        if slot >= 0:
            part[slot] = sums(lo, n)
        else:
            write(row, *sums(lo, n))
    for lo, n, row, _ in shorts.tolist():
        write(row, *sums(lo, n))
    for first, n, row, _ in multi.tolist():
        write(row, *(sum(p[x] for p in part[first:first + n])
                     for x in range(3)))
    ref_a, ref_b = block_sparse_bank_grads_reference(q, k, a, b, geq.T,
                                                     plan)
    # f32 sums of up to ~4k terms of size ~1 in another order
    torch.testing.assert_close(g_a, ref_a, rtol=1e-5, atol=5e-4)
    torch.testing.assert_close(g_b, ref_b, rtol=1e-5, atol=5e-4)


# ------------------------------------------- the capturable backward plan


def _case(kind, seed=0):
    """A block-sparse case of one kind of bank-row runs: "multi" (a third
    of the pairs on bank row 0, a run of ~4k pairs, over 2 BANK_CHUNK),
    "shorts" (every row's run at most SHORT_RUN pairs), "dense" (every
    pair of both graphs kept: E = 2 * 128^2, a power of two, so the
    batch's pair capacity is E itself) and "empty" (no pair kept)."""
    if kind == "multi":
        return make_block_case(2, 2, 128, 16, 300, 0.4, seed=seed, rows=200,
                               hot=0.3)
    if kind == "shorts":
        return make_block_case(1, 2, 128, 16, 1000, 0.03, seed=seed)
    c = make_block_case(2, 2, 128, 16, 50, 1.0, seed=seed)
    c["keep"][:] = kind == "dense"
    c["tile_src"], c["tile_rel"] = pack_block_sparse(c["keep"],
                                                     c["rel_index"])
    c["tile_dst"], c["tile_rel_src"] = pack_block_sparse_src(
        c["keep"], c["rel_index"])
    return c


def _todays_plan(ts, tr, td, trs, N, P):
    """The plan's real part built the way it was before it could be
    captured (nonzero, unique_consecutive and numpy bank_work on the
    host), as the reference for the padded plan's real prefix."""
    bi, i, j, r, valid = tile_pairs(ts, tr, N, P)
    sb, sj, si, sr, svalid = tile_pairs(td, trs, N, P)
    skey = (sb * N + si) * N + sj
    by_key = torch.argsort(skey)
    at = torch.searchsorted(skey[by_key], (bi * N + i) * N + j)
    order = torch.argsort(r, stable=True)
    run_r, run_len = torch.unique_consecutive(r[order], return_counts=True)

    def base(v):
        n = v.sum(-1).flatten()
        return (torch.cumsum(n, 0) - n).view(v.shape[:-1])
    used = torch.zeros(P, dtype=torch.uint8)
    used[run_r] = 1
    return dict(row_base=base(valid), src_row_base=base(svalid),
                dst2src=by_key[at], pid=order, qrow=(bi * N + i)[order],
                krow=(bi * N + j)[order], bank_used=used,
                work=bank_work(run_r.numpy(), run_len.numpy()))


@pytest.mark.parametrize("kind", ["multi", "shorts", "dense", "empty"])
def test_padded_plan_keeps_todays_order_and_matches_jax(kind):
    """backward_plan at the batch's pair capacity (pair_capacity: a power
    of two, E itself for "dense", 1 for "empty"): its shapes follow from
    the layouts, P and the capacity alone; the real prefix of row_base,
    src_row_base, dst2src, pid, qrow, krow and bank_used equals the
    host-built plan's element for element; the work list's real entries
    equal numpy bank_work's, its padding entries are no-ops ((0, 0, P, -1)
    chunks, (0, 0, P, 0) shorts and multi) and work_list_covers holds it;
    and the trainable entry's backward, whose plain B6b sums the padded
    pairs, gives jax.vjp of the Pallas kernels' (interpret mode) gradients
    at rtol 2e-3, atol 2e-4 (test_b6_plain_matches_pallas_vjp's)."""
    c = _case(kind, seed=5)
    args, (td, trs), g = port_block_args(c)
    N, P = c["q"].shape[2], c["a_bank"].shape[0]
    cap = pair_capacity(c["tile_rel"])
    plan = backward_plan(args[5], args[6], td, trs, N, P, cap)
    ref = _todays_plan(args[5], args[6], td, trs, N, P)
    E = int(plan["E"])
    assert E == int(c["keep"].sum()) and bool(plan["ok"])
    assert cap == {"dense": E, "empty": 1}.get(kind, cap) and E <= cap
    runs, n_chunks, n_multi, slots = work_bounds(cap, P)
    for key, shape in (("dst2src", (cap,)), ("pid", (cap,)),
                       ("qrow", (cap,)), ("krow", (cap,)),
                       ("bank_chunks", (n_chunks, 4)),
                       ("bank_shorts", (runs, 4)),
                       ("bank_multi", (n_multi, 4)), ("bank_used", (P,))):
        assert tuple(plan[key].shape) == shape, key
    assert plan["cap"] == cap and plan["bank_slots"] == slots
    for key in ("row_base", "src_row_base", "bank_used"):
        assert torch.equal(plan[key].long(), ref[key].long()), key
    for key in ("dst2src", "pid", "qrow", "krow"):
        assert torch.equal(plan[key][:E].long(), ref[key]), key
    counts = plan["bank_counts"].tolist()
    names = ("bank_chunks", "bank_shorts", "bank_multi")
    for name, n, want, pad in zip(names, counts, ref["work"],
                                  ([0, 0, P, -1], [0, 0, P, 0],
                                   [0, 0, P, 0])):
        assert n == len(want), name
        np.testing.assert_array_equal(plan[name][:n].numpy(), want, name)
        assert bool((plan[name][n:] == torch.tensor(pad)).all()), name
    assert counts[3] == int(ref["work"][2][:, 1].sum())
    assert bool(work_list_covers(plan, P))
    if kind == "multi":
        assert counts[2] > 0 and int(ref["work"][2][:, 1].max()) > 2
    if kind == "shorts":
        assert counts[0] == 0 and counts[1] > 0
    leaves = [x.clone().requires_grad_() for x in args[:5]]
    out = block_sparse_relation_attention_trainable(
        *leaves, *args[5:], tile_dst=td, tile_rel_src=trs, plan=plan)
    grads = torch.autograd.grad(out, leaves, g)
    ja = _jax_args(c)
    _, vjp = jax.vjp(lambda *x: _blk_vjp_pallas(
        True, *x, *ja[5:], jnp.asarray(c["tile_dst"]),
        jnp.asarray(c["tile_rel_src"])), *ja[:5])
    for name, x, y in zip(GRADS, grads, vjp(jnp.asarray(c["g"]))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def test_padded_plan_shapes_follow_the_signature():
    """Two batches of one signature (layout shapes, P, pair capacity) but
    different kept pairs give plans whose tensors have equal shapes and
    dtypes, and the plain B6b over the padded plan equals the plain B6b
    over the same plan cut to exactly E slots (the padding summed
    nowhere); a src-major layout that holds other pairs, and a capacity
    below E, raise ValueError at once on the CPU."""
    plans, cases = [], []
    for seed in (1, 2):
        c = make_block_case(2, 2, 256, 16, 300, 0.1, seed=seed)
        (q, k, _, a, b, ts, tr), (td, trs), _ = port_block_args(c)
        plans.append(backward_plan(ts, tr, td, trs, 256, 300, 16384))
        cases.append((q, k, a, b, ts, tr, td, trs))
    assert int(plans[0]["E"]) != int(plans[1]["E"])
    for key, x in plans[0].items():
        y = plans[1][key]
        for u, w in zip(*((x, y) if key == "pairs" else ((x,), (y,)))):
            if isinstance(u, torch.Tensor):
                assert u.shape == w.shape and u.dtype == w.dtype, key
            else:
                assert u == w, key
    q, k, a, b, ts, tr, td, trs = cases[0]
    plan = plans[0]
    E = int(plan["E"])
    tight = backward_plan(ts, tr, td, trs, 256, 300, E)
    ge = torch.randn(2, 16384)
    for x, y in zip(block_sparse_bank_grads_reference(q, k, a, b, ge, plan),
                    block_sparse_bank_grads_reference(q, k, a, b, ge[:, :E],
                                                      tight)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="capacity"):
        backward_plan(ts, tr, td, trs, 256, 300, E - 1)
    trs = trs.clone()
    trs[0, 0, 0, 5, 5] = 7 if int(trs[0, 0, 0, 5, 5]) != 7 else 8
    with pytest.raises(ValueError, match="src-major"):
        backward_plan(ts, tr, td, trs, 256, 300, 16384)


def _broken(plan, fault):
    """The plan with one fault in B6b's work list."""
    counts = plan["bank_counts"].tolist()
    lists = {n: plan[n].clone() for n in ("bank_chunks", "bank_shorts",
                                          "bank_multi", "bank_counts")}
    chunks, shorts = lists["bank_chunks"], lists["bank_shorts"]
    E = int(plan["E"])
    if fault == "last chunk left out":
        chunks[counts[0] - 1, 1] = 0
    elif fault == "padding place read":         # the run ending at E
        for w, n in ((chunks, counts[0]), (shorts, counts[1])):
            end = (w[:n, 0] + w[:n, 1] == E).nonzero()
            w[end, 1] += 1
    elif fault == "a short summed twice":
        shorts[1] = shorts[0]
    elif fault == "wrong row":
        shorts[0, 2] = (shorts[0, 2] + 1) % 300
    elif fault == "padding entry counted":
        lists["bank_counts"][1] += 1
    elif fault == "a slot combined by none":
        lists["bank_multi"][0, 1] -= 1
    return dict(plan, **lists)


@pytest.mark.parametrize("fault", [
    "last chunk left out", "padding place read", "a short summed twice",
    "wrong row", "padding entry counted", "a slot combined by none"])
def test_work_list_check_refuses_a_broken_list(fault):
    """work_list_covers, the check of the work list that the plain B6b
    does not read, holds a sound plan ("multi": chunks, shorts and runs of
    several chunks) and refuses each fault; the plain B6b (from the padded
    pairs) is the same on the broken plan, so the kernel's gate, not the
    plain version, sees a kernel that follows a broken list."""
    c = _case("multi", seed=5)
    (q, k, _, a, b, ts, tr), (td, trs), _ = port_block_args(c)
    plan = backward_plan(ts, tr, td, trs, 128, 300, pair_capacity(tr))
    assert bool(work_list_covers(plan, 300))
    bad = _broken(plan, fault)
    assert not bool(work_list_covers(bad, 300))
    ge = torch.randn(2, plan["cap"])
    for x, y in zip(block_sparse_bank_grads_reference(q, k, a, b, ge, plan),
                    block_sparse_bank_grads_reference(q, k, a, b, ge, bad)):
        assert torch.equal(x, y)


def test_the_pair_capacity_rides_on_train_batches_only(corpora):
    """batch_to_device gives a batch with a src-major tile layout its
    pair capacity as a zero-element [0, E_cap] array (E_cap =
    pair_capacity of tile_rel: a power of two at or above its kept
    entries), which pair_cap reads back; train=False (the search) leaves
    it out, and so does a batch without the src-major layout."""
    _, (pi, pv) = corpora
    pb = batchify(pi[:3], *pv, spec=BucketSpec(**SPEC), for_train=True,
                  build_edges=True, build_block_tiles=True, sparse_khop=2)
    t = batch_to_device(pb.arrays(), "cpu")
    n = int((pb.tile_rel >= 0).sum())
    cap = pair_capacity(pb.tile_rel)
    assert t[PAIR_CAP].shape == (0, cap) and pair_cap(t) == cap
    assert n <= cap < 2 * n and cap & (cap - 1) == 0
    assert PAIR_CAP not in batch_to_device(pb.arrays(), "cpu", train=False)
    plain = batchify(pi[:3], *pv, spec=BucketSpec(**SPEC), for_train=True)
    assert PAIR_CAP not in batch_to_device(plain.arrays(), "cpu")
    with pytest.raises(ValueError, match="pair capacity"):
        pair_cap(batch_to_device(pb.arrays(), "cpu", train=False))


def test_a_false_layout_flag_raises_when_the_metrics_are_read():
    """On the card the plan's layout check is a device flag that the train
    step returns as "layout_ok"; reading a false one raises the plan's
    ValueError, a true or missing one nothing."""
    check_metrics({"loss": torch.tensor(1.0), "layout_ok": torch.tensor(1.0)})
    check_metrics({"loss": torch.tensor(1.0)})
    with pytest.raises(ValueError, match="src-major"):
        check_metrics({"loss": torch.tensor(1.0),
                       "layout_ok": torch.tensor(0.0)})


# ------------------------------------------------------- the whole model


SMALL = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=1,
             char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
             max_oov=16, max_target_len=32, dropout=0.0)


@pytest.fixture(scope="module")
def models():
    """Both packages' models under the block-sparse impl from one flax init
    (f32, dropout 0), and one training batch with edge cells and tiles at
    sparse_khop 2 in each."""
    graphs, targets = jax_corpus(6, seed=3)
    jv = jax_build_vocabs(graphs, targets)
    kw = dict(batch_size_bucket=8, for_train=True, build_edges=True,
              build_block_tiles=True, sparse_khop=2)
    ja = jax_batchify(jax_preprocess(graphs, targets), *jv, **kw).arrays()
    g2, t2 = synthetic_amr_corpus(6, seed=3)
    pa = batchify(preprocess(g2, t2), *build_vocabs(g2, t2), **kw).arrays()
    tv, cv, rv, chv, _ = jv
    cfg = dict(SMALL, token_vocab=len(tv), concept_vocab=len(cv),
               relation_vocab=len(rv), char_vocab=len(chv), sparse_khop=2)
    # the parameter tree is the same under every impl: init without the
    # interpreter, run with it
    params = JaxGenerator(JaxModelConfig(**cfg, attention_impl="xla")).init(
        {"params": jax.random.PRNGKey(0)}, ja, deterministic=True)
    jm = JaxGenerator(JaxModelConfig(**cfg,
                                     attention_impl="block_sparse_interpret"))
    sd = state_dict_from_flax(jax.device_get(params))
    ports = {}
    for impl in ("block_sparse", "sparse"):
        ports[impl] = Generator(ModelConfig(**cfg, attention_impl=impl),
                                device="cpu")
        ports[impl].load_state_dict(sd)
    return jm, params, ja, ports, pa


def _loss_and_grads(model, arrays):
    model.train()
    names, ps = zip(*model.named_parameters())
    loss, _ = model(batch_to_device(arrays, "cpu"))
    return loss, dict(zip(names, torch.autograd.grad(loss, ps)))


def test_generator_block_sparse_matches_jax(models):
    """The c1-scale Generator under "block_sparse" (B5s and B6's plain
    versions in every encoder layer) against the JAX model under
    "block_sparse_interpret" (the Pallas kernels in interpret mode): the
    loss to 1e-5 and every parameter's gradient at rtol 2e-3, atol 2e-4
    (the Pallas backward rounds through its one-hot matmuls)."""
    jm, params, ja, ports, pa = models
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.apply(p, ja, deterministic=True)[0])(params)
    loss, grads = _loss_and_grads(ports["block_sparse"], pa)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = state_dict_from_flax(jax.device_get(jgrads))
    assert set(ref) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def test_port_block_sparse_equals_sparse(models):
    """In the port, "block_sparse" and "sparse" compute one function over
    one pair set: the same loss to 1e-6 and every gradient to 1e-5 (as
    tests/test_block_sparse.py asserts in the JAX package)."""
    *_, ports, pa = models
    lb, gb = _loss_and_grads(ports["block_sparse"], pa)
    ls, gs = _loss_and_grads(ports["sparse"], pa)
    np.testing.assert_allclose(lb.item(), ls.item(), rtol=1e-6)
    for name in gb:
        np.testing.assert_allclose(gb[name].numpy(), gs[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
