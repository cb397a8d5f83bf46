"""The PyTorch port's host pipeline against the JAX package's: the same
synthetic corpora, vocabularies, relation paths and batchify arrays (local
banks included), batch for batch, on the CPU. Everything here is exact
equality: the data layer has no floating point."""

import numpy as np
import pytest
import torch

from gtos_tpu.data import DataLoader as JaxDataLoader
from gtos_tpu.data.batching import BucketSpec as JaxBucketSpec
from gtos_tpu.data.batching import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr2_corpus as jax_amr2
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_amr
from gtos_tpu.data.synthetic import (
    synthetic_dependency_corpus as jax_dependency,
)
from gtos_tpu.graph.amr import AMRParseError as JaxAMRParseError
from gtos_tpu.graph.amr import parse_amr as jax_parse_amr
from gtos_tpu.graph.amr import read_amr_file as jax_read_amr_file
from gtos_tpu.graph.paths import relation_paths as jax_relation_paths
from gtos_tpu_torch.data import BucketSpec, DataLoader, batchify
from gtos_tpu_torch.data.batching import BatchCapacityError, Instance
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs, load_vocabs, save_vocabs
from gtos_tpu_torch.data.synthetic import (
    synthetic_amr2_corpus, synthetic_amr_corpus, synthetic_dependency_corpus,
)
from gtos_tpu_torch.graph.amr import AMRParseError, parse_amr, read_amr_file
from gtos_tpu_torch.graph.paths import relation_paths

torch.set_num_threads(2)


def _same_graphs(jg, pg):
    assert len(jg) == len(pg)
    for a, b in zip(jg, pg):
        assert list(a.nodes) == list(b.nodes)
        assert [tuple(e) for e in a.edges] == [tuple(e) for e in b.edges]


SYNTHETIC = {"amr": (jax_amr, synthetic_amr_corpus, {}),
             "amr2": (jax_amr2, synthetic_amr2_corpus, {}),
             # the translator's trees at the default lengths (4-15 tokens)
             # and at the c4 phase's 10-50
             "dependency": (jax_dependency, synthetic_dependency_corpus, {}),
             "dependency_10_50": (jax_dependency, synthetic_dependency_corpus,
                                  dict(min_len=10, max_len=50))}


@pytest.mark.parametrize("corpus", sorted(SYNTHETIC))
def test_synthetic_corpora_match(corpus):
    """Same random.Random stream, same graphs and targets."""
    jf, pf, kw = SYNTHETIC[corpus]
    (jg, jt), (pg, pt) = jf(40, seed=5, **kw), pf(40, seed=5, **kw)
    _same_graphs(jg, pg)
    assert jt == pt


def test_relation_paths_match():
    """All-pairs shortest-path label sequences, pure Python in both."""
    (jg, _), (pg, _) = jax_amr2(10, seed=2), synthetic_amr2_corpus(10, seed=2)
    for a, b in zip(jg, pg):
        assert jax_relation_paths(a) == relation_paths(b)


@pytest.fixture(scope="module")
def amr2_200():
    jg, jt = jax_amr2(200, seed=0)
    pg, pt = synthetic_amr2_corpus(200, seed=0)
    return (jg, jt), (pg, pt)


def test_vocabs_match_and_round_trip(amr2_200, tmp_path):
    """build_vocabs gives the same tables; save/load keeps them."""
    (jg, jt), (pg, pt) = amr2_200
    jv, pv = jax_build_vocabs(jg, jt), build_vocabs(pg, pt)
    for a, b in zip(jv[:4], pv[:4]):
        assert list(a.itos) == list(b.itos)
    save_vocabs(str(tmp_path), *pv)
    loaded = load_vocabs(str(tmp_path))
    for a, b in zip(pv[:4], loaded[:4]):
        assert list(a.itos) == list(b.itos)
    words = sorted({c for g in pg for c in g.nodes})[:50]
    assert ([jv[4].copy_target(w) for w in words]
            == [loaded[4].copy_target(w) for w in words])


def test_serving_batches_equal_with_local_banks(amr2_200):
    """DataLoader(for_train=False, build_local_banks=True) over
    synthetic_amr2_corpus(200): the same batch plan and every array equal
    (relation bank, pair matrix, bank_map, rel_index_loc, copy ids, ...)."""
    (jg, jt), (pg, pt) = amr2_200
    jv, pv = jax_build_vocabs(jg, jt), build_vocabs(pg, pt)
    kw = dict(batch_size_tokens=1024, for_train=False,
              build_local_banks=True)
    jl = JaxDataLoader(jax_preprocess(jg, jt), *jv, **kw)
    pl = DataLoader(preprocess(pg, pt), *pv, **kw)
    jbs, pbs = list(jl.iter_with_instances()), list(pl.iter_with_instances())
    assert len(jbs) == len(pbs) > 1
    for (jb, ji), (pb, pi) in zip(jbs, pbs):
        assert [i.orig_index for i in ji] == [i.orig_index for i in pi]
        ja, pa = jb.arrays(), pb.arrays()
        assert ja.keys() == pa.keys()
        assert "bank_map" in pa and "rel_index_loc" in pa
        for k in ja:
            assert ja[k].dtype == pa[k].dtype, k
            np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)
        assert jb.oov_lists == pb.oov_lists


def test_training_batches_and_epoch_plans_equal(amr2_200):
    """DataLoader(for_train=True, build_local_banks=True): epochs 1 and 2
    shuffle instances and batches with random.Random(seed*1000003+epoch)
    into the same plans as the JAX package's, and every array of every
    batch is equal, the localize sort auxiliaries loc_perm/loc_bnd
    included (the slot arrays are the serving ones, as in the JAX
    package)."""
    (jg, jt), (pg, pt) = amr2_200
    jv, pv = jax_build_vocabs(jg, jt), build_vocabs(pg, pt)
    kw = dict(batch_size_tokens=1024, for_train=True, build_local_banks=True,
              seed=7)
    jl = JaxDataLoader(jax_preprocess(jg, jt), *jv, **kw)
    pl = DataLoader(preprocess(pg, pt), *pv, **kw)
    plans = []
    for epoch in (1, 2):
        jbs = list(jl.iter_with_instances())
        pbs = list(pl.iter_with_instances())
        assert jl.epoch == pl.epoch == epoch
        assert len(jbs) == len(pbs) > 1
        plans.append([[i.orig_index for i in g] for _, g in pbs])
        for (jb, ji), (pb, pi) in zip(jbs, pbs):
            assert [i.orig_index for i in ji] == [i.orig_index for i in pi]
            ja, pa = jb.arrays(), pb.arrays()
            assert ja.keys() == pa.keys()
            assert {"loc_perm", "loc_bnd", "bank_map"} <= pa.keys()
            for k in ja:
                assert ja[k].dtype == pa[k].dtype, k
                np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)
    assert plans[0] != plans[1]


def test_long_targets_truncated_like_the_reference():
    """A target longer than the last target bucket is cut to T-1 tokens
    without a warning, in both packages."""
    (jg, jt), (pg, pt) = jax_amr(2, seed=1), synthetic_amr_corpus(2, seed=1)
    jt, pt = [t * 40 for t in jt], [t * 40 for t in pt]
    jv, pv = jax_build_vocabs(jg, jt), build_vocabs(pg, pt)
    jb = jax_batchify(jax_preprocess(jg, jt), *jv, for_train=False,
                      spec=JaxBucketSpec(target=(16,)))
    pb = batchify(preprocess(pg, pt), *pv, for_train=False,
                  spec=BucketSpec(target=(16,)))
    assert pb.token_in.shape[1] == 16
    for k, v in jb.arrays().items():
        np.testing.assert_array_equal(v, pb.arrays()[k], err_msg=k)


@pytest.mark.parametrize("flag", [
    dict(build_edges=True), dict(build_block_tiles=True),
    # multi-host row sharding, ported since (A9): the JAX package's arrays
    dict(host_shard=(0, 2)),
    dict(build_local_banks=True, for_train=True, host_shard=(0, 2)),
    # the DataLoader's: batch_multiple must be a multiple of host_count
    dict(loader=dict(host_count=2)),
    # the DataLoader's batch options and pools, ported since (A4)
    dict(loader=dict(batch_multiple=3, max_batch_instances=1, workers=2,
                     worker_mode="thread")),
])
def test_unported_batch_options_raise(flag):
    """The batch options of later slices give the JAX package's arrays,
    never dropping a request silently: the sparse tier's (A8) the edge
    cells or the four tile arrays, host_shard (A9) rank 0's rows of two;
    so do the DataLoader's batch_multiple, max_batch_instances and
    workers (A4): one instance a batch, each padded to 3 rows. The
    DataLoader's host_count=2 without a batch_multiple it divides raises,
    as the JAX package's asserts."""
    g, t = synthetic_amr_corpus(2, seed=0)
    if "loader" in flag:
        kw = dict(for_train=False, **flag["loader"])
        if "host_count" in kw:
            with pytest.raises(ValueError, match="batch_multiple"):
                DataLoader(preprocess(g, t), *build_vocabs(g, t), **kw)
            jg, jt = jax_amr(2, seed=0)
            with pytest.raises(AssertionError, match="batch_multiple"):
                JaxDataLoader(jax_preprocess(jg, jt),
                              *jax_build_vocabs(jg, jt), **kw)
            return
        jg, jt = jax_amr(2, seed=0)
        ref = list(JaxDataLoader(jax_preprocess(jg, jt),
                                 *jax_build_vocabs(jg, jt), **kw))
        got = list(DataLoader(preprocess(g, t), *build_vocabs(g, t), **kw))
        assert len(ref) == len(got) == 2
        for jb, pb in zip(ref, got):
            assert pb.concept.shape[0] == 3
            ja, pa = jb.arrays(), pb.arrays()
            assert ja.keys() == pa.keys()
            for k in ja:
                np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)
        return
    kw = dict(dict(for_train=False), **flag)
    pa = batchify(preprocess(g, t), *build_vocabs(g, t), **kw).arrays()
    jg, jt = jax_amr(2, seed=0)
    ja = jax_batchify(jax_preprocess(jg, jt), *jax_build_vocabs(jg, jt),
                      **kw).arrays()
    assert ja.keys() == pa.keys()
    assert ("edge_src" in pa) == ("build_edges" in flag)
    assert ("tile_rel_src" in pa) == ("build_block_tiles" in flag)
    for k in ja:
        assert ja[k].dtype == pa[k].dtype, k
        np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)


def test_batchify_takes_preprocessed_instances_only():
    """batchify builds the bank from preprocess's interned path ids; an
    Instance with raw nested paths is refused."""
    g, t = synthetic_amr_corpus(1, seed=0)
    inst = Instance(concepts=list(g[0].nodes),
                    pair_paths=relation_paths(g[0]), target=t[0])
    with pytest.raises(ValueError, match="preprocess"):
        batchify([inst], *build_vocabs(g, t), for_train=False)


@pytest.mark.parametrize("for_train", [False, True])
def test_auto_aux_batches_equal(amr2_200, for_train):
    """attention_impl "auto"'s loader flags (the JAX package's CLIs pass
    build_block_tiles="auto" and build_local_banks="auto"; the port's
    DataLoader takes the second, batchify both): local banks at every
    bucket, no tile layouts, and every array of every batch equal to the
    JAX package's (the localize auxiliaries of training batches
    included)."""
    (jg, jt), (pg, pt) = amr2_200
    jv, pv = jax_build_vocabs(jg, jt), build_vocabs(pg, pt)
    kw = dict(batch_size_tokens=2048, for_train=for_train, seed=3,
              build_local_banks="auto")
    jbs = list(JaxDataLoader(jax_preprocess(jg, jt), *jv,
                             build_block_tiles="auto",
                             **kw).iter_with_instances())
    pbs = list(DataLoader(preprocess(pg, pt), *pv,
                          **kw).iter_with_instances())
    assert len(jbs) == len(pbs) > 1
    for (jb, ji), (pb, pi) in zip(jbs, pbs):
        assert [i.orig_index for i in ji] == [i.orig_index for i in pi]
        ja, pa = jb.arrays(), pb.arrays()
        assert ja.keys() == pa.keys()
        assert "bank_map" in pa and "tile_src" not in pa
        for k in ja:
            assert ja[k].dtype == pa[k].dtype, k
            np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)
    both = batchify(pi, *pv, for_train=for_train, build_block_tiles="auto",
                    build_local_banks="auto").arrays()
    ref = jax_batchify(ji, *jv, for_train=for_train,
                       build_block_tiles="auto",
                       build_local_banks="auto").arrays()
    assert both.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], both[k], err_msg=k)


def test_auto_local_bank_overflow():
    """Under "auto", a batch whose per-graph paths overflow the local-bank
    ladder re-raises BatchCapacityError below a tile-aligned bucket (the
    DataLoader bisects it) and, at N % 128 == 0, falls back to the tile
    layouts (no local banks), with arrays equal to the JAX package's."""
    g, t = synthetic_amr_corpus(2, seed=4, min_nodes=20, max_nodes=24)
    vocabs = build_vocabs(g, t)
    kw = dict(for_train=False, build_block_tiles="auto",
              build_local_banks="auto")
    with pytest.raises(BatchCapacityError, match="local bank"):
        batchify(preprocess(g, t), *vocabs,
                 spec=BucketSpec(local_bank=(16,)), **kw)
    pa = batchify(preprocess(g, t), *vocabs,
                  spec=BucketSpec(nodes=(128,), local_bank=(16,)),
                  **kw).arrays()
    jg, jt = jax_amr(2, seed=4, min_nodes=20, max_nodes=24)
    ja = jax_batchify(jax_preprocess(jg, jt), *jax_build_vocabs(jg, jt),
                      spec=JaxBucketSpec(nodes=(128,), local_bank=(16,)),
                      **kw).arrays()
    assert "tile_src" in pa and "bank_map" not in pa and "edge_src" not in pa
    assert ja.keys() == pa.keys()
    for k in ja:
        np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)


PENMAN = """# ::id a.1 ::date 2024 ::snt The boy wants to go .
# ::tok The boy wants to go .
(w / want-01~e.2
   :ARG0 (b / boy~e.1)
   :ARG1 (g / go-02 :ARG0 b)
   :polarity -)

# ::snt Smith said "hello" 3 times
(s / say-01 :ARG0 (p / person :name (n / name :op1 "Smith"~e.0))
   :ARG1 "hello" :quant 3 :time (a / after :op1 x2) :mod x2)

(f / forward-ref :ARG0 q7 :ARG1 (q7 / thing))
"""


def test_amr_reader_matches_jax(tmp_path):
    """graph/amr.py against gtos_tpu.graph.amr: the same graphs (nodes,
    edges, metadata) from a sembank file with alignments, re-entrancies,
    constants, strings and a forward reference, and the same errors with
    the same messages (offsets included) on malformed text."""
    path = tmp_path / "s.amr"
    path.write_text(PENMAN)
    jg, pg = jax_read_amr_file(str(path)), read_amr_file(str(path))
    assert len(pg) == 3
    _same_graphs(jg, pg)
    assert [a.meta for a in jg] == [b.meta for b in pg]
    assert pg[0].meta["tok"] == "The boy wants to go ."
    for bad in ("(w /)", "(a / b :ARG0 (c / d)", "(a / b) (c / d)",
                "(a / b : x)", "(a / b :ARG0 (a / c))", ":ARG0",
                "(a / b :ARG0 )", "", "(a / b)\n(c / d :x\n  : y)"):
        with pytest.raises(JaxAMRParseError) as je:
            jax_parse_amr(bad)
        with pytest.raises(AMRParseError) as pe:
            parse_amr(bad)
        assert str(pe.value) == str(je.value), bad
    with pytest.raises(AMRParseError, match="at offset 7"):
        parse_amr("(a / b : x)")
    empty = tmp_path / "e.amr"
    empty.write_text("")
    assert read_amr_file(str(empty)) == []
