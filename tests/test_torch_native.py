"""The port's native relation-path extractor (gtos_tpu_torch/native, its
own copy of paths.cpp built with g++ at first use) against the port's
Python producer and the JAX package's native extractor: the same
PackedPaths, field for field (the unique-path order decides each batch's
bank rows), and preprocess's choice between them. No timing here: the
card machine's host numbers come from chip_smoke.py's host phase."""

import random

import numpy as np
import pytest

from gtos_tpu import native as jax_native
from gtos_tpu.graph.ir import Graph as JaxGraph
from gtos_tpu_torch import native
from gtos_tpu_torch.data import dataloader
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.synthetic import (
    synthetic_amr2_corpus, synthetic_dependency_corpus,
)
from gtos_tpu_torch.graph.ir import Graph
from gtos_tpu_torch.graph.paths import (
    RelationPathConfig, pack_relation_paths, relation_paths,
)


def _random_edges(rng, n):
    """A random tree over n nodes plus n // 3 extra arcs (cycles, multi-
    and self-edges possible), labels from 6."""
    edges = [(rng.randrange(i), f"L{rng.randrange(6)}", i)
             for i in range(1, n)]
    for _ in range(n // 3):
        edges.append((rng.randrange(n), f"L{rng.randrange(6)}",
                      rng.randrange(n)))
    return edges


def _same_packed(a, b):
    assert a.uniq == b.uniq
    assert a.pair_idx.dtype == b.pair_idx.dtype == np.int32
    np.testing.assert_array_equal(a.pair_idx, b.pair_idx)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 7, 25, 40])
def test_native_packed_paths_equal_python_and_jax(n, seed):
    """On random graphs, at path caps 2 and 8: the port's native
    PackedPaths equal the port's Python ones and the JAX package's native
    ones field for field (uniq in order, pair_idx), and expand to
    relation_paths."""
    edges = _random_edges(random.Random(seed), n)
    nodes = [f"c{i}" for i in range(n)]
    g, jg = Graph(nodes, edges), JaxGraph(nodes, edges)
    for cap in (2, 8):
        cfg = RelationPathConfig(max_path_len=cap)
        got = native.pack_relation_paths_native(g, cfg)
        _same_packed(got, pack_relation_paths(g, cfg))
        _same_packed(got, jax_native.pack_relation_paths_native(jg, cfg))
        assert native.relation_paths_native(g, cfg) == relation_paths(g, cfg)


@pytest.mark.parametrize("graph", ["disconnected", "empty", "edgeless"])
def test_native_edge_cases(graph):
    """A disconnected graph (unreachable pairs on the NONE row), a graph
    of no nodes, and nodes without edges: the same PackedPaths in all
    three producers."""
    nodes, edges = {"disconnected": (["a", "b", "c", "d"],
                                     [(0, "X", 1), (3, "Y", 2)]),
                    "empty": ([], []),
                    "edgeless": (["a", "b"], [])}[graph]
    g = Graph(nodes, edges)
    got = native.pack_relation_paths_native(g)
    _same_packed(got, pack_relation_paths(g))
    _same_packed(got, jax_native.pack_relation_paths_native(
        JaxGraph(nodes, edges)))


def test_library_built_into_the_port_build_dir():
    """The library is built from the port's own paths.cpp into
    gtos_tpu_torch/_build/, named by a hash of source and flags, without
    -march=native."""
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "gtos_tpu_torch"
    assert native.SOURCE.parent.name == "native"
    assert not any(f.startswith("-march") for f in native.CXX_FLAGS)
    assert native.build() is False  # built: nothing to compile


@pytest.mark.parametrize("corpus", ["amr2", "dependency"])
def test_preprocess_takes_native_and_matches_python(corpus, monkeypatch):
    """preprocess runs the native extractor (EXTRACTOR == "native"); with
    its library unavailable it runs the Python BFS (EXTRACTOR == "python")
    and gives the same instances: per graph the same pair_idx and the same
    interned path ids."""
    g, t = (synthetic_amr2_corpus(30, seed=2) if corpus == "amr2"
            else synthetic_dependency_corpus(30, seed=2, min_len=10,
                                             max_len=50))
    fast = preprocess(g, t)
    assert dataloader.EXTRACTOR == "native"

    def unavailable():
        raise OSError("no library")

    monkeypatch.setattr(native, "load", unavailable)
    slow = preprocess(g, t)
    assert dataloader.EXTRACTOR == "python"
    assert len(fast) == len(slow) == 30
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a.pair_paths.pair_idx,
                                      b.pair_paths.pair_idx)
        np.testing.assert_array_equal(a.pair_paths.uniq_gid,
                                      b.pair_paths.uniq_gid)
    assert (fast[0].pair_paths.interner.paths
            == slow[0].pair_paths.interner.paths)
