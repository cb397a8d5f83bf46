"""All-pairs shortest-path relation extraction.

The heart of the gtos data contract (SURVEY.md §2.2 "AMR graph reader",
§3.1): for every ordered node pair (i, j), the relation fed to the model is
the sequence of edge labels along a shortest path from i to j in the graph
made connected by direction-marked reverse arcs (label + '_r'). The i == j
relation is a special self token; unreachable pairs get a special none token.
Runs in preprocessing (host side), never on the device — the batch tensors
carry the result (§3.1: "the training data contract already contains
per-pair path-label sequences").

Pure-Python copy of gtos_tpu/graph/paths.py (the port imports nothing of the
JAX package). The port's C++ extractor (gtos_tpu_torch/native, which the
DataLoader's preprocess uses when it builds) produces the same PackedPaths.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gtos_tpu_torch.graph.ir import Graph

# Special relation pseudo-labels (become entries of the relation vocab).
SELF_LABEL = "<self>"
NONE_LABEL = "<none>"
# Relation between the global (CLS-like) node and every real node.
GLOBAL_LABEL = "<global>"
REVERSE_SUFFIX = "_r"


@dataclasses.dataclass(frozen=True)
class RelationPathConfig:
    max_path_len: int = 8     # labels beyond this are truncated (kept prefix)
    reverse_suffix: str = REVERSE_SUFFIX


def relation_paths(
    graph: Graph, cfg: RelationPathConfig = RelationPathConfig()
) -> List[List[Tuple[str, ...]]]:
    """paths[i][j] = label sequence of a shortest path i -> j.

    paths[i][i] = (SELF_LABEL,); unreachable pairs = (NONE_LABEL,).
    Ties between equal-length paths are broken by BFS order (deterministic:
    adjacency lists follow edge declaration order, forward arc before the
    reverse arc of the same edge).
    """
    n = graph.num_nodes
    adj = graph.adjacency(reverse_suffix=cfg.reverse_suffix)
    out: List[List[Tuple[str, ...]]] = []
    for src in range(n):
        # BFS storing (parent, label) to reconstruct label sequences.
        parent = [-1] * n
        parent_label = [""] * n
        seen = [False] * n
        seen[src] = True
        q = deque([src])
        while q:
            u = q.popleft()
            for (v, lbl) in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    parent[v] = u
                    parent_label[v] = lbl
                    q.append(v)
        row: List[Tuple[str, ...]] = []
        for dst in range(n):
            if dst == src:
                row.append((SELF_LABEL,))
            elif not seen[dst]:
                row.append((NONE_LABEL,))
            else:
                labels: List[str] = []
                v = dst
                while v != src:
                    labels.append(parent_label[v])
                    v = parent[v]
                labels.reverse()
                row.append(tuple(labels[: cfg.max_path_len]))
        out.append(row)
    return out


class PathInterner:
    """Corpus-level path -> global-id table (id 0 = the NONE path).

    Built once during preprocess; instances then carry int ids instead of
    string tuples, so batchify's per-batch relation-bank dedup collapses
    from ~25k Python dict lookups per batch to one vectorized np.unique
    over ids, and rel_bank materialization becomes one `take` from the
    interner's cached label-id matrix (the r4 host profile's top two
    items). Derived arrays are cached against the table's length, so they
    rebuild only if new paths intern after a cache fill (they don't, in
    the preprocess-then-train flow)."""

    def __init__(self):
        self._index = {(NONE_LABEL,): 0}
        self.paths: List[Tuple[str, ...]] = [(NONE_LABEL,)]
        self._cache = {}

    def intern(self, path: Tuple[str, ...]) -> int:
        i = self._index.get(path)
        if i is None:
            i = self._index[path] = len(self.paths)
            self.paths.append(path)
        return i

    def intern_many(self, paths) -> np.ndarray:
        return np.fromiter((self.intern(p) for p in paths), np.int32,
                           count=len(paths))

    def _derived(self, key, build):
        got = self._cache.get(key)
        if got is not None and got[0] == len(self.paths):
            return got[1]
        val = build()
        self._cache[key] = (len(self.paths), val)
        return val

    def lengths(self):
        """[G] int32 label count per path."""
        return self._derived("len", lambda: np.fromiter(
            (len(p) for p in self.paths), np.int32, count=len(self.paths)))

    def trim_map(self, L_cap: int):
        """[G] int32: gid -> gid of path[:L_cap] (identity when short)."""
        def build():
            out = np.arange(len(self.paths), dtype=np.int32)
            for g, p in enumerate(self.paths):
                if len(p) > L_cap:
                    out[g] = self.intern(p[:L_cap])
            # interning a trimmed path may append new rows; extend to G
            if len(out) < len(self.paths):
                ext = np.arange(len(self.paths), dtype=np.int32)
                ext[: len(out)] = out
                out = ext
            return out

        return self._derived(("trim", L_cap), build)

    def encoded(self, relation_vocab, L: int):
        """([G, L] int32 label ids, [G] int32 lengths clipped to L)."""
        def build():
            G = len(self.paths)
            mat = np.zeros((G, L), np.int32)
            ln = np.zeros((G,), np.int32)
            for g, p in enumerate(self.paths):
                p = p[:L]
                ln[g] = len(p)
                for k, lbl in enumerate(p):
                    mat[g, k] = relation_vocab.encode(lbl)
            return mat, ln

        return self._derived(("enc", id(relation_vocab), L), build)


@dataclasses.dataclass
class PackedPaths:
    """Deduplicated per-graph path set: `uniq[pair_idx[i, j]]` is the label
    tuple for pair (i, j). Row 0 of uniq is the NONE (unreachable) path and
    the diagonal points at a SELF entry, so all pairs go through one
    uniform index -> tuple mapping. Produced by pack_relation_paths.

    preprocess sets `uniq_gid[u]`, the corpus-global PathInterner id of
    uniq[u], and `interner`, the shared table, and drops `uniq` (the
    strings live once, in the interner); batchify reads only those.
    """

    uniq: Optional[List[Tuple[str, ...]]]
    pair_idx: np.ndarray  # [n, n] int32
    uniq_gid: Optional[np.ndarray] = None  # [U] int32
    interner: Optional[PathInterner] = None

    def expand(self) -> List[List[Tuple[str, ...]]]:
        """The nested-list form of relation_paths."""
        n = self.pair_idx.shape[0]
        uniq = (self.uniq if self.uniq is not None
                else [self.interner.paths[g] for g in self.uniq_gid])
        return [[uniq[self.pair_idx[i, j]] for j in range(n)]
                for i in range(n)]


def pack_relation_paths(
    graph: Graph, cfg: RelationPathConfig = RelationPathConfig()
) -> PackedPaths:
    """PackedPaths with the layout of the C++ extractor
    (gtos_tpu_torch/native, as gtos_tpu/native in the JAX package):
    uniq[0] is NONE, then the paths of the off-diagonal reachable pairs in
    row-major first appearance, then SELF last. The unique-path order fixes the relation bank's row order,
    so this is what makes the port's batches equal the JAX package's.
    Semantics identical to relation_paths."""
    nested = relation_paths(graph, cfg)
    n = graph.num_nodes
    uniq: List[Tuple[str, ...]] = [(NONE_LABEL,)]
    index = {(NONE_LABEL,): 0}
    pair_idx = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        row = nested[i]
        for j in range(n):
            if j == i:
                continue
            p = row[j]
            k = index.get(p)
            if k is None:
                k = index[p] = len(uniq)
                uniq.append(p)
            pair_idx[i, j] = k
    if n:
        np.fill_diagonal(pair_idx, len(uniq))
        uniq.append((SELF_LABEL,))
    return PackedPaths(uniq=uniq, pair_idx=pair_idx)


def collect_relation_labels(graphs: Sequence[Graph], cfg: RelationPathConfig = RelationPathConfig()):
    """All labels a relation vocab must contain for these graphs: every edge
    label, its reverse-marked twin, and the special tokens."""
    labels = set()
    for g in graphs:
        for (_, lbl, _) in g.edges:
            labels.add(lbl)
            labels.add(lbl + cfg.reverse_suffix)
    labels.update({SELF_LABEL, NONE_LABEL, GLOBAL_LABEL})
    return sorted(labels)
