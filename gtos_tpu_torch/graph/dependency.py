"""Dependency-tree front end for the translator (syntax-NMT) path.

Port of gtos_tpu/graph/dependency.py: nodes are the source sentence's
tokens in order, edges are labelled dependency arcs head -> dependent,
from CoNLL-style parallel lists of heads (1-based, 0 = root) and labels.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from gtos_tpu_torch.graph.ir import Graph


def dependency_graph(
    tokens: Sequence[str],
    heads: Sequence[int],
    labels: Sequence[str],
    meta: dict | None = None,
) -> Graph:
    """A Graph from CoNLL-style heads and labels.

    heads[i] is the 1-based head of token i; 0 is the root and emits no
    edge. The tree stays connected for path extraction through the
    reverse arcs of Graph.adjacency; no sequential edges are added."""
    if not (len(tokens) == len(heads) == len(labels)):
        raise ValueError("tokens/heads/labels length mismatch")
    edges: List[Tuple[int, str, int]] = []
    for i, (h, lbl) in enumerate(zip(heads, labels)):
        if h == 0:
            continue
        if not (1 <= h <= len(tokens)):
            raise ValueError(f"head {h} out of range for {len(tokens)} tokens")
        edges.append((h - 1, lbl, i))
    return Graph(nodes=list(tokens), edges=edges, meta=meta)


def read_conll_file(path: str) -> List[Graph]:
    """A minimal CoNLL-X-style file: per line `idx token head deprel`
    (tab- or space-separated, extra columns ignored), a blank line between
    sentences; a last sentence without a blank line after it is kept."""
    graphs: List[Graph] = []
    toks: List[str] = []
    heads: List[int] = []
    labels: List[str] = []

    def flush():
        nonlocal toks, heads, labels
        if toks:
            graphs.append(dependency_graph(toks, heads, labels))
        toks, heads, labels = [], [], []

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                flush()
                continue
            cols = line.split("\t") if "\t" in line else line.split()
            if len(cols) < 4:
                raise ValueError(f"bad CoNLL line: {line!r}")
            toks.append(cols[1])
            heads.append(int(cols[2]))
            labels.append(cols[3])
    flush()
    return graphs
