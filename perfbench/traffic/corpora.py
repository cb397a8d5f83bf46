"""Seeded corpus generators, frozen here so that no change to the program
moves the yardstick, and the writers of the files the program reads.

A corpus is a list of (nodes, edges, target) triples: node labels, edges
(src, label, dst) over node indices, target tokens. Its sizes (node
counts, target lengths) are the same for every seed; the seed draws the
labels and the structure. Node indices are in
the preorder of the PENMAN text that `write_penman` writes, which is the
order in which the program's PENMAN reader numbers them, so a triple and
the graph the program parses from its file agree node for node.

  amr2        AMR 2.0-shaped graphs: log-normal node counts (mean ~14, a
              tail to `max_nodes`), ~8k Zipf-drawn lemmas, ~40 Zipf-weighted roles,
              mostly local attachment and ~8% re-entrancies; targets are
              the concepts' surface forms with function words (a copy of
              gtos_tpu_torch/data/synthetic.py synthetic_amr2_corpus)
  dependency  dependency trees of a stated length range over a Zipf-drawn
              source vocabulary of `vocab` BPE-like types and ~37
              Universal Dependencies relations; the target is the
              sentence's translation under a fixed type map, with local
              reordering and inserted function words, so source and target
              vocabularies are both ~`vocab` types
"""

from __future__ import annotations

import os
import random
from typing import List, Sequence, Tuple

Triple = Tuple[List[str], List[Tuple[int, str, int]], List[str]]

_AMR_ROLES = [
    "ARG0", "ARG1", "ARG2", "ARG3", "ARG4", "mod", "time", "location",
    "manner", "poss", "domain", "topic", "purpose", "name", "quant", "unit",
    "degree", "condition", "part", "source", "destination", "beneficiary",
    "instrument", "accompanier", "duration", "frequency", "extent",
    "medium", "example", "concession", "direction", "ord", "value",
    "polarity", "mode", "age", "path", "subevent", "li", "wiki"]
_UD_RELATIONS = [
    "nsubj", "obj", "iobj", "csubj", "ccomp", "xcomp", "obl", "vocative",
    "expl", "dislocated", "advcl", "advmod", "discourse", "aux", "cop",
    "mark", "nmod", "appos", "nummod", "acl", "amod", "det", "clf", "case",
    "conj", "cc", "fixed", "flat", "compound", "list", "parataxis",
    "orphan", "goeswith", "reparandum", "punct", "dep", "nsubj:pass"]
_TARGET_FUNCTION_WORDS = [f"tf{i:02d}" for i in range(48)]


def _zipf(rng: random.Random, pool: Sequence[str]) -> str:
    """Rank-weighted choice (rank r with weight ~1/(r+2))."""
    r = int(len(pool) * (rng.random() ** 3))
    return pool[min(r, len(pool) - 1)]


def _preorder(n: int, edges) -> List[int]:
    """Node order of the PENMAN text: the root, then each tree child's
    subtree in edge order (tree edges: the first edge into each node)."""
    children = [[] for _ in range(n)]
    seen = {0}
    for s, _, t in edges:
        if t not in seen:
            seen.add(t)
            children[s].append(t)
    order, stack = [], [0]
    while stack:
        u = stack.pop()
        order.append(u)
        stack.extend(reversed(children[u]))
    return order


def _sizes(n: int) -> random.Random:
    """The stream of a corpus's sizes (node counts, target lengths): the
    same for every seed, so that seeds change the graphs and not the
    amount of work."""
    return random.Random(n)


def amr2(n: int, seed: int, max_nodes: int = 80,
         max_target: int = 100) -> List[Triple]:
    """The AMR 2.0-shaped corpus (module docstring), renumbered into
    PENMAN preorder."""
    rng, size = random.Random(seed), _sizes(n)
    verbs = [f"verb{i:04d}" for i in range(2500)]
    nouns = [f"noun{i:04d}" for i in range(5500)]
    out = []
    for _ in range(n):
        nn = max(1, min(int(size.lognormvariate(2.6, 0.55)), max_nodes))
        nodes = []
        for _ in range(nn):
            if rng.random() < 0.45:
                nodes.append(f"{_zipf(rng, verbs)}-{rng.randint(1, 3):02d}")
            else:
                nodes.append(_zipf(rng, nouns))
        edges = []
        for i in range(1, nn):
            parent = rng.randrange(max(0, i - 8), i)
            edges.append((parent, _zipf(rng, _AMR_ROLES), i))
        for _ in range(int(nn * 0.08)):
            s, t = rng.randrange(nn), rng.randrange(nn)
            if s != t:
                edges.append((s, _zipf(rng, _AMR_ROLES), t))
        # the surface realization: concepts by (length, index), a function
        # word before 30% of them
        words = []
        for i in sorted(range(nn), key=lambda i: (len(nodes[i]), i)):
            c = nodes[i]
            surf = c.rsplit("-", 1)[0] if c[-1].isdigit() and "-" in c else c
            if size.random() < 0.3:
                words.append(rng.choice(["the", "a", "and", "to", "of"]))
            words.append(surf)
        order = _preorder(nn, edges)
        new = {old: k for k, old in enumerate(order)}
        out.append(([nodes[i] for i in order],
                    [(new[s], lbl, new[t]) for s, lbl, t in edges],
                    words[:max_target]))
    return out


def dependency(n: int, seed: int, min_len: int = 10, max_len: int = 50,
               vocab: int = 8000) -> List[Triple]:
    """Dependency trees and their translations (module docstring). Node
    0 is the root token; token i > 0 hangs off a token before it, mostly
    a near one."""
    rng, size = random.Random(seed), _sizes(n)
    source = [f"s{i:04d}" for i in range(vocab)]
    # a fixed type map (not the seed's): the "language pair" is the same
    # in every run, the sentences are the seed's
    target = [f"t{i:04d}" for i in range(vocab)]
    random.Random(1).shuffle(target)
    out = []
    for _ in range(n):
        ln = size.randint(min_len, max_len)
        toks = [_zipf(rng, source) for _ in range(ln)]
        edges = []
        for i in range(1, ln):
            head = rng.randrange(max(0, i - 6), i) if rng.random() < 0.8 \
                else rng.randrange(i)
            edges.append((head, _zipf(rng, _UD_RELATIONS), i))
        words = [target[int(t[1:])] for t in toks]
        for i in range(0, len(words) - 1, 2):     # local reordering
            if rng.random() < 0.3:
                words[i], words[i + 1] = words[i + 1], words[i]
        tgt = []
        for w in words:
            if size.random() < 0.2:
                tgt.append(rng.choice(_TARGET_FUNCTION_WORDS))
            tgt.append(w)
        out.append((toks, edges, tgt))
    return out


GENERATORS = {"amr2": amr2, "dependency": dependency}


def generate(spec: dict, n: int, seed: int) -> List[Triple]:
    """`n` triples of the generator that `spec` names ("generator"), with
    its other keys as the generator's parameters."""
    params = {k: v for k, v in spec.items() if k != "generator"}
    return GENERATORS[spec["generator"]](n, seed, **params)


# ---------------------------------------------------------------- writers


def _penman(nodes, edges) -> str:
    out = {u: [] for u in range(len(nodes))}
    seen = {0}
    for s, lbl, t in edges:
        out[s].append((lbl, t, t not in seen))
        seen.add(t)

    def node(u):
        parts = [f"(v{u} / {nodes[u]}"]
        for lbl, t, tree in out[u]:
            parts.append(f":{lbl} " + (node(t) if tree else f"v{t}"))
        return " ".join(parts) + ")"

    return node(0)


def write_penman(path: str, corpus: Sequence[Triple]):
    """A sembank file: per graph a `# ::snt` line with the target tokens
    and its PENMAN text, a blank line between graphs."""
    with open(path, "w") as f:
        for nodes, edges, tgt in corpus:
            f.write(f"# ::snt {' '.join(tgt)}\n{_penman(nodes, edges)}\n\n")


def write_conll(path: str, target_path: str, corpus: Sequence[Triple]):
    """A CoNLL file (`idx token head deprel`, a blank line between
    sentences) and the target file, one sentence a line."""
    with open(path, "w") as f, open(target_path, "w") as g:
        for nodes, edges, tgt in corpus:
            head = {t: (s + 1, lbl) for s, lbl, t in edges}
            for i, tok in enumerate(nodes):
                h, lbl = head.get(i, (0, "root"))
                f.write(f"{i + 1}\t{tok}\t{h}\t{lbl}\n")
            f.write("\n")
            g.write(" ".join(tgt) + "\n")


def write_files(task: str, corpus: Sequence[Triple], directory: str,
                name: str) -> Tuple[str, str]:
    """Write `corpus` as the program's task reads it: (data path, target
    path or None)."""
    if task == "amr":
        path = os.path.join(directory, f"{name}.amr")
        write_penman(path, corpus)
        return path, None
    path = os.path.join(directory, f"{name}.conll")
    tgt = os.path.join(directory, f"{name}.tgt")
    write_conll(path, tgt, corpus)
    return path, tgt
