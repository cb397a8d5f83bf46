"""The check of the batch arrays that the reference reads.

The reference runs on the program's batch arrays: the relation bank's row
order decides which dropout draw each path's vectors take, so it cannot
lay the bank out anew and still follow the program. This check holds
those arrays, row by row, against the graphs and targets that the
benchmark generated, in plain Python: every node's concept and chars,
every target token, and for every ordered node pair the label path that
the pair's bank row holds, which has to be a shortest path of the graph
made connected by reverse arcs (label + "_r"), cut after `max_path_len`
labels; "<self>" on the diagonal, "<none>" between unconnected nodes,
"<global>" between the global node 0 and every node. Ids are read through
the program's vocabularies, which is how they are judged, never how they
are computed.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

SELF, NONE, GLOBAL, REVERSE = "<self>", "<none>", "<global>", "_r"


def _all_pairs(n, edges):
    """adj[u] = [(v, label)] with reverse arcs, and dist[i][j] (None:
    unreachable)."""
    adj = [[] for _ in range(n)]
    for s, lbl, t in edges:
        adj[s].append((t, lbl))
        adj[t].append((s, lbl + REVERSE))
    dist = []
    for src in range(n):
        d = [None] * n
        d[src] = 0
        q = deque([src])
        while q:
            u = q.popleft()
            for v, _ in adj[u]:
                if d[v] is None:
                    d[v] = d[u] + 1
                    q.append(v)
        dist.append(d)
    return adj, dist


def _on_shortest_path(labels, i, j, adj, dist) -> bool:
    """Whether `labels` is the label sequence of a shortest path from i to
    j, or its first len(labels) labels where it was cut."""
    d = dist[i][j]
    if len(labels) > d:
        return False
    front = {i}
    for m, lbl in enumerate(labels, 1):
        front = {v for u in front for v, l2 in adj[u]
                 if l2 == lbl and dist[i][v] == m and dist[v][j] == d - m}
        if not front:
            return False
    return True


def check_row(arrays, b: int, nodes: Sequence[str], edges, target:
              Optional[Sequence[str]], vocabs, max_path_len: int = 8
              ) -> List[str]:
    """What is wrong with row b of a batch's `arrays` (GraphBatch.arrays()
    names, numpy), whose graph is (nodes, edges) and target `target`
    (None: not checked): a list of faults, empty where the row is right.
    vocabs: (token, concept, relation, char) itos lists."""
    tok, con, rel, chars = vocabs
    faults = []
    n = len(nodes)
    con_id = {s: i for i, s in enumerate(con)}
    want = [con_id.get(c, 1) for c in nodes]      # 1: <UNK>
    got = arrays["concept"][b, 1:n + 1].tolist()
    if got != want or not arrays["concept_mask"][b, :n + 1].all() \
            or arrays["concept_mask"][b, n + 1:].any():
        faults.append(f"row {b}: concepts or node mask")
    char_id = {s: i for i, s in enumerate(chars)}
    C = arrays["concept_char"].shape[2]
    for k, c in enumerate(nodes):
        ids = [char_id.get(x, 1) for x in c[:C]]
        if arrays["concept_char"][b, k + 1, :len(ids)].tolist() != ids:
            faults.append(f"row {b}: chars of node {k}")
            break
    if target is not None:
        tok_id = {s: i for i, s in enumerate(tok)}
        T = arrays["token_in"].shape[1]
        tgt = list(target)[:T - 1]
        want = [tok_id.get(w, 1) for w in tgt]
        if arrays["token_in"][b, 1:len(tgt) + 1].tolist() != want or \
                int(arrays["token_mask"][b].sum()) != len(tgt) + 1:
            faults.append(f"row {b}: target tokens or mask")
    adj, dist = _all_pairs(n, edges)
    idx, bank = arrays["rel_index"][b], arrays["rel_bank"]
    length = arrays["rel_length"]

    def path(i, j):
        r = idx[i, j]
        return [rel[x] for x in bank[r, :length[r]]]

    if any(path(0, j) != [GLOBAL] or path(j, 0) != [GLOBAL]
           for j in range(n + 1)):
        faults.append(f"row {b}: the global node's relations")
    for i in range(n):
        for j in range(n):
            p = path(i + 1, j + 1)
            if i == j:
                ok = p == [SELF]
            elif dist[i][j] is None:
                ok = p == [NONE]
            else:
                ok = (len(p) == min(dist[i][j], max_path_len)
                      and _on_shortest_path(p, i, j, adj, dist))
            if not ok:
                faults.append(f"row {b}: the path from node {i} to {j} "
                              f"is {p}")
                return faults
    return faults


def all_faults(arrays, corpus, indices, vocabs, rows=None,
               with_target=True) -> List[str]:
    """check_row over the rows `rows` (default all) of a batch whose row
    r holds corpus[indices[r]]."""
    out = []
    for b in (range(len(indices)) if rows is None else rows):
        nodes, edges, tgt = corpus[indices[b]]
        out += check_row(arrays, b, nodes, edges,
                         tgt if with_target else None, vocabs)
    return out

