"""Hand-rolled PENMAN reader lowering AMR strings to the shared Graph IR.

Port of gtos_tpu/graph/amr.py (pure Python, the same grammar, graphs and
errors). The reference's AMR reader (generator/AMRGraph.py in jcyk/gtos)
consumes pre-tokenized/anonymized AMR; no PENMAN package is a dependency,
so the grammar is implemented directly.

Grammar handled (a superset of what the AMR corpora use):
    node      := '(' var '/' concept relation* ')'
    relation  := ':' role ( node | var | constant )
    constant  := quoted string | number | bare symbol ('-', '+', 'imperative', …)

Re-entrancies (a relation whose target is a bare variable already defined
elsewhere) become edges to the existing node. Constants become nodes of their
own, so the Graph IR sees one node per concept/constant occurrence.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from gtos_tpu_torch.graph.ir import Graph


class AMRParseError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
      (?P<lparen>\() |
      (?P<rparen>\)) |
      (?P<slash>/) |
      (?P<role>:[^\s()]+) |
      (?P<string>"(?:[^"\\]|\\.)*") |
      (?P<symbol>[^\s()/:][^\s()]*)
    """,
    re.VERBOSE,
)


_ALIGN_RE = re.compile(r"~[^\s()]*")


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    n = len(text)
    while pos < n:
        if text[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise AMRParseError(f"cannot tokenize at offset {pos}: {text[pos:pos+30]!r}")
        kind = m.lastgroup
        tok = m.group()
        pos = m.end()
        # ISI-style alignment markers (`want-01~e.4`, `"Smith"~e.1`,
        # `:ARG0~e.0`) ride as a `~...` suffix on any token; strip them —
        # inside symbols/roles (the greedy pattern swallows them) and
        # after closing quotes (where they'd otherwise become a stray
        # symbol token)
        if kind in ("role", "symbol") and "~" in tok:
            tok = tok.split("~", 1)[0]
        if kind == "string" and pos < n and text[pos] == "~":
            am = _ALIGN_RE.match(text, pos)
            pos = am.end()
        tokens.append((kind, tok))
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.tokens = tokens
        self.i = 0
        self.var_to_node: Dict[str, int] = {}
        self.nodes: List[str] = []
        self.edges: List[Tuple[int, str, int]] = []
        # (src_node, role, var) edges whose var was not yet defined at use site
        self.pending: List[Tuple[int, str, str]] = []

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        if tok[0] is None:
            raise AMRParseError("unexpected end of input")
        self.i += 1
        return tok

    def expect(self, kind: str):
        tok = self.next()
        if tok[0] != kind:
            raise AMRParseError(f"expected {kind}, got {tok[1]!r}")
        return tok

    def new_node(self, label: str) -> int:
        self.nodes.append(label)
        return len(self.nodes) - 1

    def parse_node(self) -> int:
        self.expect("lparen")
        var = self.expect("symbol")[1]
        self.expect("slash")
        kind, concept = self.next()
        if kind not in ("symbol", "string"):
            raise AMRParseError(f"expected concept, got {concept!r}")
        nid = self.new_node(concept.strip('"') if kind == "string" else concept)
        if var in self.var_to_node:
            raise AMRParseError(f"variable {var!r} defined twice")
        self.var_to_node[var] = nid
        while self.peek()[0] == "role":
            role = self.next()[1][1:]  # strip leading ':'
            self.parse_target(nid, role)
        self.expect("rparen")
        return nid

    def parse_target(self, src: int, role: str):
        kind, val = self.peek()
        if kind == "lparen":
            tgt = self.parse_node()
            self.edges.append((src, role, tgt))
        elif kind == "string":
            self.next()
            tgt = self.new_node(val.strip('"'))
            self.edges.append((src, role, tgt))
        elif kind == "symbol":
            self.next()
            if val in self.var_to_node:
                # re-entrancy to an already-defined variable
                self.edges.append((src, role, self.var_to_node[val]))
            elif _looks_like_var(val) :
                # forward reference to a variable defined later
                self.pending.append((src, role, val))
            else:
                # constant: number, '-', '+', 'imperative', 'expressive', …
                tgt = self.new_node(val)
                self.edges.append((src, role, tgt))
        else:
            raise AMRParseError(f"unexpected token {val!r} after role {role!r}")

    def resolve_pending(self):
        for (src, role, var) in self.pending:
            if var in self.var_to_node:
                self.edges.append((src, role, self.var_to_node[var]))
            else:
                # not a variable after all — it was a bare constant
                tgt = self.new_node(var)
                self.edges.append((src, role, tgt))


_VAR_RE = re.compile(r"^[a-z][a-z0-9]*$|^[a-z][a-z]*\d+$")


def _looks_like_var(sym: str) -> bool:
    """AMR variables are short lowercase alphanumerics like `b`, `g2`, `ii`."""
    return bool(_VAR_RE.match(sym)) and not any(c in sym for c in "-+.")


def parse_amr(text: str, meta: dict | None = None) -> Graph:
    """Parse one PENMAN-serialized AMR into the Graph IR."""
    tokens = _tokenize(text)
    parser = _Parser(tokens)
    parser.parse_node()
    if parser.peek()[0] is not None:
        raise AMRParseError(f"trailing tokens: {parser.tokens[parser.i:]}")
    parser.resolve_pending()
    return Graph(nodes=parser.nodes, edges=parser.edges, meta=meta)


def read_amr_file(path: str) -> List[Graph]:
    """Read a file of AMRs in the standard sembank layout.

    Blocks are separated by blank lines; lines starting with '#' carry
    metadata (`::snt`, `::id`, `::tok`) which is preserved into Graph.meta.
    """
    graphs: List[Graph] = []
    block_lines: List[str] = []
    meta: dict = {}

    def flush():
        nonlocal block_lines, meta
        if block_lines:
            graphs.append(parse_amr(" ".join(block_lines), meta=dict(meta) or None))
        block_lines, meta = [], {}

    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                flush()
            elif line.startswith("#"):
                # real sembank metadata packs several fields per line
                # ("# ::id x ::date y ::annotator z"); split on every
                # `::tag` so a trailing ::snt is not swallowed by ::id
                for m in re.finditer(
                        r"::(\w[\w-]*)\s*((?:(?!::\w).)*)", line):
                    meta[m.group(1)] = m.group(2).strip()
            else:
                block_lines.append(line)
    flush()
    return graphs
