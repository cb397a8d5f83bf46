"""The native (C++) relation-path extractor, bound with ctypes.

Port of gtos_tpu/native: this package's own copy of `paths.cpp` and the
same PackedPaths, field for field, as the Python producer
`graph.paths.pack_relation_paths` (the unique-path order fixes each
batch's relation-bank row order). `data.dataloader.preprocess` uses it
when it builds and the Python BFS otherwise.

The library is built with g++ at first use (`load`), never at import,
into gtos_tpu_torch/_build/ (listed in .gitignore), named by a hash of
the source and the flags. It is built without -march=native, so a library
cached on one host loads and runs on any other of the same architecture.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from gtos_tpu_torch.graph.ir import Graph
from gtos_tpu_torch.graph.paths import (
    NONE_LABEL, SELF_LABEL, PackedPaths, RelationPathConfig,
)

SOURCE = Path(__file__).resolve().parent / "paths.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    """Where the library is built: named by a hash of source and flags."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"paths-{digest[:16]}.so"


def build() -> bool:
    """Compile the source unless its library exists; True if it compiled.
    Raises RuntimeError with g++'s output if the compile fails, OSError
    if there is no g++."""
    out = library_path()
    if out.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return True


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded library, built first if missing (raises as `build`, or
    OSError if it does not load)."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.gtos_relation_paths.restype = ctypes.c_int32
    lib.gtos_relation_paths.argtypes = [
        ctypes.c_int32, ctypes.c_int32, _I32P, _I32P, _I32P,
        ctypes.c_int32, ctypes.c_int32, _I32P, _I32P, _I32P,
        ctypes.c_int32]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def pack_relation_paths_native(
    graph: Graph, cfg: Optional[RelationPathConfig] = None
) -> PackedPaths:
    """PackedPaths from the C++ extractor: uniq[0] is NONE, then the paths
    of the off-diagonal reachable pairs in row-major first appearance,
    then SELF, which the diagonal points at. Equal to
    pack_relation_paths(graph, cfg), field for field."""
    cfg = cfg or RelationPathConfig()
    n = graph.num_nodes
    if n == 0:
        return PackedPaths(uniq=[(NONE_LABEL,)],
                           pair_idx=np.zeros((0, 0), dtype=np.int32))
    if n * n + 1 > np.iinfo(np.int32).max:
        raise ValueError(f"{n} nodes: the pair count overflows int32")
    m = graph.num_edges
    labels: List[str] = []
    lab2id = {}
    lab_ids = np.empty(m, dtype=np.int32)
    src = np.empty(m, dtype=np.int32)
    dst = np.empty(m, dtype=np.int32)
    for e, (s, lbl, t) in enumerate(graph.edges):
        lid = lab2id.get(lbl)
        if lid is None:
            lid = lab2id[lbl] = len(labels)
            labels.append(lbl)
        src[e], dst[e], lab_ids[e] = s, t, lid
    # id -> label, the reverse arcs' direction-marked labels after them
    id2str = labels + [lbl + cfg.reverse_suffix for lbl in labels]

    cap = max(16, n * n + 1)
    L = cfg.max_path_len
    pair_idx = np.empty(n * n, dtype=np.int32)
    paths = np.zeros(cap * L, dtype=np.int32)  # label 0 past each path
    lens = np.empty(cap, dtype=np.int32)
    n_paths = load().gtos_relation_paths(
        n, m, _ptr(src), _ptr(dst), _ptr(lab_ids), len(labels), L,
        _ptr(pair_idx), _ptr(paths), _ptr(lens), cap)
    if n_paths < 0:  # cap is n*n+1: one path per pair at most
        raise RuntimeError("native path extraction overflow")

    # the unique paths as tuples of labels, from one take of the label
    # strings over all of them (a generator over each path's ids costs as
    # much as the Python BFS does)
    uniq: List[Tuple[str, ...]] = [(NONE_LABEL,)]
    if n_paths > 1 and labels:
        rows = np.array(id2str, dtype=object)[
            paths[L: n_paths * L].reshape(-1, L)].tolist()
        uniq += [tuple(r[:k]) for r, k in zip(rows, lens[1:n_paths].tolist())]
    pi = pair_idx.reshape(n, n)
    np.fill_diagonal(pi, len(uniq))
    uniq.append((SELF_LABEL,))
    return PackedPaths(uniq=uniq, pair_idx=pi)


def relation_paths_native(
    graph: Graph, cfg: Optional[RelationPathConfig] = None
) -> List[List[Tuple[str, ...]]]:
    """graph.paths.relation_paths's nested-list form, from the C++
    extractor."""
    return pack_relation_paths_native(graph, cfg).expand()
