"""The block-sparse pair layout (numpy, host side).

Port of gtos_tpu/ops/block_sparse.py: the kept-pair set of each graph is
packed into nonempty (dst-tile, src-tile) blocks of 128x128 nodes, so that
the block-sparse attention (ops/block_sparse_attention.py) visits only
those:

  tile_src [B, Td, Smax] int32 — for each dst tile, the src-tile ids of its
      nonempty blocks, -1 padded (Smax = most nonempty blocks of a tile);
  tile_rel [B, Td, Smax, T, T] int32 — the relation-bank row of each pair
      of a block, -1 where the pair is dropped;
  tile_dst / tile_rel_src — the src-major transpose (each src tile's dst
      tiles, each block transposed to [src-local, dst-local]), which the
      backward's src-major pass walks.

For the context-parallel ring (parallel/ring_block_sparse.py) the node dim
is cut into S blocks and each (dst-block, src-block) cell is packed on its
own with block-local tile ids (pack_block_sparse_cells and its src-major
twin). Every packer takes `own`, a (lo, hi) row slice of the batch: the
sizes (Smax) come from every row, so that they agree on every rank, and
only the owned rows are filled (the others stay -1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TILE = 128


def _pack(blocks: np.ndarray, planes, tile: int, own=None):
    """blocks [B, Td, Ts] nonempty map; planes(lo, hi) -> the masked rel
    blocks [hi - lo, Td, Ts, tile, tile] of rows lo..hi -> (ids
    [B, Td, Smax], rel [B, Td, Smax, tile, tile]): each row's nonempty
    block ids front-packed in ascending order (a stable argsort), -1
    padded; Smax from every row, only the rows of `own` filled."""
    B, Td = blocks.shape[:2]
    lo, hi = own if own is not None else (0, B)
    smax = max(1, int(blocks.sum(-1).max()))
    ids = np.full((B, Td, smax), -1, np.int32)
    rel = np.full((B, Td, smax, tile, tile), -1, np.int32)
    bl = blocks[lo:hi]
    order = np.argsort(~bl, axis=2, kind="stable")[..., :smax]
    slot_ok = np.arange(smax)[None, None, :] < bl.sum(-1, keepdims=True)
    ids[lo:hi] = np.where(slot_ok, order, -1)
    got = np.take_along_axis(planes(lo, hi), order[..., None, None], axis=2)
    rel[lo:hi] = np.where(slot_ok[..., None, None], got, -1)
    return ids, rel


def _masked(keep, rel_index, lo, hi):
    return np.where(keep[lo:hi], rel_index[lo:hi], -1).astype(np.int32)


def pack_block_sparse(keep: np.ndarray, rel_index: np.ndarray,
                      tile: int = TILE, own=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """keep: [B, N, N] bool kept-pair mask; rel_index: [B, N, N] int32; N a
    multiple of `tile`. Returns (tile_src [B, Td, Smax], tile_rel
    [B, Td, Smax, tile, tile]), the JAX package's arrays. own: the (lo,
    hi) rows to fill (module docstring)."""
    B, N, N2 = keep.shape
    assert N == N2 and N % tile == 0, (N, N2, tile)
    Td = N // tile
    blocks = keep.reshape(B, Td, tile, Td, tile).any(axis=(2, 4))
    return _pack(blocks, lambda lo, hi: _masked(keep, rel_index, lo, hi)
                 .reshape(-1, Td, tile, Td, tile).transpose(0, 1, 3, 2, 4),
                 tile, own)


def pack_block_sparse_src(keep: np.ndarray, rel_index: np.ndarray,
                          tile: int = TILE, own=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The src-major transpose of pack_block_sparse: (tile_dst
    [B, Ts, Smax_s], tile_rel_src [B, Ts, Smax_s, tile, tile]) with each
    block in [src-local j, dst-local i] orientation, -1 = dropped pair."""
    B, N, N2 = keep.shape
    assert N == N2 and N % tile == 0, (N, N2, tile)
    Ts = N // tile
    blocks = keep.reshape(B, Ts, tile, Ts, tile).any(axis=(2, 4))
    return _pack(blocks.transpose(0, 2, 1),
                 lambda lo, hi: _masked(keep, rel_index, lo, hi)
                 .reshape(-1, Ts, tile, Ts, tile).transpose(0, 3, 1, 4, 2),
                 tile, own)


def _cells(keep, rel_index, cp_shards, tile):
    """[B, N, N] -> [B*S*S, Nl, Nl] cell matrices, (d, s) dst-block major."""
    B, N, N2 = keep.shape
    S = cp_shards
    assert N == N2 and N % S == 0, (N, N2, S)
    Nl = N // S
    assert Nl % tile == 0, (
        f"node block {Nl} (= {N}/{S}) must be a multiple of {tile} for "
        "the block-sparse CP layout")
    cut = lambda x: x.reshape(B, S, Nl, S, Nl).transpose(  # noqa: E731
        0, 1, 3, 2, 4).reshape(B * S * S, Nl, Nl)
    return cut(keep), cut(rel_index)


def pack_block_sparse_cells(keep: np.ndarray, rel_index: np.ndarray,
                            cp_shards: int, tile: int = TILE, own=None):
    """The ring's per-cell tile layout: the node dim cut into S =
    cp_shards blocks of Nl = N/S nodes (a multiple of `tile`), each
    (d, s) cell packed by pack_block_sparse with block-local tile ids.
    Returns ctile_src [B, S, S, Tdl, Smax_c] int32 (-1 pad) and ctile_rel
    [B, S, S, Tdl, Smax_c, tile, tile] int32 (-1 = dropped); Smax_c is
    the most nonempty blocks of any cell's tile."""
    B, S = keep.shape[0], cp_shards
    own_c = None if own is None else (own[0] * S * S, own[1] * S * S)
    ts, tr = pack_block_sparse(*_cells(keep, rel_index, S, tile), tile=tile,
                               own=own_c)
    Tdl, smax = ts.shape[1:]
    return (ts.reshape(B, S, S, Tdl, smax),
            tr.reshape(B, S, S, Tdl, smax, tile, tile))


def pack_block_sparse_cells_src(keep: np.ndarray, rel_index: np.ndarray,
                                cp_shards: int, tile: int = TILE, own=None):
    """The src-major twin of pack_block_sparse_cells, for the ring's
    backward: ctile_dst [B, S, S, Tsl, Smax_cs] and ctile_rel_src
    [B, S, S, Tsl, Smax_cs, tile, tile] ([src-local j, dst-local i]
    blocks), cell (d, s) dst-block major as in ctile_src."""
    B, S = keep.shape[0], cp_shards
    own_c = None if own is None else (own[0] * S * S, own[1] * S * S)
    td, trs = pack_block_sparse_src(*_cells(keep, rel_index, S, tile),
                                    tile=tile, own=own_c)
    Tsl, smax = td.shape[1:]
    return (td.reshape(B, S, S, Tsl, smax),
            trs.reshape(B, S, S, Tsl, smax, tile, tile))


def keep_from_edge_cells(edge_src, edge_dst, edge_mask, num_nodes: int,
                         edge_rel=None):
    """The [B, N, N] kept-pair mask (and with edge_rel the rel matrix)
    from batchify's [B, S, S, Ec] edge cells."""
    B, S, S2, Ec = edge_src.shape
    nl = num_nodes // S
    keep = np.zeros((B, num_nodes, num_nodes), bool)
    rel = np.zeros((B, num_nodes, num_nodes), np.int32)
    for b in range(B):
        for d in range(S):
            for s in range(S2):
                m = edge_mask[b, d, s]
                ii = edge_dst[b, d, s][m] + d * nl
                jj = edge_src[b, d, s][m] + s * nl
                keep[b, ii, jj] = True
                if edge_rel is not None:
                    rel[b, ii, jj] = edge_rel[b, d, s][m]
    return (keep, rel) if edge_rel is not None else keep
