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

The per-cell layouts of the context-parallel ring (pack_block_sparse_cells*)
come with ROADMAP A9.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TILE = 128


def _pack(blocks: np.ndarray, planes: np.ndarray, tile: int):
    """blocks [B, Td, Ts] nonempty map; planes [B, Td, Ts, tile, tile]
    masked rel blocks -> (ids [B, Td, Smax], rel [B, Td, Smax, tile, tile]):
    each row's nonempty block ids front-packed in ascending order (a stable
    argsort), -1 padded."""
    B, Td = blocks.shape[:2]
    smax = max(1, int(blocks.sum(-1).max()))
    order = np.argsort(~blocks, axis=2, kind="stable")[..., :smax]
    slot_ok = np.arange(smax)[None, None, :] < blocks.sum(-1, keepdims=True)
    ids = np.where(slot_ok, order, -1).astype(np.int32)
    got = np.take_along_axis(planes, order[..., None, None], axis=2)
    rel = np.where(slot_ok[..., None, None], got, -1).astype(np.int32)
    return ids, rel


def pack_block_sparse(keep: np.ndarray, rel_index: np.ndarray,
                      tile: int = TILE) -> Tuple[np.ndarray, np.ndarray]:
    """keep: [B, N, N] bool kept-pair mask; rel_index: [B, N, N] int32; N a
    multiple of `tile`. Returns (tile_src [B, Td, Smax], tile_rel
    [B, Td, Smax, tile, tile]), the JAX package's arrays."""
    B, N, N2 = keep.shape
    assert N == N2 and N % tile == 0, (N, N2, tile)
    Td = N // tile
    blocks = keep.reshape(B, Td, tile, Td, tile).any(axis=(2, 4))
    mr = np.where(keep, rel_index, -1).astype(np.int32)
    planes = mr.reshape(B, Td, tile, Td, tile).transpose(0, 1, 3, 2, 4)
    return _pack(blocks, planes, tile)


def pack_block_sparse_src(keep: np.ndarray, rel_index: np.ndarray,
                          tile: int = TILE) -> Tuple[np.ndarray, np.ndarray]:
    """The src-major transpose of pack_block_sparse: (tile_dst
    [B, Ts, Smax_s], tile_rel_src [B, Ts, Smax_s, tile, tile]) with each
    block in [src-local j, dst-local i] orientation, -1 = dropped pair."""
    B, N, N2 = keep.shape
    assert N == N2 and N % tile == 0, (N, N2, tile)
    Ts = N // tile
    blocks = keep.reshape(B, Ts, tile, Ts, tile).any(axis=(2, 4))
    mr = np.where(keep, rel_index, -1).astype(np.int32)
    planes = mr.reshape(B, Ts, tile, Ts, tile).transpose(0, 3, 1, 4, 2)
    return _pack(blocks.transpose(0, 2, 1), planes, tile)


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
