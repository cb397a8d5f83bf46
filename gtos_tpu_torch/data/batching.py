"""Static-shape bucketed batching with the relation-bank dedup.

Port of gtos_tpu/data/batching.py: the same bucket ladders, the same
batch-global relation bank (`rel_bank` [P, L] of unique shortest-path
label sequences, `rel_index` [B, N, N] into it) and the same per-graph
localized banks (`bank_map`, `rel_index_loc`, and for training batches the
localize sort auxiliaries `loc_perm`/`loc_bnd`), array for array.

The sparse tier's arrays are the JAX package's too: with build_edges the
COO edge cells `edge_src/edge_dst/edge_rel/edge_mask` [B, 1, 1, Ec] of the
kept pairs (every real ordered pair, or with sparse_khop = k > 0 the pairs
whose path has at most k labels, self and global-node pairs always), and
with build_block_tiles the 128x128 tile layouts `tile_src/tile_rel` and
their src-major transpose `tile_dst/tile_rel_src` (ops/block_sparse.py).
With sparse_khop > 0 a path longer than k labels maps to the NONE bank row,
so pruned pairs do not grow the bank.

The "auto" aux mode of attention_impl "auto" is the JAX package's:
build_block_tiles="auto" builds no tiles and build_local_banks="auto"
builds the local banks; a batch whose path diversity overflows the local
bank ladder raises BatchCapacityError (the DataLoader bisects it), except
at a tile-aligned node bucket, where it falls back to the tile layouts
(which resolve_attention_impl routes to "block_sparse").

Context parallelism (cp_shards = S > 1) cuts the node dim into S blocks:
the edge cells become [B, S, S, Ec], cell (d, s) holding the kept pairs
with dst in block d and src in block s, ids block-local; with tiles, each
cell is packed on its own (`ctile_src/ctile_rel`, and for training
batches their src-major twin `ctile_dst/ctile_rel_src`), which needs N to
be a multiple of S*128. host_shard=(rank, world) fills the row arrays of
rank's contiguous slice of the batch only: the bucket sizes and the
relation bank come from every row, so they agree on every rank without
communication (parallel/mesh.py takes each rank's rows).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gtos_tpu_torch.data.vocab import LexicalMap, Vocab
from gtos_tpu_torch.graph.paths import GLOBAL_LABEL, PackedPaths
from gtos_tpu_torch.ops.block_sparse import (
    TILE, pack_block_sparse, pack_block_sparse_cells,
    pack_block_sparse_cells_src, pack_block_sparse_src,
)


class BatchCapacityError(ValueError):
    """A batch exceeds a static-shape bucket cap (relation bank, edge cell,
    node count); the DataLoader bisects the batch and retries."""


class BankOverflowError(BatchCapacityError):
    """The batch's relation paths overflow the last rung of `bank` or
    `local_bank`; a lone graph over it takes a rung of its own
    (BucketSpec.with_lone_rungs, the DataLoader)."""


@dataclasses.dataclass
class Instance:
    """One preprocessed example: graph side + target side, still as strings.

    pair_paths: the PackedPaths of the real nodes' shortest-path label
    tuples, interned by preprocess (no global node yet — batchify adds it
    at position 0).
    """

    concepts: List[str]
    pair_paths: PackedPaths
    target: List[str]
    meta: Optional[dict] = None
    orig_index: int = -1  # position in the source corpus (output ordering)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Size ladders; each dim is padded up to the smallest bucket >= actual.
    The last entry is the hard cap, except that the DataLoader batches a
    lone graph over `bank` or `local_bank` at a rung above it
    (with_lone_rungs). Same ladders as the JAX package."""

    nodes: Tuple[int, ...] = (16, 32, 64, 128)        # incl. global node
    target: Tuple[int, ...] = (16, 32, 64, 128)       # incl. STR/END
    bank: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)
    local_bank: Tuple[int, ...] = (128, 256, 384, 512, 640, 768, 896,
                                   1024, 1280, 1536, 2048, 4096)
    path_len: Tuple[int, ...] = (2, 4, 8)
    chars: Tuple[int, ...] = (8, 16, 24)
    # hard cap on per-instance copyable OOVs; MUST equal the model's
    # ModelConfig.max_oov (extended ids are V + oov position)
    max_oov: int = 64
    edge_cells: Tuple[int, ...] = (
        64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)

    def for_model_max_oov(self, model_max_oov: int) -> "BucketSpec":
        return dataclasses.replace(self, max_oov=model_max_oov)

    def with_lone_rungs(self) -> "BucketSpec":
        """This spec with `bank` and `local_bank` each continued by
        doublings of its last rung up to nodes[-1]**2, which no graph of
        the largest node bucket exceeds (its real pairs, the pad and the
        global path): the ladders of a lone graph over the cap."""
        cap = self.nodes[-1] ** 2

        def up(ladder):
            out = list(ladder)
            while out[-1] < cap:
                out.append(2 * out[-1])
            return tuple(out)

        return dataclasses.replace(self, bank=up(self.bank),
                                   local_bank=up(self.local_bank))

    @staticmethod
    def fit(ladder: Tuple[int, ...], size: int) -> int:
        for b in ladder:
            if size <= b:
                return b
        return ladder[-1]


@dataclasses.dataclass
class GraphBatch:
    """Host arrays (numpy) of one batch; node position 0 in every instance
    is the global CLS node. Field names and layouts are the JAX package's."""

    concept: np.ndarray       # [B, N] int32 concept ids (0 = PAD)
    concept_char: np.ndarray  # [B, N, C] int32 char ids
    concept_mask: np.ndarray  # [B, N] bool, True at real nodes (incl. CLS)
    rel_index: np.ndarray     # [B, N, N] int32 -> rel_bank row per (i, j)
    rel_bank: np.ndarray      # [P, L] int32 relation-label ids (row 0 = pad)
    rel_length: np.ndarray    # [P] int32 path lengths (row 0 -> 0)
    token_in: np.ndarray      # [B, T] int32, STR-prefixed (token vocab ids)
    token_out: np.ndarray     # [B, T] int32, END-suffixed, EXTENDED ids
    token_mask: np.ndarray    # [B, T] bool, True at real target positions
    cp_seq: np.ndarray        # [B, N] int32 extended id copying node n yields
    copy_mask: np.ndarray     # [B, N] bool, True where copying is allowed
    # sparse edge cells (build_edges=True): [B, S, S, Ec], cell (d, s) holds
    # the kept pairs with dst in node block d and src in node block s, ids
    # block-local (S = cp_shards; S = 1: plain batched COO)
    edge_src: Optional[np.ndarray] = None   # [B, S, S, Ec] int32
    edge_dst: Optional[np.ndarray] = None   # [B, S, S, Ec] int32
    edge_rel: Optional[np.ndarray] = None   # [B, S, S, Ec] int32 bank rows
    edge_mask: Optional[np.ndarray] = None  # [B, S, S, Ec] bool
    # block-sparse tile layouts (build_block_tiles=True; ops/block_sparse.py)
    tile_src: Optional[np.ndarray] = None      # [B, Td, Smax] int32
    tile_rel: Optional[np.ndarray] = None      # [B, Td, Smax, 128, 128] int32
    tile_dst: Optional[np.ndarray] = None      # [B, Ts, Smax_s] int32
    tile_rel_src: Optional[np.ndarray] = None  # [B, Ts, Smax_s, 128, 128]
    # per-cell tile layouts of the context-parallel ring (cp_shards > 1)
    ctile_src: Optional[np.ndarray] = None      # [B, S, S, Tdl, Smax_c]
    ctile_rel: Optional[np.ndarray] = None      # [..., Smax_c, 128, 128]
    ctile_dst: Optional[np.ndarray] = None      # [B, S, S, Tsl, Smax_cs]
    ctile_rel_src: Optional[np.ndarray] = None  # [..., Smax_cs, 128, 128]
    # per-graph LOCALIZED relation bank (build_local_banks=True): each graph
    # references only its own P_loc distinct paths
    bank_map: Optional[np.ndarray] = None       # [B, P_loc] int32 -> bank row
    rel_index_loc: Optional[np.ndarray] = None  # [B, N, N] int32 local slots
    # training batches only: the localize gather's sort order (the JAX
    # package's scatter-free backward; ops/localize.py)
    loc_perm: Optional[np.ndarray] = None       # [B*P_loc] int32
    loc_bnd: Optional[np.ndarray] = None        # [2, P] int32
    oov_lists: List[List[str]] = dataclasses.field(default_factory=list)
    meta: List[Optional[dict]] = dataclasses.field(default_factory=list)

    @property
    def batch_size(self) -> int:
        return self.concept.shape[0]

    @property
    def num_oov(self) -> int:
        return max((len(o) for o in self.oov_lists), default=0)

    def arrays(self) -> Dict[str, np.ndarray]:
        """The device payload (drops host-only and absent fields)."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("oov_lists", "meta")
            and getattr(self, f.name) is not None
        }


def build_localize_aux(bank_map: np.ndarray, P: int):
    """Host-side sort order of the localize gather.

    bank_map: [B, P_loc] int32 global bank row per local slot (rows sorted
    ascending per graph; pad slots map to row 0). Returns (loc_perm
    [B*P_loc] int32, loc_bnd [2, P] int32) with loc_bnd[0/1][p] = start/end
    of bank row p's run in the sorted flat ids."""
    flat = np.asarray(bank_map).reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    sorted_ids = flat[perm]
    rows = np.arange(P, dtype=flat.dtype)
    starts = np.searchsorted(sorted_ids, rows, side="left")
    ends = np.searchsorted(sorted_ids, rows, side="right")
    return perm, np.stack([starts, ends]).astype(np.int32)


def _encode_chars(word: str, char_vocab: Vocab, width: int) -> List[int]:
    ids = [char_vocab.encode(c) for c in word[:width]]
    return ids + [char_vocab.pad_id] * (width - len(ids))


def batchify(
    instances: Sequence[Instance],
    token_vocab: Vocab,
    concept_vocab: Vocab,
    relation_vocab: Vocab,
    char_vocab: Vocab,
    lexical_map: LexicalMap,
    spec: BucketSpec = BucketSpec(),
    batch_size_bucket: Optional[int] = None,
    for_train: bool = True,
    build_edges: bool = False,
    cp_shards: int = 1,
    sparse_khop: int = 0,
    build_block_tiles: Union[bool, str] = False,
    build_local_banks: Union[bool, str] = False,
    host_shard: Optional[Tuple[int, int]] = None,
) -> GraphBatch:
    """Assemble one static-shape GraphBatch from preprocessed instances.

    Same arrays as gtos_tpu.data.batching.batchify (module docstring).
    sparse_khop: 0 keeps every real ordered pair; k > 0 keeps the pairs
    whose shortest path has at most k labels (the sparse impls only).
    cp_shards: node blocks of the context-parallel cells; host_shard:
    (rank, world), the row slice to fill (module docstring)."""
    # the "auto" aux mode: local banks at every bucket, tiles only as the
    # overflow fallback below
    aux_auto = "auto" in (build_block_tiles, build_local_banks)
    if build_block_tiles == "auto":
        build_block_tiles = False
    if build_local_banks == "auto":
        build_local_banks = True
    # khop pruning is for the sparse consumers, which mask pruned pairs
    # out; a dense impl would attend to them with the NONE path's vector
    if sparse_khop > 0 and not (build_edges or build_block_tiles):
        raise ValueError(
            "sparse_khop > 0 requires build_edges/build_block_tiles (a "
            "sparse attention_impl); dense impls must see the true paths")
    B = batch_size_bucket or len(instances)
    if B < len(instances):
        raise ValueError(f"batch bucket {B} < {len(instances)} instances")
    own_lo, own_hi = 0, B
    if host_shard is not None:
        rank, world = host_shard
        if B % world != 0:
            raise BatchCapacityError(
                f"batch bucket {B} not divisible by host count {world}; "
                "set DataLoader batch_multiple to a multiple of it")
        own_lo, own_hi = rank * (B // world), (rank + 1) * (B // world)

    N = BucketSpec.fit(spec.nodes, max(len(i.concepts) + 1 for i in instances))
    T = BucketSpec.fit(spec.target, max(len(i.target) + 1 for i in instances))
    C = BucketSpec.fit(spec.chars, max(
        (len(c) for i in instances for c in i.concepts), default=1))
    L_cap = spec.path_len[-1]

    # ---- relation bank dedup (batch-global) ----
    # One np.unique over the instances' interned path ids, rows in order of
    # first appearance over [pad, global, each instance's unique paths]:
    # the JAX package's bank layout (its dict-insertion order).
    pps = [inst.pair_paths for inst in instances]
    interners = {id(getattr(pp, "interner", None)): pp for pp in pps}
    if len(interners) != 1 or getattr(pps[0], "uniq_gid", None) is None:
        raise ValueError("batchify takes instances from preprocess() that "
                         "share one PathInterner")
    interner = pps[0].interner
    g_pad = interner.intern(())
    g_global = interner.intern((GLOBAL_LABEL,))
    # derived maps AFTER the interns above (they may append rows)
    trim = interner.trim_map(L_cap)
    mapped = [trim[pp.uniq_gid] for pp in pps]
    if sparse_khop > 0:
        # pruned pairs are masked out of every sparse consumer: their paths
        # map to the NONE row (interner id 0) instead of growing the bank
        glens = interner.lengths()
        mapped = [np.where(glens[m] > sparse_khop, np.int32(0), m)
                  for m in mapped]
    stream = np.concatenate([np.array([g_pad, g_global], np.int32), *mapped])
    uniq_g, first_i, inv = np.unique(stream, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_i, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    rows_stream = rank[inv].astype(np.int32)
    bank_gids = uniq_g[order]
    global_row = int(rows_stream[1])
    ends = np.cumsum([2] + [len(m) for m in mapped])[1:]
    local2bank_all = [rows_stream[ends[b] - len(mapped[b]): ends[b]]
                      for b in range(len(mapped))]

    concept = np.zeros((B, N), dtype=np.int32)
    concept_char = np.zeros((B, N, C), dtype=np.int32)
    concept_mask = np.zeros((B, N), dtype=bool)
    rel_index = np.zeros((B, N, N), dtype=np.int32)
    token_in = np.zeros((B, T), dtype=np.int32)
    token_out = np.zeros((B, T), dtype=np.int32)
    token_mask = np.zeros((B, T), dtype=bool)
    cp_seq = np.zeros((B, N), dtype=np.int32)
    copy_mask = np.zeros((B, N), dtype=bool)
    oov_lists: List[List[str]] = []
    metas: List[Optional[dict]] = []

    V = len(token_vocab)

    for b, inst in enumerate(instances):
        n_real = len(inst.concepts)
        nodes_here = n_real + 1  # + global CLS node at position 0
        if nodes_here > N:
            raise BatchCapacityError(
                f"instance with {n_real} nodes exceeds node cap {N}")

        # the mask and the relations of EVERY row: the bank and the sizes
        # must agree on every rank (host_shard)
        concept_mask[b, :nodes_here] = True
        rel_index[b, 0, :nodes_here] = global_row
        rel_index[b, :nodes_here, 0] = global_row
        rel_index[b, 1:n_real + 1, 1:n_real + 1] = \
            local2bank_all[b][inst.pair_paths.pair_idx]
        if not own_lo <= b < own_hi:
            oov_lists.append([])
            metas.append(inst.meta)
            continue

        concept[b, 0] = concept_vocab.cls_id
        concept_char[b, 0, :] = char_vocab.pad_id
        for i, c in enumerate(inst.concepts):
            concept[b, i + 1] = concept_vocab.encode(c)
            concept_char[b, i + 1] = _encode_chars(c, char_vocab, C)

        # copy targets -> extended vocab ids (capped at spec.max_oov so
        # extended ids never exceed the model's ext_vocab; OOVs past the
        # cap degrade to UNK)
        oov_cap = spec.max_oov
        oov: List[str] = []
        oov_pos: Dict[str, int] = {}
        cp_seq[b, 0] = token_vocab.unk_id
        for i, c in enumerate(inst.concepts):
            surf = lexical_map.copy_target(c)
            tid = token_vocab.stoi.get(surf)
            if tid is None:
                pos = oov_pos.get(surf)
                if pos is None and len(oov) < oov_cap:
                    pos = oov_pos[surf] = len(oov)
                    oov.append(surf)
                tid = V + pos if pos is not None else token_vocab.unk_id
            cp_seq[b, i + 1] = tid
            copy_mask[b, i + 1] = True

        # target side: token_in = [STR, w1..wk], token_out = [w1..wk, END].
        # Targets longer than the last bucket are cut without a warning, as
        # the JAX package does (array equality with it depends on this).
        tgt = inst.target[: T - 1]
        token_in[b, 0] = token_vocab.str_id
        for t, w in enumerate(tgt):
            token_in[b, t + 1] = token_vocab.encode(w)
            wid = token_vocab.stoi.get(w)
            if wid is None and w in oov_pos:
                wid = V + oov_pos[w]  # copyable OOV -> extended id
            token_out[b, t] = wid if wid is not None else token_vocab.unk_id
        token_out[b, len(tgt)] = token_vocab.end_id
        token_mask[b, : len(tgt) + 1] = True

        oov_lists.append(oov)
        metas.append(inst.meta)

    # ---- materialize the bank ----
    n_rows = len(bank_gids)
    P = BucketSpec.fit(spec.bank, n_rows)
    if n_rows > P:
        raise BankOverflowError(
            f"relation bank overflow: {n_rows} unique paths > cap {P}; use "
            "smaller batches or a larger bank bucket")
    bank_len = interner.lengths()[bank_gids]
    L = BucketSpec.fit(spec.path_len, int(bank_len.max(initial=1)))
    enc, enc_len = interner.encoded(relation_vocab, L)
    rel_bank = np.zeros((P, L), dtype=np.int32)
    rel_length = np.zeros((P,), dtype=np.int32)
    rel_bank[:n_rows] = enc[bank_gids]
    rel_length[:n_rows] = enc_len[bank_gids]
    bank_none = np.zeros((P,), bool)
    bank_none[:n_rows] = bank_gids == 0  # interner id 0 = the NONE path
    bank_len_p = np.zeros((P,), np.int32)
    bank_len_p[:n_rows] = bank_len

    local_arrays = {}
    if build_local_banks:
        try:
            local_arrays = _build_local_banks(rel_index, spec)
        except BatchCapacityError:
            # under "auto" a path-diverse batch falls back to the tile
            # layouts at a tile-aligned bucket (routed to "block_sparse");
            # elsewhere the overflow is the DataLoader's to bisect
            if not (aux_auto and N % TILE == 0):
                raise
            build_local_banks, build_block_tiles = False, True
        if build_local_banks and for_train:
            local_arrays["loc_perm"], local_arrays["loc_bnd"] = \
                build_localize_aux(local_arrays["bank_map"], P)

    edge_arrays = {}
    if build_edges or build_block_tiles:
        own = (own_lo, own_hi)
        edge_arrays, keep = _build_edge_cells(
            concept_mask, rel_index, bank_len_p, bank_none, spec, cp_shards,
            sparse_khop, own)
        if build_block_tiles:
            if cp_shards > 1 and N % (cp_shards * TILE) != 0:
                # the edge cells (built on N) and the tile cells must
                # describe the same node blocks
                raise BatchCapacityError(
                    f"node bucket {N} must be a multiple of "
                    f"cp_shards*{TILE} = {cp_shards * TILE} for the "
                    "block-sparse CP layout; use a BucketSpec with node "
                    "buckets of that granularity")
            Np = -(-N // TILE) * TILE
            keep_p = np.zeros((B, Np, Np), bool)
            keep_p[:, :N, :N] = keep
            rel_p = np.zeros((B, Np, Np), np.int32)
            rel_p[:, :N, :N] = rel_index
            if cp_shards > 1:
                cts, ctr = pack_block_sparse_cells(keep_p, rel_p, cp_shards,
                                                   own=own)
                edge_arrays.update(ctile_src=cts, ctile_rel=ctr)
                if for_train:
                    ctd, ctrs = pack_block_sparse_cells_src(
                        keep_p, rel_p, cp_shards, own=own)
                    edge_arrays.update(ctile_dst=ctd, ctile_rel_src=ctrs)
            else:
                ts, tr = pack_block_sparse(keep_p, rel_p, own=own)
                td, trs = pack_block_sparse_src(keep_p, rel_p, own=own)
                edge_arrays.update(tile_src=ts, tile_rel=tr, tile_dst=td,
                                   tile_rel_src=trs)
        if not build_edges:
            edge_arrays = {k: v for k, v in edge_arrays.items()
                           if k.startswith(("tile_", "ctile_"))}

    return GraphBatch(
        **edge_arrays,
        **local_arrays,
        concept=concept,
        concept_char=concept_char,
        concept_mask=concept_mask,
        rel_index=rel_index,
        rel_bank=rel_bank,
        rel_length=rel_length,
        token_in=token_in,
        token_out=token_out,
        token_mask=token_mask,
        cp_seq=cp_seq,
        copy_mask=copy_mask,
        oov_lists=oov_lists,
        meta=metas,
    )


def _build_local_banks(rel_index, spec: BucketSpec):
    """Per-graph localized relation-bank view (vectorized numpy).

    Each graph's distinct bank rows get contiguous local slots 0..P_loc-1
    (slot 0 = the pad path, bank row 0); `bank_map` recovers the global row
    per slot and `rel_index_loc` re-expresses the pair matrix in slots."""
    B, N, _ = rel_index.shape
    maps, locs, widths = [], [], []
    for b in range(B):
        # prepend row 0 so the pad path always owns slot 0 (np.unique
        # sorts ascending and rows are non-negative)
        rows, inv = np.unique(np.concatenate([[0], rel_index[b].ravel()]),
                              return_inverse=True)
        maps.append(rows)
        locs.append(inv[1:].reshape(N, N).astype(np.int32))
        widths.append(len(rows))
    P_loc = BucketSpec.fit(spec.local_bank, max(widths))
    if max(widths) > P_loc:
        raise BankOverflowError(
            f"local bank overflow: {max(widths)} distinct paths in one "
            f"graph > cap {P_loc}; raise spec.local_bank")
    bank_map = np.zeros((B, P_loc), dtype=np.int32)
    for b, rows in enumerate(maps):
        bank_map[b, : len(rows)] = rows
    return {"bank_map": bank_map, "rel_index_loc": np.stack(locs)}


def _build_edge_cells(concept_mask, rel_index, bank_len, bank_none,
                      spec: BucketSpec, cp_shards: int, sparse_khop: int,
                      own=None):
    """COO edge cells of the sparse encoder: returns ({'edge_src',
    'edge_dst', 'edge_rel', 'edge_mask'}, each [B, S, S, Ec]: cell (d, s)
    holds the kept pairs (i = dst query, j = src key) with i in node block
    d and j in node block s, ids block-local, in (i, j) order; keep
    [B, N, N] bool). Ec comes from every row, only the rows of `own` are
    filled."""
    B, N = concept_mask.shape
    own_lo, own_hi = own if own is not None else (0, B)
    S = cp_shards
    if N % S:
        raise ValueError(f"node bucket {N} not divisible by cp_shards {S}")
    nl = N // S
    keep = concept_mask[:, :, None] & concept_mask[:, None, :]
    if sparse_khop > 0:
        within = (bank_len[rel_index] <= sparse_khop) & ~bank_none[rel_index]
        always = np.eye(N, dtype=bool)          # self
        always[0, :] = always[:, 0] = True      # global node row/col
        keep &= within | always[None]
    per_b, max_cell = [], 1
    for b in range(B):
        ii, jj = np.nonzero(keep[b])          # row-major: (i, j) order
        cell = (ii // nl) * S + (jj // nl)
        order = np.argsort(cell, kind="stable")
        ii, jj, cell = ii[order], jj[order], cell[order]
        cnt = np.bincount(cell, minlength=S * S)
        max_cell = max(max_cell, int(cnt.max(initial=0)))
        per_b.append((ii, jj, cell, cnt))
    Ec = BucketSpec.fit(spec.edge_cells, max_cell)
    if max_cell > Ec:
        raise BatchCapacityError(
            f"edge cell overflow: {max_cell} edges in one (dst,src) block "
            f"pair > cap {Ec}; raise spec.edge_cells or cp_shards")
    esrc = np.zeros((B, S * S, Ec), dtype=np.int32)
    edst = np.zeros((B, S * S, Ec), dtype=np.int32)
    erel = np.zeros((B, S * S, Ec), dtype=np.int32)
    emask = np.zeros((B, S * S, Ec), dtype=bool)
    for b in range(own_lo, own_hi):
        ii, jj, cell, cnt = per_b[b]
        pos = np.arange(len(cell)) - (np.cumsum(cnt) - cnt)[cell]
        esrc[b, cell, pos] = jj % nl
        edst[b, cell, pos] = ii % nl
        erel[b, cell, pos] = rel_index[b, ii, jj]
        emask[b, cell, pos] = True
    shape = (B, S, S, Ec)
    return (dict(edge_src=esrc.reshape(shape), edge_dst=edst.reshape(shape),
                 edge_rel=erel.reshape(shape),
                 edge_mask=emask.reshape(shape)), keep)
