"""Host-side data pipeline: preprocessing, bucketing, token-based batching.

Port of gtos_tpu/data/dataloader.py: the same batch plan (bucket by padded
(N, T) signature, token-count batch sizing, shuffle per epoch for training)
and the same bank-overflow bisect, built in order in this process. The
JAX package's process and thread pools, multi-host sharding, batch-size
multiple (for data parallelism) and per-batch instance cap come later
(ROADMAP A4, A9).
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence, Union

from gtos_tpu_torch.data.batching import (
    BatchCapacityError, BucketSpec, GraphBatch, Instance, batchify,
)
from gtos_tpu_torch.data.vocab import LexicalMap, Vocab
from gtos_tpu_torch.graph.ir import Graph
from gtos_tpu_torch.graph.paths import (
    PathInterner, RelationPathConfig, pack_relation_paths,
)


def preprocess(
    graphs: Sequence[Graph],
    targets: Sequence[List[str]],
    path_cfg: RelationPathConfig = RelationPathConfig(),
    max_nodes: Optional[int] = None,
    interner: Optional[PathInterner] = None,
) -> List[Instance]:
    """Graph + target -> Instance with precomputed shortest-path relations.

    The all-pairs BFS runs here, on the host, once per instance. Every
    instance's unique paths are interned into one corpus-level PathInterner
    (pass `interner` to share a table across calls), so batchify's bank
    dedup runs vectorized."""
    if interner is None:
        interner = PathInterner()
    out: List[Instance] = []
    for i, (g, tgt) in enumerate(zip(graphs, targets)):
        if max_nodes is not None and g.num_nodes + 1 > max_nodes:
            continue
        pp = pack_relation_paths(g, path_cfg)
        pp.uniq_gid = interner.intern_many(pp.uniq)
        pp.interner = interner
        pp.uniq = None  # strings live once, in the interner
        out.append(Instance(concepts=list(g.nodes), pair_paths=pp,
                            target=list(tgt), meta=g.meta, orig_index=i))
    return out


class DataLoader:
    """Iterates GraphBatches with token-count batch sizing.

    batch_size is measured in target tokens + nodes per batch; for_train
    shuffles instance order and batch order each epoch. build_edges,
    cp_shards, sparse_khop, build_block_tiles and build_local_banks go to
    batchify ("auto" for the last two under attention_impl "auto")."""

    def __init__(
        self,
        instances: Sequence[Instance],
        token_vocab: Vocab,
        concept_vocab: Vocab,
        relation_vocab: Vocab,
        char_vocab: Vocab,
        lexical_map: LexicalMap,
        batch_size_tokens: int = 4096,
        spec: BucketSpec = BucketSpec(),
        for_train: bool = True,
        seed: int = 19940117,
        build_edges: bool = False,
        cp_shards: int = 1,
        sparse_khop: int = 0,
        build_block_tiles: Union[bool, str] = False,
        build_local_banks: Union[bool, str] = False,
    ):
        self.instances = list(instances)
        self.vocabs = dict(
            token=token_vocab, concept=concept_vocab,
            relation=relation_vocab, char=char_vocab,
        )
        self.lexical_map = lexical_map
        self.batch_size_tokens = batch_size_tokens
        self.spec = spec
        self.for_train = for_train
        self.seed = seed
        self.epoch = 0
        self.build_edges = build_edges
        self.cp_shards = cp_shards
        self.sparse_khop = sparse_khop
        self.build_block_tiles = build_block_tiles
        self.build_local_banks = build_local_banks

    def _cost(self, inst: Instance) -> int:
        return max(len(inst.target) + 1, len(inst.concepts) + 1)

    def _signature(self, inst: Instance):
        return (BucketSpec.fit(self.spec.nodes, len(inst.concepts) + 1),
                BucketSpec.fit(self.spec.target, len(inst.target) + 1))

    def _plan_batches(self) -> List[List[Instance]]:
        rng = random.Random(self.seed * 1000003 + self.epoch)
        insts = list(self.instances)
        if self.for_train:
            rng.shuffle(insts)
        # Bucket by padded signature so each batch has one static shape.
        insts.sort(key=self._signature)
        batches: List[List[Instance]] = []
        cur: List[Instance] = []
        cur_cost = 0
        cur_sig = None
        for inst in insts:
            sig = self._signature(inst)
            c = self._cost(inst)
            if cur and (sig != cur_sig
                        or cur_cost + c > self.batch_size_tokens):
                batches.append(cur)
                cur, cur_cost = [], 0
            cur.append(inst)
            cur_cost += c
            cur_sig = sig
        if cur:
            batches.append(cur)
        if self.for_train:
            rng.shuffle(batches)
        return batches

    def _emit(self, group) -> Iterator:
        """Batchify a group as (GraphBatch, instances); if its relation bank
        overflows the bucket cap, bisect until it fits."""
        # Pad the batch dim to a power of two.
        bsz = 1
        while bsz < len(group):
            bsz *= 2
        try:
            yield batchify(
                group,
                self.vocabs["token"], self.vocabs["concept"],
                self.vocabs["relation"], self.vocabs["char"],
                self.lexical_map, spec=self.spec,
                batch_size_bucket=bsz, for_train=self.for_train,
                build_edges=self.build_edges, cp_shards=self.cp_shards,
                sparse_khop=self.sparse_khop,
                build_block_tiles=self.build_block_tiles,
                build_local_banks=self.build_local_banks,
            ), group
        except BatchCapacityError:
            if len(group) == 1:
                raise  # one instance over the cap is a data/config problem
            mid = len(group) // 2
            yield from self._emit(group[:mid])
            yield from self._emit(group[mid:])

    def _iter_emitted(self) -> Iterator:
        for group in self._plan_batches():
            yield from self._emit(group)

    def iter_with_instances(self) -> Iterator:
        """Yield (GraphBatch, instances-in-batch-order) pairs, so a decode
        loop can map hypotheses back to source instances."""
        self.epoch += 1
        yield from self._iter_emitted()

    def __iter__(self) -> Iterator[GraphBatch]:
        self.epoch += 1
        for batch, _ in self._iter_emitted():
            yield batch

    def __len__(self) -> int:
        return len(self._plan_batches())
