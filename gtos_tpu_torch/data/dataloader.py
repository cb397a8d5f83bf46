"""Host-side data pipeline: preprocessing, bucketing, token-based batching.

Port of gtos_tpu/data/dataloader.py: the same batch plan (bucket by padded
(N, T) signature, token-count batch sizing with an optional cap on
instances per batch, shuffle per epoch for training), the same
bank-overflow bisect, the batch dimension padded to a power of two and
then to `batch_multiple`, and batches built in this process or by a pool
of worker processes or threads, yielded in plan order with the same
arrays. Under data parallelism (host_count > 1) every rank plans the same
batches and fills only its own rows (batchify's host_shard).

One instance whose relation paths overflow the last rung of the bank
ladders, where bisection cannot help, is batched alone at a rung of its
own (BucketSpec.with_lone_rungs: doublings of the last rung), with the
arrays a BucketSpec ending at that rung gives; the JAX package raises
there. Every batch that fits the ladders is built as before.

Spans (utils/profiling.py): "gtos/loader/emit", each batchify call in
this process (on a thread pool's threads too); "gtos/loader/lone_rung",
the batchify of a lone graph at its rung, inside it; "gtos/loader/pool_wait",
the iterating thread's wait for the pool's next group. Counters, running
totals over the batches yielded: `lone_rung_batches`, the batches at a
lone rung, and `lone_rung_largest`, the largest such rung (0 before one).
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import pickle
import random
from collections import deque
from typing import Iterator, List, Optional, Sequence, Union

from gtos_tpu_torch import native
from gtos_tpu_torch.data.batching import (
    BankOverflowError, BatchCapacityError, BucketSpec, GraphBatch, Instance,
    batchify,
)
from gtos_tpu_torch.data.vocab import LexicalMap, Vocab
from gtos_tpu_torch.graph.ir import Graph
from gtos_tpu_torch.graph.paths import (
    PathInterner, RelationPathConfig, pack_relation_paths,
)
from gtos_tpu_torch.utils.profiling import annotate

# which extractor the last preprocess call ran: "native" (the C++
# extractor, gtos_tpu_torch/native) or "python" (its build or load failed)
EXTRACTOR: Optional[str] = None
# seconds a pool may take for one group's batches before the loader
# raises instead of waiting on
POOL_TIMEOUT_S = 300.0


def _path_packer():
    """(name, pack function): the C++ extractor when it builds and loads,
    else the Python BFS, as the JAX package's preprocess chooses."""
    try:
        native.load()
    except (OSError, RuntimeError):
        return "python", pack_relation_paths
    return "native", native.pack_relation_paths_native


def preprocess(
    graphs: Sequence[Graph],
    targets: Sequence[List[str]],
    path_cfg: RelationPathConfig = RelationPathConfig(),
    max_nodes: Optional[int] = None,
    interner: Optional[PathInterner] = None,
) -> List[Instance]:
    """Graph + target -> Instance with precomputed shortest-path relations.

    The all-pairs BFS runs here, on the host, once per instance: in C++
    when the native extractor builds, in Python otherwise (the same
    PackedPaths; `EXTRACTOR` names the one that ran). Every instance's
    unique paths are interned into one corpus-level PathInterner (pass
    `interner` to share a table across calls), so batchify's bank dedup
    runs vectorized."""
    global EXTRACTOR
    EXTRACTOR, pack = _path_packer()
    if interner is None:
        interner = PathInterner()
    out: List[Instance] = []
    for i, (g, tgt) in enumerate(zip(graphs, targets)):
        if max_nodes is not None and g.num_nodes + 1 > max_nodes:
            continue
        pp = pack(g, path_cfg)
        pp.uniq_gid = interner.intern_many(pp.uniq)
        pp.interner = interner
        pp.uniq = None  # strings live once, in the interner
        out.append(Instance(concepts=list(g.nodes), pair_paths=pp,
                            target=list(tgt), meta=g.meta, orig_index=i))
    return out


# the process pool's workers: each unpickles the loader once (the
# initializer), then packs groups addressed by instance indices with the
# loader's own _emit
_POOL_LOADER = None


def _pool_init(loader_bytes):
    global _POOL_LOADER
    _POOL_LOADER = pickle.loads(loader_bytes)


def _pool_emit(idxs):
    ld = _POOL_LOADER
    return ld._emit_sizes([ld.instances[i] for i in idxs])


class DataLoader:
    """Iterates GraphBatches with token-count batch sizing.

    batch_size is measured in target tokens + nodes per batch;
    max_batch_instances caps the instances of a planned batch; for_train
    shuffles instance order and batch order each epoch. The batch
    dimension is padded to a power of two, then up to a multiple of
    batch_multiple (the data-parallel width). build_edges, cp_shards,
    sparse_khop, build_block_tiles and build_local_banks go to batchify
    ("auto" for the last two under attention_impl "auto"). host_rank and
    host_count > 1: the batch plan is the same on every rank (same seed
    and epoch), and batchify fills only this rank's contiguous rows
    (host_shard); batch_multiple must be a multiple of host_count, so that
    every batch divides evenly.

    workers > 1 builds the batches in a pool, `workers` wide with up to
    2 x workers groups in flight, and yields them in plan order with the
    same arrays as workers=0. worker_mode "process" starts the workers
    from a forkserver (spawn where there is none), never by forking this
    process: a trainer creates the pool lazily, in its prefetch thread,
    after the CUDA context exists, and a fork of a process that holds one
    and other threads can hang in the child on a lock taken at the fork.
    Each worker unpickles the loader once and is sent instance indices;
    packing is numpy and calls no torch op, so the workers never touch
    the card. "thread" runs the same packing on a thread pool. A group
    not packed within POOL_TIMEOUT_S seconds raises TimeoutError. close()
    (or the loader's collection) shuts the pool down. As with any spawn
    or forkserver pool, a worker imports the main module first (as
    `__mp_main__`), so a script that iterates a pooled loader keeps its
    entry point under `if __name__ == "__main__":`.
    """

    def __init__(
        self,
        instances: Sequence[Instance],
        token_vocab: Vocab,
        concept_vocab: Vocab,
        relation_vocab: Vocab,
        char_vocab: Vocab,
        lexical_map: LexicalMap,
        batch_size_tokens: int = 4096,
        max_batch_instances: Optional[int] = None,
        spec: BucketSpec = BucketSpec(),
        for_train: bool = True,
        seed: int = 19940117,
        batch_multiple: int = 1,
        build_edges: bool = False,
        cp_shards: int = 1,
        sparse_khop: int = 0,
        build_block_tiles: Union[bool, str] = False,
        build_local_banks: Union[bool, str] = False,
        host_rank: int = 0,
        host_count: int = 1,
        workers: int = 0,
        worker_mode: str = "process",
    ):
        self._pool = None  # created at first use, kept across epochs
        if host_count > 1 and batch_multiple % host_count:
            raise ValueError(f"batch_multiple {batch_multiple} must be a "
                             f"multiple of host_count {host_count}")
        if worker_mode not in ("process", "thread"):
            raise ValueError(f"worker_mode {worker_mode!r}: 'process' or "
                             "'thread'")
        self.instances = list(instances)
        self.vocabs = dict(
            token=token_vocab, concept=concept_vocab,
            relation=relation_vocab, char=char_vocab,
        )
        self.lexical_map = lexical_map
        self.batch_size_tokens = batch_size_tokens
        self.max_batch_instances = max_batch_instances
        self.spec = spec
        self.for_train = for_train
        self.seed = seed
        self.epoch = 0
        self.batch_multiple = batch_multiple
        self.build_edges = build_edges
        self.cp_shards = cp_shards
        self.sparse_khop = sparse_khop
        self.build_block_tiles = build_block_tiles
        self.build_local_banks = build_local_banks
        self.host_rank = host_rank
        self.host_count = host_count
        self.workers = workers
        self.worker_mode = worker_mode
        self.lone_rung_batches = 0
        self.lone_rung_largest = 0

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
        cap = self.max_batch_instances
        for inst in insts:
            sig = self._signature(inst)
            c = self._cost(inst)
            if cur and (sig != cur_sig
                        or cur_cost + c > self.batch_size_tokens
                        or (cap and len(cur) >= cap)):
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
        overflows the bucket cap, bisect until it fits, and batch a lone
        instance over the bank ladders at a rung of its own."""
        try:
            with annotate("gtos/loader/emit"):
                batch = self._batchify(group, self.spec)
        except BatchCapacityError as err:
            if len(group) == 1:
                if not isinstance(err, BankOverflowError):
                    raise  # one instance over the cap is a data problem
                with annotate("gtos/loader/emit"), \
                        annotate("gtos/loader/lone_rung"):
                    batch = self._batchify(group,
                                           self.spec.with_lone_rungs())
                yield batch, group
                return
            mid = len(group) // 2
            yield from self._emit(group[:mid])
            yield from self._emit(group[mid:])
        else:
            yield batch, group

    def _batchify(self, group, spec: BucketSpec) -> GraphBatch:
        # Pad the batch dim to a power of two, then to batch_multiple.
        bsz = 1
        while bsz < len(group):
            bsz *= 2
        m = self.batch_multiple
        bsz = -(-bsz // m) * m
        return batchify(
            group,
            self.vocabs["token"], self.vocabs["concept"],
            self.vocabs["relation"], self.vocabs["char"],
            self.lexical_map, spec=spec,
            batch_size_bucket=bsz, for_train=self.for_train,
            build_edges=self.build_edges, cp_shards=self.cp_shards,
            sparse_khop=self.sparse_khop,
            build_block_tiles=self.build_block_tiles,
            build_local_banks=self.build_local_banks,
            host_shard=((self.host_rank, self.host_count)
                        if self.host_count > 1 else None))

    def _count(self, batch: GraphBatch) -> GraphBatch:
        """Count the batch in the lone-rung counters if its bank lies above
        the spec's ladders (a lone graph's rung)."""
        rung = 0
        if batch.rel_bank.shape[0] > self.spec.bank[-1]:
            rung = batch.rel_bank.shape[0]
        if batch.bank_map is not None and \
                batch.bank_map.shape[1] > self.spec.local_bank[-1]:
            rung = max(rung, batch.bank_map.shape[1])
        if rung:
            self.lone_rung_batches += 1
            self.lone_rung_largest = max(self.lone_rung_largest, rung)
        return batch

    def _emit_sizes(self, group) -> List[tuple]:
        """_emit's batches, each with the count of the group's instances
        it holds, in order (a pool sends back no instance)."""
        return [(batch, len(part)) for batch, part in self._emit(group)]

    def _get_pool(self) -> concurrent.futures.Executor:
        if self._pool is None:
            if self.worker_mode == "thread":
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    self.workers, thread_name_prefix="gtos-batchify")
            else:
                clone = DataLoader.__new__(DataLoader)
                clone.__dict__.update(self.__dict__)
                clone.workers, clone._pool = 0, None
                method = ("forkserver" if "forkserver"
                          in multiprocessing.get_all_start_methods()
                          else "spawn")
                self._pool = concurrent.futures.ProcessPoolExecutor(
                    self.workers,
                    mp_context=multiprocessing.get_context(method),
                    initializer=_pool_init,
                    initargs=(pickle.dumps(clone),))
        return self._pool

    def close(self):
        """Shut the worker pool down (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        self.close()

    def _iter_emitted(self) -> Iterator:
        """(batch, group) pairs in plan order, built here or, with
        workers > 1, by the pool with up to 2 x workers groups in
        flight."""
        groups = self._plan_batches()
        if self.workers <= 1 or len(groups) < 2:
            for group in groups:
                for batch, part in self._emit(group):
                    yield self._count(batch), part
            return
        pool = self._get_pool()
        if self.worker_mode == "thread":
            task, items = self._emit_sizes, groups
        else:
            pos = {id(inst): i for i, inst in enumerate(self.instances)}
            task = _pool_emit
            items = [[pos[id(inst)] for inst in group] for group in groups]
        todo = iter(zip(items, groups))
        futs: deque = deque()

        def submit():
            item, group = next(todo, (None, None))
            if item is not None:
                futs.append((pool.submit(task, item), group))

        for _ in range(2 * self.workers):
            submit()
        try:
            while futs:
                fut, group = futs.popleft()
                try:
                    with annotate("gtos/loader/pool_wait"):
                        done = fut.result(timeout=POOL_TIMEOUT_S)
                except concurrent.futures.TimeoutError:
                    self.close()
                    raise TimeoutError(
                        f"the batchify pool ({self.workers} "
                        f"{self.worker_mode} workers) packed no group in "
                        f"{POOL_TIMEOUT_S} s")
                start = 0
                for batch, n in done:
                    yield self._count(batch), group[start:start + n]
                    start += n
                submit()
        finally:
            # a consumer that stops early (a trainer at total_steps, the
            # train CLI's example batch) leaves no queued group to pack
            # ahead of the next epoch's
            for fut, _ in futs:
                fut.cancel()

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
