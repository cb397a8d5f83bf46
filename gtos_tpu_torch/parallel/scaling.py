"""Scaling report of the context-parallel schedules (BASELINE config 5).

Port of gtos_tpu/parallel/scaling.py: edges/s of the ring
(parallel/ring_attention.py) and the a2a schedule (a2a_attention.py) over
the mesh's 'graph' axis against the single-device sparse attention
(ops/sparse_relation.py), on real batchify edge cells (large synthetic
AMR graphs, khop-pruned), and efficiency = rate_S / (S * rate_1) per
schedule; the same JSON keys. Times are CUDA events on a card and
perf_counter on the CPU. Every rank of the mesh must call it; on one
card (S = 1) the mesh axis has one rank and no efficiency is measured.

    python -m gtos_tpu_torch.parallel.scaling --graph 2 --device cpu \\
        --out scaling_report.json
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def _bench(fn, device, iters=10, warmup=2):
    """Seconds per call of fn()."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _real_cells(B, N, S, seed, khop=2):
    """Edge cells [B, S, S, Ec] of synthetic AMR graphs of 0.8N to N-2
    nodes from the real pipeline (preprocess, batchify at cp_shards=S,
    khop-pruned) and the bank's row count."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus

    graphs, targets = synthetic_amr_corpus(
        B, seed=seed, min_nodes=int(N * 0.8), max_nodes=N - 2)
    vocabs = build_vocabs(graphs, targets)
    batch = batchify(preprocess(graphs, targets), *vocabs,
                     batch_size_bucket=B, spec=BucketSpec(nodes=(N,)),
                     build_edges=True, cp_shards=S, sparse_khop=khop)
    return ((batch.edge_src, batch.edge_dst, batch.edge_rel,
             batch.edge_mask), batch.rel_bank.shape[0])


def scaling_report(mesh, num_nodes: int = 512, batch: int = 2,
                   heads: int = 8, dim: int = 64, seed: int = 0) -> dict:
    """-> the scaling dict: edges/s on one device and over the mesh's
    'graph' axis for both CP schedules, on real batchify cells."""
    from gtos_tpu_torch.ops.sparse_relation import (
        flatten_edge_cells, sparse_relation_attention)
    from gtos_tpu_torch.parallel.a2a_attention import (
        a2a_sparse_relation_attention)
    from gtos_tpu_torch.parallel.ring_attention import (
        ring_sparse_relation_attention)

    S, dev = mesh.size("graph"), mesh.device
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(batch, heads, num_nodes, dim, generator=gen)
               .to(dev) for _ in range(3))
    cells1, P = _real_cells(batch, num_nodes, 1, seed)
    a_bank, b_bank = (0.5 * torch.randn(P, heads, dim, generator=gen)
                      .to(dev) for _ in range(2))
    to = lambda cells: tuple(torch.from_numpy(np.ascontiguousarray(x))  # noqa
                             .to(dev) for x in cells)
    E = int(cells1[3].sum())
    flat = flatten_edge_cells(*to(cells1), num_nodes)
    with torch.no_grad():
        t1 = _bench(lambda: sparse_relation_attention(
            q, k, v, a_bank, b_bank, *flat), dev)
        cellsS, P_s = _real_cells(batch, num_nodes, S, seed)
        assert P_s == P, (P_s, P)
        E_s = int(cellsS[3].sum())
        cellsS = to(cellsS)
        times = {name: _bench(lambda fn=fn: fn(
            mesh, q, k, v, a_bank, b_bank, *cellsS), dev)
            for name, fn in (("ring", ring_sparse_relation_attention),
                             ("a2a", a2a_sparse_relation_attention))}
    r1 = E / t1
    rates = {name: E_s / t for name, t in times.items()}
    out = {
        "op": ("sparse relation attention, CP schedules on real batchify "
               "cells"),
        "n_devices": S,
        "num_nodes": num_nodes,
        "bank_rows": int(P),
        "edges_1dev": E,
        "edges_mesh": E_s,
        "edges_per_s_1dev": r1,
        "faster_schedule": max(rates, key=rates.get),
        "per_device_nodes": num_nodes // S,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    for name, rate in rates.items():
        out[name] = {"edges_per_s_mesh": rate, "speedup": rate / r1,
                     "efficiency": rate / (S * r1)}
    return out


def main(argv=None):
    import argparse
    import os
    import tempfile

    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="scaling_report.json")
    p.add_argument("--num_nodes", type=int, default=512)
    p.add_argument("--graph", type=int, default=1,
                   help="ranks of the graph axis (one per card, or CPU "
                        "processes under --device cpu)")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    if args.device != "cpu" and torch.cuda.device_count() < args.graph:
        raise SystemExit(f"--graph {args.graph} needs {args.graph} cards, "
                         f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.start_processes(_rank, args=(args, init), nprocs=args.graph,
                           start_method="spawn")
    with open(args.out) as f:
        print(f.read())


def _rank(rank, args, init):
    import torch.distributed as dist

    from gtos_tpu_torch.parallel.mesh import init_distributed, make_mesh

    device = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    init_distributed(rank, args.graph, init, device)
    try:
        rep = scaling_report(make_mesh(dp=1, graph=args.graph,
                                       device=device),
                             num_nodes=args.num_nodes)
        if rank == 0:
            with open(args.out, "w") as f:
                json.dump(rep, f, indent=2)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
