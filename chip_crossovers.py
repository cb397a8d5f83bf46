#!/usr/bin/env python3
"""Measures the two route rules of the relation attention on one NVIDIA
GPU, the numbers that `ops/relation_attention.py` `_inline_fits` and
`models/generator.py` `AUTO_LOCAL_RATIO` are set from (PERF.md §6,
"The route crossovers").

    python3 chip_crossovers.py [--iters N] [--device-iters N] [--steps N]
                               [--max-batches N]

From the repo root, on a machine with a card.

(a) The global-bank forward: B3' (the forward from the banks) against
    `build_tables` + B3 (the forward from score tables), at H=8 and Dh=64
    (the c2 and c4 widths), in bf16 and f32, at each node bucket N of
    SWEEP_N with the largest batch the c2 train loader (8192-token
    batches) makes at that bucket, and each bank size of SWEEP_P (the
    loader's ladder and one point past it). The index arrays are that
    batch's own: its instances batchified again at bank P; where their
    paths need more than P rows, rel_index is folded into P rows (r mod
    P) and the row says so. q, k, v and the banks are seeded normals,
    the banks the two halves of one [P, 2 H Dh] tensor as the layer
    passes them. Each forward alone (what serving runs) and each under
    `relation_attention_trainable` with its backward (what training runs;
    the backward rebuilds the tables either way, so only the forward's
    choice differs): CUDA events around cold calls (benchlib.time_samples,
    the L2 flushed and the card spun before each) and the profiler's
    device ms (benchlib.device_ms, the L2 flushed before each call). The
    two routes' outputs (and gradients) must agree within KERNEL_TOL's
    rtol of the largest value.

(b) The local/global crossover: batches of the c2 corpus built under
    "auto" (each carrying both banks; the train CLI's 8192-token loader,
    then TOKEN_BUDGETS' others to spread P/P_loc), one batch per distinct
    (B, N, P, P_loc). For each, on c2 models made from seed 0 (bf16, full
    width): the captured Trainer.train_step under "pallas_local" and under
    "pallas" (CUDA events around each replay, from memory), the serving
    copy's encode captured as a CUDA graph under each, and P/P_loc; the
    smallest measured P/P_loc from which on every batch's local step is
    no slower than its global one, for training and for serving.

Prints the card's name and power limit first, then one JSON object last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SWEEP_HEADS, SWEEP_HEAD_DIM = 8, 64
SWEEP_N = (16, 32, 64, 128)
SWEEP_P = (128, 256, 512, 1024, 2048, 4096, 8192)
# batch_size_tokens of the crossover's loaders: the c2 config's own first
TOKEN_BUDGETS = (8192, 2048, 32768)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------- (a) B3' vs B3


def largest_batches():
    """{N: the instances of the largest batch the c2 train loader (under
    "pallas", epoch 1) makes at node bucket N}."""
    from gtos_tpu_torch import bench

    ld = bench.loader("c2", "pallas", True)
    ld.epoch = 0
    out = {}
    for batch, insts in ld.iter_with_instances():
        N = batch.concept_mask.shape[1]
        if N in SWEEP_N and len(insts) > len(out.get(N, ())):
            out[N] = insts
    return out


def index_arrays(insts, N, P):
    """(rel_index [B, N, N] int32, node mask [B, N], rows the paths need,
    folded) of the instances batchified at node bucket N and bank P."""
    from gtos_tpu_torch import bench
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.batching import BatchCapacityError

    vocabs = bench.corpus("c2")[1]
    B = 1
    while B < len(insts):
        B *= 2
    try:
        batch = batchify(insts, *vocabs, batch_size_bucket=B,
                         for_train=False, spec=BucketSpec(nodes=(N,),
                                                          bank=(P,)))
        folded = False
    except BatchCapacityError:
        batch = batchify(insts, *vocabs, batch_size_bucket=B,
                         for_train=False, spec=BucketSpec(nodes=(N,),
                                                          bank=(1 << 20,)))
        folded = True
    idx = batch.rel_index
    rows = int(idx.max()) + 1
    return idx % P, batch.concept_mask, rows, folded


def sweep_inputs(idx, mask, P, dtype, seed=0):
    """q, k, v [B, H, N, Dh], the joint bank ab [P, 2 H Dh] and the index
    arrays on the card."""
    import torch

    B, N = mask.shape
    H, Dh = SWEEP_HEADS, SWEEP_HEAD_DIM
    g = torch.Generator().manual_seed(seed)
    dev = lambda x: x.to(device="cuda", dtype=dtype).contiguous()  # noqa
    q, k, v = (dev(torch.randn(B, H, N, Dh, generator=g)) for _ in range(3))
    ab = dev(torch.randn(P, 2 * H * Dh, generator=g) * 0.5)
    return (q, k, v, ab, torch.from_numpy(idx).int().cuda(),
            torch.from_numpy(mask).cuda())


def timed(fn, iters, device_iters):
    """Event ms (median, min, max of cold calls) and device ms (median)."""
    from gtos_tpu_torch.utils import benchlib

    ev = benchlib.time_samples(fn, iters=iters, cold=True)
    dv = benchlib.device_ms(fn, device_iters)
    return dict(ms=ev["median"] * 1e3, ms_min=ev["min"] * 1e3,
                ms_max=ev["max"] * 1e3, device_ms=dv["median"],
                device_ms_min=dv["min"], device_ms_max=dv["max"])


def forward_point(q, k, v, ab, idx, mask, iters, device_iters):
    """B3' against build_tables + B3 on one input: their times and the
    largest gap between their outputs relative to the largest value."""
    from gtos_tpu_torch.ops import relation_attention as ra
    from gtos_tpu_torch.ops.local_relation_attention import split_banks
    from gtos_tpu_torch.utils import benchlib

    a, b = split_banks(ab, SWEEP_HEADS)

    def inline():
        return ra.fused_relation_attention_inline(q, k, v, a, b, idx, mask)

    def tables():
        t2, t3 = ra.build_tables(q, k, a, b)
        return ra.fused_relation_attention(q, k, v, t2, t3, idx, mask)

    gap = benchlib.rel_to_largest([inline()], [tables()])
    return dict(gap=gap, inline=timed(inline, iters, device_iters),
                tables=timed(tables, iters, device_iters))


def train_point(q, k, v, ab, idx, mask, iters, device_iters):
    """relation_attention_trainable's forward and backward with each
    forward kernel forced (B3' or B3 on build_tables; the backward the
    same B4 and table contractions): their times and the largest gap
    between the two routes' gradients."""
    import torch

    from gtos_tpu_torch.ops import relation_attention as ra
    from gtos_tpu_torch.ops.local_relation_attention import split_banks
    from gtos_tpu_torch.utils import benchlib

    leaves = [t.detach().requires_grad_() for t in (q, k, v, ab)]
    rows, cols = ra.walk_orders(idx)
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                      ).to(q)

    def step():
        a, b = split_banks(leaves[3], SWEEP_HEADS)
        out = ra.relation_attention_trainable(*leaves[:3], a, b, idx, mask,
                                              rows, cols)
        return torch.autograd.grad(out, leaves, cot)

    rule, out = ra._inline_fits, {}
    try:
        for name, pick in (("inline", True), ("tables", False)):
            ra._inline_fits = lambda q, a, pick=pick: pick
            out[name] = (step(), timed(step, iters, device_iters))
    finally:
        ra._inline_fits = rule
    gap = benchlib.rel_to_largest(out["inline"][0], out["tables"][0])
    return dict(gap=gap, inline=out["inline"][1], tables=out["tables"][1])


def sweep(iters, device_iters):
    """Table (a): a row per (dtype, N, P)."""
    import torch

    from gtos_tpu_torch.ops import relation_attention as ra
    from gtos_tpu_torch.ops.local_relation_attention import split_banks
    from gtos_tpu_torch.utils.benchlib import KERNEL_TOL

    rows = []
    for N, insts in sorted(largest_batches().items()):
        for P in SWEEP_P:
            idx, mask, need, folded = index_arrays(insts, N, P)
            for dtype in (torch.bfloat16, torch.float32):
                args = sweep_inputs(idx, mask, P, dtype)
                q, a = args[0], split_banks(args[3], SWEEP_HEADS)[0]
                name = str(dtype).replace("torch.", "")
                row = dict(dtype=name, B=int(mask.shape[0]), N=N, P=P,
                           rows_needed=need, folded=folded,
                           rule_picks="B3'" if ra._inline_fits(q, a)
                           else "B3",
                           forward=forward_point(*args, iters,
                                                 device_iters),
                           train=train_point(*args, iters, device_iters))
                for part in ("forward", "train"):
                    r = row[part]
                    if r["gap"] > KERNEL_TOL[name]["rtol"]:
                        raise SystemExit(
                            f"(a) {name} N={N} P={P} {part}: the two routes "
                            f"differ by {r['gap']:.3e} of the largest value")
                    r["faster"] = ("B3'" if r["inline"]["device_ms"]
                                   <= r["tables"]["device_ms"] else "B3")
                rows.append(row)
                f, t = row["forward"], row["train"]
                print(f"[sweep] {name} B={row['B']} N={N} P={P}"
                      f"{' folded' if folded else ''}: forward B3' "
                      f"{f['inline']['device_ms']:.6f} / tables+B3 "
                      f"{f['tables']['device_ms']:.6f} device ms (events "
                      f"{f['inline']['ms']:.6f} / {f['tables']['ms']:.6f});"
                      f" train {t['inline']['device_ms']:.6f} / "
                      f"{t['tables']['device_ms']:.6f}; the rule picks "
                      f"{row['rule_picks']}", flush=True)
                del args
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------- (b) local/global crossover


def crossover_batches(max_batches):
    """The c2 corpus's "auto" batches carrying both banks, one per
    distinct (B, N, P, P_loc), in TOKEN_BUDGETS' order, with the budget
    that made each."""
    from gtos_tpu_torch import bench
    from gtos_tpu_torch.data import BucketSpec, DataLoader
    from gtos_tpu_torch.train.train import loader_flags

    cfg, tcfg = bench.configs("c2", "auto")
    instances, vocabs = bench.corpus("c2")
    seen, out = set(), []
    for tokens in TOKEN_BUDGETS:
        ld = DataLoader(instances, *vocabs, batch_size_tokens=tokens,
                        spec=BucketSpec().for_model_max_oov(cfg.max_oov),
                        for_train=True, seed=tcfg.seed,
                        **loader_flags("auto"))
        ld.epoch = 0
        for batch in ld:
            if batch.bank_map is None:
                continue
            B, N = batch.concept_mask.shape
            key = (B, N, batch.rel_bank.shape[0], batch.bank_map.shape[1])
            if key not in seen and len(out) < max_batches:
                seen.add(key)
                out.append((tokens, batch))
    return out


def encode_run(served, arrays, impl):
    """The serving copy's encode of `arrays` under `impl` as a CUDA graph:
    a function whose first call captures and later calls replay."""
    import torch

    from gtos_tpu_torch.models.generator import batch_edges
    from gtos_tpu_torch.utils import graphs

    cache = graphs.Graphs(served.device, True)
    static = cache.inputs(impl, arrays)

    def encode():
        return served.encode(static["concept"], static["concept_char"],
                             static["concept_mask"], static["rel_bank"],
                             static["rel_length"], static["rel_index"],
                             edges=batch_edges(static), impl=impl)

    def run():
        with torch.inference_mode():
            return cache.run(impl, encode)
    return run


def crossover_from(rows, key):
    """The smallest measured P/P_loc from which on every batch's local
    time (`key`) is no larger than its global one; None if none is."""
    best = None
    for r in sorted(rows, key=lambda r: -r["ratio"]):
        if r[key]["pallas_local"]["median"] > r[key]["pallas"]["median"]:
            break
        best = r["ratio"]
    return best


def crossover(steps, max_batches):
    """Table (b): a row per batch, and the two crossovers."""
    import torch

    from gtos_tpu_torch import bench
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.ops import relation_attention as ra
    from gtos_tpu_torch.train.trainer import Trainer, check_metrics
    from gtos_tpu_torch.utils import benchlib

    def ms(samples):
        return {k: (v * 1e3 if k != "n" else v) for k, v in
                benchlib.summarize(samples).items()}

    batches = crossover_batches(max_batches)
    cfg, tcfg = bench.configs("c2", "auto")
    tcfg = dataclasses.replace(tcfg, checkpoint_every=10 ** 9)
    seed = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    trainers = {}
    for impl in ("pallas_local", "pallas"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        trainers[impl] = Trainer(Generator(c, device="cuda", rng=seed()), c,
                                 tcfg, batches[0][1].arrays(),
                                 device="cuda")
    served = Generator(cfg, device="cuda", rng=seed()).serving_copy()
    H, Dh = cfg.heads, cfg.d_model // cfg.heads
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    rows = []
    for tokens, batch in batches:
        B, N = batch.concept_mask.shape
        P, P_loc = batch.rel_bank.shape[0], batch.bank_map.shape[1]
        q = torch.empty(B, H, N, Dh, dtype=dt, device="meta")
        a = torch.empty(P, H, Dh, dtype=dt, device="meta")
        row = dict(tokens=tokens, B=int(B), N=int(N), P=int(P),
                   P_loc=int(P_loc), ratio=P / P_loc,
                   pallas_forward="B3'" if ra._inline_fits(q, a) else "B3",
                   train={}, encode={})
        arrays = batch.arrays()
        on_card = batch_to_device(arrays, "cuda")
        for impl, trainer in trainers.items():
            got = benchlib.time_samples(
                lambda: trainer.train_step(on_card), iters=steps, warmup=2)
            metrics = trainer.train_step(on_card)
            check_metrics(metrics)
            if not torch.isfinite(metrics["loss"]):
                raise SystemExit(f"(b) {impl}: non-finite loss on {row}")
            row["train"][impl] = ms(got["samples"])
            trainer._step.graphs.clear()
        served_arrays = batch_to_device(arrays, "cuda", train=False)
        for impl in trainers:
            got = benchlib.time_samples(
                encode_run(served, served_arrays, impl), iters=steps,
                warmup=2)
            row["encode"][impl] = ms(got["samples"])
        rows.append(row)
        torch.cuda.empty_cache()
        print(f"[crossover] tokens={tokens} B={B} N={N} P={P} P_loc={P_loc}"
              f" ratio {row['ratio']:.3f}: train pallas_local "
              f"{row['train']['pallas_local']['median']:.3f} / pallas "
              f"{row['train']['pallas']['median']:.3f} ms "
              f"({row['pallas_forward']}); encode {row['encode']['pallas_local']['median']:.3f} / "
              f"{row['encode']['pallas']['median']:.3f} ms", flush=True)
    return dict(rows=rows, train_crossover=crossover_from(rows, "train"),
                serve_crossover=crossover_from(rows, "encode"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30,
                    help="cold calls timed with events a point, (a)")
    ap.add_argument("--device-iters", type=int, default=10,
                    help="calls the profiler keeps a point, (a)")
    ap.add_argument("--steps", type=int, default=10,
                    help="replays timed a batch and route, (b)")
    ap.add_argument("--max-batches", type=int, default=48)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("this script needs a card")
    sys.path.insert(0, str(ROOT))
    from gtos_tpu_torch.utils import benchlib

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}", flush=True)
    benchlib.build_all()
    result = dict(card=card, sweep=sweep(args.iters, args.device_iters))
    result["crossover"] = crossover(args.steps, args.max_batches)
    print(f"[crossover] training from P/P_loc "
          f"{result['crossover']['train_crossover']}, serving from "
          f"{result['crossover']['serve_crossover']}", flush=True)
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()
