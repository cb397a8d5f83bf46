#!/usr/bin/env python3
"""Measures the block-sparse backward plan at its two choices of pair
capacity E_cap on one NVIDIA GPU: the batch's class (ops/block_sparse_
attention_bwd.py pair_capacity: the power of two at or above the tile
layout's kept entries, which the batch signature holds) against the tile
layout's own size (which adds no signature but is 20-50x the kept pairs
of the c5 model's batches), the rejected choice, given to a batch through
the same carrier (a PAIR_CAP array of that size), as a record of why.

    python3 chip_plan_capacity.py [--batches N]

From the repo root, on a machine with a card. On the c5 bench cell's
train batches (gtos_tpu_torch/bench.py: the first N of epoch 1 of the c5
loader, default 6):

  * the plan alone at each capacity on each batch: its device ms
    (benchlib.device_ms, the L2 flushed before each call), E and E_cap;
  * a c5 Trainer (configs/c5_scaled_synthetic.json, bf16, full widths,
    random weights from seed 0, one card) over the batches twice on CUDA
    graphs at each capacity, under benchlib.deterministic_algorithms: the
    graph pool's MiB, each capture's host ms, the second pass's ms a step
    (replays, from memory) and whether both capacities give the same
    losses;
  * the c5 loader's signatures an epoch with and without the class.

Prints the card's name and power limit, then one JSON object last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def at_capacity(choice, batch):
    """The batch's arrays on the card with the pair capacity `choice`:
    "class" (with_pair_cap's) or "layout" (the tile layout's size)."""
    import numpy as np

    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import PAIR_CAP

    a = batch.arrays()
    if choice == "layout":
        a[PAIR_CAP] = np.zeros((0, a["tile_rel"].size), np.int32)
    return batch_to_device(a, "cuda")


def plan_args(a):
    return (a["tile_src"], a["tile_rel"], a["tile_dst"], a["tile_rel_src"],
            a["concept"].shape[1], a["rel_bank"].shape[0])


def plan_ms(batches):
    """Per batch: E, both capacities and the plan's device ms at each."""
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
        backward_plan, pair_cap)
    from gtos_tpu_torch.utils import benchlib

    rows = []
    for b in batches:
        caps = {c: pair_cap(at_capacity(c, b)) for c in ("class", "layout")}
        a = at_capacity("class", b)
        row = dict(E=int(backward_plan(*plan_args(a), caps["class"])["E"]),
                   cap=caps)
        for name, cap in caps.items():
            row[f"{name}_ms"] = benchlib.device_ms(
                lambda: backward_plan(*plan_args(a), cap), 10)["median"]
        rows.append(row)
        print(f"[plan] {row}", flush=True)
    return rows


def train_at(choice, cfg, tcfg, batches):
    """Two passes of Trainer.train_step over the batches on CUDA graphs
    with the pair capacity `choice`: pool MiB, capture ms, the second
    pass's ms a step, the losses."""
    import torch

    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.trainer import Trainer

    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, tcfg, batches[0].arrays(), device="cuda")
    on_card = [at_capacity(choice, b) for b in batches]
    losses = [trainer.train_step(a)["loss"] for a in on_card]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [trainer.train_step(a)["loss"] for a in on_card]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(on_card)
    graphs = trainer._step.graphs
    out = dict(pool_mib=graphs.pool_bytes() / 2 ** 20,
               capture_ms=sorted(graphs.capture_ms().values()),
               graphs=graphs.captures, replays=graphs.replays,
               ms_per_step_replayed=ms,
               losses=torch.stack(losses).float().tolist())
    graphs.clear()
    del trainer, model, on_card
    torch.cuda.empty_cache()
    print(f"[train] {choice}: " + json.dumps(
        {k: v for k, v in out.items() if k != "losses"}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=6)
    args = ap.parse_args(argv)
    # before cuBLAS's first call: deterministic_algorithms relies on it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch
    if not torch.cuda.is_available():
        sys.exit("this script needs a card")
    sys.path.insert(0, str(ROOT))
    from gtos_tpu_torch import bench
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import with_pair_cap
    from gtos_tpu_torch.utils import benchlib
    from gtos_tpu_torch.utils.graphs import signature

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}", flush=True)
    cfg, tcfg = bench.configs("c5", "block_sparse")
    tcfg = dataclasses.replace(tcfg, checkpoint_every=10 ** 9)
    ld = bench.loader("c5", "block_sparse", True)
    ld.epoch = 0
    epoch = list(ld)
    batches = epoch[:args.batches]
    result = dict(card=card, plan=plan_ms(batches))
    result["signatures_an_epoch"] = {
        "layout": len({signature(b.arrays()) for b in epoch}),
        "class": len({signature(with_pair_cap(b.arrays())) for b in epoch})}
    with benchlib.deterministic_algorithms():
        result["train"] = {c: train_at(c, cfg, tcfg, batches)
                           for c in ("class", "layout")}
    result["same_losses"] = (result["train"]["class"]["losses"]
                             == result["train"]["layout"]["losses"])
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
