"""Training CLI — port of gtos_tpu/train/train.py, the same flags and
`--config` handling, plus `--device`:

  # the c2 AMR model on synthetic data, on the CUDA card
  python -m gtos_tpu_torch.train.train --config configs/c2_amr2.json \\
      --synthetic 256 --ckpt_dir ckpt

  # a small run on the CPU
  python -m gtos_tpu_torch.train.train --synthetic 64 --device cpu \\
      --d_model 32 --d_ff 64 --heads 2 --enc_layers 2 --dec_layers 1 \\
      --total_steps 4 --ckpt_dir ckpt

  # the c5 model (block-sparse attention over 4-hop pairs) on one card
  python -m gtos_tpu_torch.train.train \
      --config configs/c5_scaled_synthetic.json --attention_impl block_sparse \
      --graph 1 --dp 0 --synthetic 256 --ckpt_dir ckpt

  # its config as written: 4-way data parallel x 2-way context parallel,
  # one rank per card (8 cards)
  python -m gtos_tpu_torch.train.train \
      --config configs/c5_scaled_synthetic.json --synthetic 256 --ckpt_dir ckpt

  # 2 data-parallel ranks on the CPU (gloo)
  python -m gtos_tpu_torch.train.train --synthetic 64 --device cpu \
      --d_model 32 --d_ff 64 --heads 2 --enc_layers 2 --dec_layers 1 \
      --total_steps 4 --dp 2 --ckpt_dir ckpt

  # an AMR sembank (PENMAN, `# ::snt` or `# ::tok` targets)
  python -m gtos_tpu_torch.train.train --config configs/c2_amr2.json \\
      --train_data train.amr --dev_data dev.amr --ckpt_dir ckpt

  # the c4 translator: CoNLL dependency parses and target sentences (one
  # line each), batches built by 4 worker processes
  python -m gtos_tpu_torch.train.train --config configs/c4_nmt_ende.json \\
      --train_data train.conll --train_target train.tgt \\
      --dev_data dev.conll --dev_target dev.tgt --batchify_workers 4 \\
      --ckpt_dir ckpt

--attention_impl takes "xla", "pallas" (the global-bank kernels B3/B3'
and B4), "pallas_local" (B1p/B2), "sparse" (the edge-list attention,
plain torch), "block_sparse" (the tile kernels B5s and B6) and "auto" (per
batch, "pallas_local" or "pallas", and "block_sparse" for a batch whose
paths overflow the local-bank ladder); --sparse_khop k keeps, for the
sparse impls, only the pairs within k hops. Training runs on the CUDA card
unless `--device cpu` is given, and raises without a card. The configs and
vocabs go into the checkpoint directory (the args-in-checkpoint contract),
so inference rebuilds the model from it alone (`python -m
gtos_tpu_torch.infer.work`).

--dp/--mp/--graph build a (data, model, graph) mesh of dp*mp*graph ranks
(parallel/mesh.py; --dp 0 and the others 1: no mesh). The CLI starts the
ranks itself, one process per card (or per CPU rank under --device cpu):
all of them here, or with --num_hosts N --host_id h --coordinator
HOST:PORT this host's share, ranks h*R..h*R+R-1 of R = world/N. They
rendezvous on the coordinator, else on a file in a temporary directory
under TMPDIR. A world
larger than the cards visible raises. A rank reads its data rank's rows
(the loader's host_rank/host_count, batch_multiple = dp), --graph > 1
needs "sparse" or "block_sparse" (with --cp_schedule ring or a2a for
"sparse"; "block_sparse" runs the ring on one node bucket of graph*128
nodes), and dev BLEU sums its statistics over the data ranks. Rank 0
writes the metrics, vocabs and checkpoints; --resume has rank 0 read
the latest checkpoint and send it to every rank.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

# torch and the model are imported where they are used: the DataLoader's
# worker processes import this module (the main module of a `-m` run) and
# need only the data layer, which imports no torch
from gtos_tpu_torch.graph.paths import RelationPathConfig

IMPLS = ["xla", "pallas", "pallas_interpret", "pallas_local",
         "pallas_local_interpret", "sparse", "block_sparse",
         "block_sparse_interpret", "auto", "auto_interpret"]


def parse_args(argv=None):
    # --config FILE loads experiment defaults (configs/*.json); explicit CLI
    # flags override the file
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config")
    pre_args, _ = pre.parse_known_args(argv)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", help="JSON experiment config (configs/*.json)")
    p.add_argument("--task", choices=["amr", "nmt"], default="amr")
    p.add_argument("--train_data",
                   help="sembank file (amr) or CoNLL file (nmt)")
    p.add_argument("--train_target", help="target sentences (nmt)")
    p.add_argument("--dev_data")
    p.add_argument("--dev_target")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic instances instead of files")
    p.add_argument("--ckpt_dir")
    p.add_argument("--device", default=None,
                   help="'cpu' to train on the CPU (default: the CUDA card)")
    # model
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--d_ff", type=int, default=1024)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--enc_layers", type=int, default=4)
    p.add_argument("--dec_layers", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--max_path_len", type=int, default=8)
    p.add_argument("--max_target_len", type=int, default=128)
    p.add_argument("--max_oov", type=int, default=64,
                   help="copyable OOVs per instance (extended vocab = "
                        "token vocab + this; also caps batchify's OOV list)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--copy_impl", default="onehot",
                   choices=["onehot", "scatter"],
                   help="kept for the config's sake: the port computes "
                        "both values with one f32 scatter-add")
    p.add_argument("--attention_impl", default="xla", choices=IMPLS)
    p.add_argument("--sparse_khop", type=int, default=0)
    p.add_argument("--cp_schedule", default="ring", choices=["ring", "a2a"])
    # optimization
    p.add_argument("--total_steps", type=int, default=100000)
    p.add_argument("--warmup_steps", type=int, default=4000)
    p.add_argument("--lr_scale", type=float, default=1.0)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--batch_size_tokens", type=int, default=4096)
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=19940117)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --ckpt_dir")
    p.add_argument("--profile", metavar="LOGDIR",
                   help="write a torch.profiler trace of the run to "
                        "LOGDIR/trace.json")
    # parallelism
    p.add_argument("--dp", type=int, default=0)
    p.add_argument("--mp", type=int, default=1)
    p.add_argument("--graph", type=int, default=1)
    p.add_argument("--coordinator")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=0)
    # evaluation
    p.add_argument("--eval_bleu", action="store_true",
                   help="decode the dev set at every eval interval and log "
                        "dev BLEU (utils/bleu.py, sacrebleu's defaults)")
    p.add_argument("--eval_bleu_max", type=int, default=200,
                   help="cap on dev instances decoded for dev BLEU")
    p.add_argument("--eval_bleu_beam", type=int, default=1,
                   help="beam size for the dev-BLEU decode (1 = greedy)")
    p.add_argument("--eval_bleu_alpha", type=float, default=0.0,
                   help="length-penalty alpha for the dev-BLEU decode")
    # input pipeline / dispatch overlap
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches packed and copied to the device ahead in a "
                        "background thread (0 = synchronous)")
    p.add_argument("--max_inflight", type=int, default=2,
                   help="queued steps before the host reads a loss back "
                        "(0 = wait for every step)")
    p.add_argument("--batchify_workers", type=int, default=0)
    p.add_argument("--batchify_worker_mode", default="process",
                   choices=["process", "thread"])

    if pre_args.config:
        with open(pre_args.config) as f:
            conf = {k: v for k, v in json.load(f).items()
                    if not k.startswith("_")}
        unknown = set(conf) - {a.dest for a in p._actions}
        if unknown:
            raise SystemExit(f"unknown keys in {pre_args.config}: {unknown}")
        p.set_defaults(**conf)

    args = p.parse_args(argv)
    if not args.ckpt_dir:
        raise SystemExit("--ckpt_dir is required")
    return args


def check_ported(args):
    """Refuse option combinations the JAX package's CLI refuses, and an
    attention impl the port does not have."""
    from gtos_tpu_torch.models.graph_transformer import check_impl

    sparse = args.attention_impl.startswith(("sparse", "block_sparse"))
    if args.graph > 1 and not sparse:
        raise SystemExit(
            "--graph context parallelism requires an edge-partitioned impl: "
            "--attention_impl sparse or block_sparse")
    if args.sparse_khop > 0 and not sparse:
        raise SystemExit(
            "--sparse_khop prunes pairs only the sparse impls mask out; a "
            "dense impl would attend to pruned pairs with the "
            "unreachable-path embedding")
    if args.cp_schedule == "a2a" and args.attention_impl.startswith(
            "block_sparse"):
        raise SystemExit(
            "--cp_schedule a2a is implemented for --attention_impl sparse "
            "only; block_sparse runs the ring schedule")
    check_impl(args.attention_impl)


def mesh_world(args) -> int:
    """Ranks of the run's mesh; 0 without one (--dp 0, --mp 1, --graph
    1)."""
    if not (args.dp or args.mp > 1 or args.graph > 1):
        return 0
    return max(args.dp, 1) * args.mp * args.graph


def load_corpus(task: str, data_path: str,
                target_path: Optional[str] = None
                ) -> Tuple[list, List[List[str]]]:
    """(graphs, targets), as the JAX package's CLI reads them. amr: the
    sembank's graphs whose metadata carries `::tok` (else `::snt`), with
    that sentence split on spaces. nmt: the CoNLL file's dependency trees
    and the target file's lines, split on whitespace, one per tree; a
    count that differs raises."""
    if task == "amr":
        from gtos_tpu_torch.graph.amr import read_amr_file
        graphs, targets = [], []
        for g in read_amr_file(data_path):
            snt = (g.meta or {}).get("tok") or (g.meta or {}).get("snt")
            if snt is not None:
                graphs.append(g)
                targets.append(snt.split())
        return graphs, targets
    from gtos_tpu_torch.graph.dependency import read_conll_file
    if target_path is None:
        raise SystemExit(f"the nmt task needs a target file for {data_path}")
    graphs = read_conll_file(data_path)
    with open(target_path) as f:
        targets = [line.split() for line in f]
    if len(graphs) != len(targets):
        raise SystemExit(
            f"{data_path} holds {len(graphs)} sentences but {target_path} "
            f"{len(targets)} targets")
    return graphs, targets


def loader_flags(impl: str, sparse_khop: int = 0,
                 cp_shards: int = 1) -> dict:
    """The DataLoader's batchify flags for an attention impl, as the JAX
    package's CLIs set them: "auto" lets batchify pick per bucket (local
    banks, the tile layouts as the overflow fallback); "sparse" and
    "block_sparse" build the edge cells (and the latter the tiles), with
    the impl's sparse_khop and the mesh's node blocks (cp_shards); the
    others build what their kernel reads."""
    auto = impl.startswith("auto")
    sparse = impl == "sparse" or impl.startswith("block_sparse")
    return dict(build_edges=sparse, cp_shards=cp_shards,
                sparse_khop=sparse_khop,
                build_block_tiles="auto" if auto
                else impl.startswith("block_sparse"),
                build_local_banks="auto" if auto
                else impl.startswith("pallas_local"))


def load_synthetic(task: str, n: int):
    from gtos_tpu_torch.data.synthetic import (
        synthetic_amr_corpus, synthetic_dependency_corpus)
    fn = synthetic_amr_corpus if task == "amr" else synthetic_dependency_corpus
    return fn(n, seed=0)


def make_dev_bleu_fn(tv, cv, rv, chv, lm, dev_instances, dl_kw,
                     beam_size: int = 1, alpha: float = 0.0,
                     max_steps: int = 0, mesh=None):
    """model -> corpus BLEU of the decoded dev set (a capped slice): the
    training-time quality signal. The decode horizon follows the model's
    target length unless max_steps is given. Under a mesh each data rank
    decodes every dp-th instance and BLEU's sufficient statistics are
    summed over the data group, so every rank reports the whole set's
    BLEU (the JAX package's process_allgather)."""
    from gtos_tpu_torch.data.dataloader import DataLoader
    from gtos_tpu_torch.infer.decode import decode_batch
    from gtos_tpu_torch.utils.bleu import bleu_from_stats, bleu_stats

    if mesh is not None:
        dp = mesh.size("data")
        dev_instances = dev_instances[mesh.index("data")::dp]
    # every instance decoded once: no batch padded to the DP multiple
    dl = DataLoader(dev_instances, tv, cv, rv, chv, lm,
                    batch_size_tokens=2048, for_train=False,
                    **{k: v for k, v in dl_kw.items()
                       if k not in ("batch_multiple", "host_rank",
                                    "host_count")})

    def dev_bleu(model) -> float:
        hyps: List[str] = []
        refs: List[str] = []
        for batch, group in dl.iter_with_instances():
            out = decode_batch(model, batch, tv, beam_size=beam_size,
                               max_steps=max_steps or model.cfg.max_target_len,
                               alpha=alpha)
            for hyp, inst in zip(out, group):
                hyps.append(" ".join(hyp))
                refs.append(" ".join(inst.target))
        stats = bleu_stats(hyps, refs)
        if mesh is not None:
            import torch
            t = torch.tensor(stats, dtype=torch.int64, device=mesh.device)
            torch.distributed.all_reduce(t, group=mesh.group("data"))
            stats = t.tolist()
        return bleu_from_stats(stats)

    return dev_bleu


def main(argv=None):
    """Train; with a mesh (mesh_world > 0) start this host's ranks and
    return rank 0's result."""
    args = parse_args(argv)
    check_ported(args)
    world = mesh_world(args)
    if world == 0:
        return run(args)
    import tempfile

    import torch

    if world % args.num_hosts:
        raise SystemExit(f"a mesh of {world} ranks does not divide over "
                         f"{args.num_hosts} hosts")
    local = world // args.num_hosts
    if args.device != "cpu":
        from gtos_tpu_torch.utils.device import resolve_device
        resolve_device(args.device)
        cards = torch.cuda.device_count()
        if cards < local:
            raise RuntimeError(
                f"the mesh --dp {args.dp} --mp {args.mp} --graph "
                f"{args.graph} needs {local} ranks on this host, one per "
                f"card, and {cards} card(s) are visible")
    if args.num_hosts > 1 and not args.coordinator:
        raise SystemExit("--num_hosts > 1 needs --coordinator HOST:PORT")
    with tempfile.TemporaryDirectory() as tmp:
        init = (f"tcp://{args.coordinator}" if args.coordinator
                else f"file://{os.path.join(tmp, 'rendezvous')}")
        result = os.path.join(tmp, "result.json")
        if local == 1:
            _rank_main(0, args, init, world, result)
        else:
            import torch.multiprocessing as mp
            mp.start_processes(_rank_main, args=(args, init, world, result),
                               nprocs=local, start_method="spawn")
        if not os.path.exists(result):   # rank 0 lives on another host
            return {}
        with open(result) as f:
            return json.load(f)


def _rank_main(local_rank: int, args, init_method: str, world: int,
               result_path: str):
    """One rank of the mesh (a process of its own unless it is the host's
    only one): join the group, train, leave it."""
    import torch.distributed as dist

    from gtos_tpu_torch.parallel.mesh import init_distributed

    import torch

    local = world // args.num_hosts
    rank = args.host_id * local + local_rank
    device = "cpu" if args.device == "cpu" else f"cuda:{local_rank}"
    if device == "cpu" and local > 1:   # the host's cores, shared out
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    init_distributed(rank, world, init_method, device)
    try:
        last = run(args, device=device)
        if rank == 0:
            with open(result_path, "w") as f:
                json.dump(last, f)
    finally:
        dist.destroy_process_group()


def run(args, device=None):
    """The training run of one process: the whole run without a mesh, one
    rank's share with one (torch.distributed initialized)."""
    import dataclasses

    import torch

    from gtos_tpu_torch.data.batching import BucketSpec
    from gtos_tpu_torch.data.dataloader import DataLoader, preprocess
    from gtos_tpu_torch.data.extract import (
        build_vocabs, load_vocabs, save_vocabs)
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.checkpoint import CheckpointManager
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig
    from gtos_tpu_torch.utils.device import resolve_device
    from gtos_tpu_torch.utils.metrics import MetricsWriter

    device = resolve_device(device or args.device)
    mesh = None
    if mesh_world(args):
        from gtos_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp=args.dp or None, mp=args.mp, graph=args.graph,
                         device=device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    path_cfg = RelationPathConfig(max_path_len=args.max_path_len)
    if args.synthetic:
        graphs, targets = load_synthetic(args.task, args.synthetic)
        dev_graphs, dev_targets = load_synthetic(
            args.task, max(args.synthetic // 10, 4))
    else:
        if not args.train_data:
            raise SystemExit("--train_data or --synthetic required")
        graphs, targets = load_corpus(args.task, args.train_data,
                                      args.train_target)
        dev_graphs, dev_targets = (
            load_corpus(args.task, args.dev_data, args.dev_target)
            if args.dev_data else ([], []))

    vocab_dir = os.path.join(args.ckpt_dir, "vocabs")
    saved = os.path.exists(os.path.join(vocab_dir, "token_vocab.json"))
    if mesh is not None:   # every rank looked before rank 0 writes
        torch.distributed.barrier()
    if saved:
        tv, cv, rv, chv, lm = load_vocabs(vocab_dir)
    else:
        tv, cv, rv, chv, lm = build_vocabs(graphs, targets, path_cfg=path_cfg)
        if lead:
            save_vocabs(vocab_dir, tv, cv, rv, chv, lm)

    model_cfg = ModelConfig(
        token_vocab=len(tv), concept_vocab=len(cv), relation_vocab=len(rv),
        char_vocab=len(chv), d_model=args.d_model, d_ff=args.d_ff,
        heads=args.heads, enc_layers=args.enc_layers,
        dec_layers=args.dec_layers, dropout=args.dropout,
        label_smoothing=args.label_smoothing, max_oov=args.max_oov,
        max_target_len=args.max_target_len,
        compute_dtype=args.compute_dtype,
        attention_impl=args.attention_impl, sparse_khop=args.sparse_khop,
        cp_schedule=args.cp_schedule, use_copy=(args.task == "amr"),
        copy_impl=args.copy_impl, use_node_positions=(args.task == "nmt"))
    train_cfg = TrainConfig(
        lr_scale=args.lr_scale, warmup_steps=args.warmup_steps,
        grad_clip=args.grad_clip, accum_steps=args.accum_steps,
        total_steps=args.total_steps, eval_every=args.eval_every,
        checkpoint_every=args.checkpoint_every,
        batch_size_tokens=args.batch_size_tokens, seed=args.seed,
        dp_size=args.dp)

    # spec.max_oov follows the model so extended target ids always fit
    spec = BucketSpec().for_model_max_oov(model_cfg.max_oov)
    if args.graph > 1 and args.attention_impl.startswith("block_sparse"):
        # every node block tile-aligned: one bucket of graph*128 nodes
        spec = dataclasses.replace(spec, nodes=(args.graph * 128,))
    dp = max(args.dp, 1)
    dl_kw = dict(spec=spec, batch_multiple=dp,
                 workers=args.batchify_workers,
                 worker_mode=args.batchify_worker_mode,
                 **loader_flags(args.attention_impl, args.sparse_khop,
                                args.graph))
    if mesh is not None and dp > 1:
        dl_kw.update(host_rank=mesh.index("data"), host_count=dp)
    instances = preprocess(graphs, targets, path_cfg)
    dev_instances = preprocess(dev_graphs, dev_targets, path_cfg)
    dl = DataLoader(instances, tv, cv, rv, chv, lm,
                    batch_size_tokens=args.batch_size_tokens, for_train=True,
                    seed=args.seed, **dl_kw)
    dev_dl = (DataLoader(dev_instances, tv, cv, rv, chv, lm,
                         batch_size_tokens=args.batch_size_tokens,
                         for_train=False, **dl_kw)
              if dev_instances else None)

    model = Generator(model_cfg, device=device,
                      rng=torch.Generator().manual_seed(args.seed),
                      cp_mesh=mesh if args.graph > 1 else None)
    first = next(iter(dl))
    metrics = MetricsWriter(os.path.join(args.ckpt_dir, "metrics.jsonl"),
                            enabled=lead)
    ckpt = CheckpointManager(args.ckpt_dir, model_cfg, train_cfg,
                             write_configs=lead)
    dev_bleu_fn = None
    if args.eval_bleu and dev_instances:
        dev_bleu_fn = make_dev_bleu_fn(
            tv, cv, rv, chv, lm, dev_instances[: args.eval_bleu_max], dl_kw,
            beam_size=args.eval_bleu_beam, alpha=args.eval_bleu_alpha,
            mesh=mesh)
    trainer = Trainer(model, model_cfg, train_cfg, first.arrays(),
                      metrics_writer=metrics, checkpoint_manager=ckpt,
                      mesh=mesh, dev_bleu_fn=dev_bleu_fn,
                      prefetch=args.prefetch, max_inflight=args.max_inflight,
                      device=device)
    if mesh is not None and lead:
        world = torch.distributed.get_world_size()
        print(f"[mesh] {mesh.shape}: world {world}, backend {mesh.backend}, "
              f"step {trainer.step_path(first.arrays())}", file=sys.stderr,
              flush=True)
    if args.resume:
        step = trainer.restore_if_available()
        print(f"resumed at step {step}", file=sys.stderr)
    try:
        if args.profile:
            from gtos_tpu_torch.utils.profiling import trace
            with trace(args.profile):
                last = trainer.fit(dl, dev_dl)
        else:
            last = trainer.fit(dl, dev_dl)
    finally:
        for loader in (dl, dev_dl):
            if loader is not None:
                loader.close()
    metrics.close()
    if lead:
        print(f"done: {last}", file=sys.stderr)
    return last


if __name__ == "__main__":
    main()
