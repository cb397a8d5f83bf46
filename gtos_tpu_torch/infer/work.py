"""Inference CLI — port of gtos_tpu/infer/work.py: load a checkpoint (the
model config and vocabs ride in the checkpoint directory, so the exact
model is rebuilt from it alone), beam-search the test set batch by batch,
write one hypothesis per line in corpus order, optionally score BLEU and
chrF (utils/bleu.py, sacrebleu's defaults).

  python -m gtos_tpu_torch.infer.work --ckpt_dir ckpt --test_data test.amr \\
      --output out.txt --beam_size 8 --alpha 0.6 [--eval_bleu] [--eval_chrf]

  # the translator: CoNLL dependency parses, references one line each
  python -m gtos_tpu_torch.infer.work --ckpt_dir ckpt --task nmt \\
      --test_data test.conll --test_target test.tgt --output out.txt \\
      --eval_bleu

Decoding runs on the CUDA card unless `--device cpu` is given, and raises
without a card. attention_impl "auto" is resolved per batch (decode_batch).
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--task", choices=["amr", "nmt"], default="amr")
    p.add_argument("--test_data", required=True,
                   help="AMR sembank (references from ::tok or ::snt) or "
                        "CoNLL file (nmt)")
    p.add_argument("--test_target",
                   help="references, one line per sentence (nmt)")
    p.add_argument("--output", required=True)
    p.add_argument("--beam_size", type=int, default=8)
    p.add_argument("--alpha", type=float, default=0.6,
                   help="length penalty exponent")
    p.add_argument("--max_time_step", type=int, default=100)
    p.add_argument("--batch_size_tokens", type=int, default=4096)
    p.add_argument("--eval_bleu", action="store_true")
    p.add_argument("--eval_chrf", action="store_true")
    p.add_argument("--bpe_marker", default=None,
                   help="join BPE pieces with this marker (e.g. '@@')")
    p.add_argument("--detok", action="store_true",
                   help="rule-based detokenization of hypotheses")
    p.add_argument("--device", default=None,
                   help="'cpu' to decode on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the BLEU (or, with --eval_chrf alone, the chrF) score, None
    without either."""
    args = parse_args(argv)

    from gtos_tpu_torch.data.batching import BucketSpec
    from gtos_tpu_torch.data.dataloader import DataLoader, preprocess
    from gtos_tpu_torch.data.extract import load_vocabs
    from gtos_tpu_torch.data.postprocess import (
        join_bpe, postprocess_hypothesis,
    )
    from gtos_tpu_torch.infer.decode import decode_batch
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.checkpoint import CheckpointManager
    from gtos_tpu_torch.train.train import load_corpus, loader_flags
    from gtos_tpu_torch.utils.bleu import corpus_bleu, corpus_chrf
    from gtos_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model_cfg = CheckpointManager.load_model_config(args.ckpt_dir)
    tv, cv, rv, chv, lm = load_vocabs(os.path.join(args.ckpt_dir, "vocabs"))
    graphs, targets = load_corpus(args.task, args.test_data,
                                  args.test_target)
    dl = DataLoader(preprocess(graphs, targets), tv, cv, rv, chv, lm,
                    batch_size_tokens=args.batch_size_tokens,
                    for_train=False,
                    spec=BucketSpec().for_model_max_oov(model_cfg.max_oov),
                    **loader_flags(model_cfg.attention_impl,
                                   model_cfg.sparse_khop))

    # parameters only: the optimizer's moments stay on disk
    ckpt = CheckpointManager(args.ckpt_dir, model_cfg)
    params = ckpt.restore_params()
    if params is None:
        raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
    model = Generator(model_cfg, device=device)
    model.load_state_dict(params)
    print(f"restored step {ckpt.latest_step()}", file=sys.stderr)

    # decode in the loader's plan order (its bank-overflow bisect applies),
    # then restore corpus order for the output file
    results = []  # (orig_index, hypothesis line, reference line)
    for batch, group in dl.iter_with_instances():
        hyps = decode_batch(model, batch, tv, beam_size=args.beam_size,
                            max_steps=args.max_time_step, alpha=args.alpha)
        for hyp, inst in zip(hyps, group):
            entity_map = (inst.meta or {}).get("entities")
            line = postprocess_hypothesis(
                hyp, entity_map=entity_map, bpe_marker=args.bpe_marker,
                detok=args.detok)
            ref = inst.target
            if args.bpe_marker:
                ref = join_bpe(ref, args.bpe_marker)
            results.append((inst.orig_index, line, " ".join(ref)))

    results.sort(key=lambda r: r[0])
    lines = [r[1] for r in results]
    refs = [r[2] for r in results]
    with open(args.output, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} hypotheses to {args.output}", file=sys.stderr)

    score = None
    if args.eval_bleu:
        score = corpus_bleu(lines, refs)
        print(f"BLEU = {score:.2f}", file=sys.stderr)
    if args.eval_chrf:
        chrf = corpus_chrf(lines, refs)
        print(f"chrF = {chrf:.2f}", file=sys.stderr)
        if score is None:
            score = chrf
    return score


if __name__ == "__main__":
    main()
