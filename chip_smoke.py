#!/usr/bin/env python3
"""Drive the PyTorch port (gtos_tpu_torch) on one NVIDIA GPU, end to end:
serving and training of the configs/c2_amr2.json model at full width,
under each dense attention impl ("pallas_local", "pallas", "auto"), of
the configs/c4_nmt_ende.json translator at full width under
"pallas_local", and of the configs/c5_scaled_synthetic.json model at full
width under the block-sparse tier ("block_sparse", "sparse"); the train
and work CLIs on PENMAN and CoNLL files; the host pipeline.

    python3 chip_smoke.py            # from the repo root, on a machine with a card
    python3 chip_smoke.py --profile  # and where the serving and training time goes

Phases, each of which exits non-zero on failure:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — builds every CUDA kernel from gtos_tpu_torch/ops/csrc (one
               nvcc per source, all started together; sm_90a) and the
               native path extractor (gtos_tpu_torch/native/paths.cpp,
               g++; it must build), and prints the build times, registers
               and spills;
  3. kernels — holds each kernel against its plain torch version on real
               batchify index arrays, bf16 and f32, and times both (CUDA
               events, L2 flushed before every launch) beside the bound:
               B1 (forward), B1p (forward with the f32 probabilities) and
               B2 (backward, the same bits twice) of the localized
               attention at N=32 and N=128, the banks the two halves of one
               [B, P_loc, 2 H Dh] projection as the encoder layer hands
               them;
               B3 (global-bank forward from tables), B3' (from the banks,
               the halves of one [P, 2 H Dh] projection) and B4 (its
               backward) at N=32 (B=16) and N=128 (B=8), P=2048 and 4096,
               each output also within KERNEL_TOL's rtol of its largest
               value (B4: the same bits twice), with B3 and B3' timed on
               the same inputs beside the forward the card's rule
               (`_inline_fits`) picks, then their edge cases GLOBAL_EDGES; B5
               (block-sparse forward), B5s (with the softmax statistics),
               B6d, B6s and B6b (its backward: dst pass, src pass, bank
               gradients) at c5 widths on batchify tile layouts of N=256
               (B=4) and N=512 (B=2) at khop 4 and N=128 (B=8) at khop 0,
               with each layout's bank-row run lengths and B6b's library
               yardstick (its per-row sums as one torch.sparse.mm);
  4. serve   — builds the model with seeded random weights and serves the
               fullest batch of each of three node buckets with
               decode_batch (beam 8), counting the kernel launches of that
               run (B1 = enc_layers per batch, no other kernel); then holds
               the whole encoder (card, bf16, kernel) against the same
               weights on the CPU in f32 (plain version), in bf16 and in
               f32 on the card, and shows that two planted wrong versions
               of B1 fail both checks;
  5. train   — Trainer.fit of the same model on for_train=True DataLoader
               batches of the synthetic AMR 2.0-scale corpus for
               TRAIN_STEPS steps: step time, tokens/s and the loss every
               few steps, and the launches of that run (B1p = B2 =
               enc_layers per step, no other kernel); then an overfit of
               one fixed batch (dropout and label smoothing off, short
               warm-up), whose loss must fall below OVERFIT_RATIO of its
               first;
  6. grads   — the loss and every parameter gradient of one batch on the
               card with the kernels (f32 model, then bf16) against the
               same weights on the CPU in f32 with the plain versions; two
               planted wrong B2s must fail the check;
  7. resume  — a run cut at step RESUME_AT, saved, restored into a fresh
               model and trainer and continued, against the unbroken run:
               the same losses, bit for bit;
  8. localize — the localize gather's backward at the train batches'
               shapes: autograd of the plain gather against the port's
               (and the JAX package's) sorted prefix sum over
               loc_perm/loc_bnd, both timed;
  9. pallas  — phases 4-7 under attention_impl "pallas": serving (each
               batch's P and the forward the card's rule gives its bank,
               B3' at every shape the kernels take; B3' = enc_layers per
               batch), training on the loader's first PALLAS_STEPS
               batches, B3' = B4 = enc_layers per step; the gradient
               check with two planted wrong B4s; a bit-identical resume;
  10. auto   — training and serving under "auto" on batches of both
               routes (each printed with its P and P_loc): the auto
               loader's batches, which carry local banks and so all take
               the localized route (the card's AUTO_LOCAL_RATIO, 1), and
               the "pallas" loader's, which carry none and take the
               global one; the launches of each kernel, and for one batch
               of each route the loss under "auto" equal to the fixed
               route's to the last bit; then an
               N=128 batch whose paths overflow the local-bank ladder: it
               falls back to tiles, routes to "block_sparse" (B5s) and its
               loss equals the fixed route's to the last bit;
  11. work   — the train CLI (`--config configs/c2_amr2.json
               --attention_impl auto --synthetic N`) writes a checkpoint,
               and the work CLI decodes a PENMAN file written here from
               synthetic graphs: one hypothesis per graph in corpus order,
               BLEU and chrF; then the same with `--config
               configs/c5_scaled_synthetic.json --attention_impl
               block_sparse --graph 1 --dp 0`;
  12. c4     — the c4 translator at full width (bf16, dropout 0.2, label
               smoothing 0.1, no copy, node positions) on C4_GRAPHS
               synthetic dependency trees of 10-50 tokens: the train
               loader's batch shapes per node bucket (B, P, bank rows in
               use, P_loc after the bisect), then phases 4-7 for it
               (serving the fullest batch of each bucket 16/32/64 with B1 =
               enc_layers per batch; the encoder check with the planted
               B1s; TRAIN_STEPS steps with B1p = B2 = enc_layers per step;
               the gradient check with the planted B2s; a bit-identical
               resume) and B1, B1p, B2 on its own inputs (model "c4" in
               the JSON line);
  13. work nmt — the train CLI with `--config configs/c4_nmt_ende.json
               --task nmt` on a CoNLL file and its target file
               (`--train_data/--train_target`, `--dev_data/--dev_target`,
               `--batchify_workers 4`), then the work CLI with
               `--test_data/--test_target`: one hypothesis per sentence in
               file order, BLEU and chrF;
  14. host   — the card machine's host, with its CPU count: the native
               path extractor must build; preprocess ms per graph native
               against Python on the c2 and c4 corpora (the same
               PackedPaths); the train loaders' ms per batch at workers
               0/2/4 (processes) and 4 (threads), every array equal to
               workers=0's; 10 c2 training steps from a 4-worker loader
               with the same losses, bit for bit;
  15. batch_multiple — one c2 train batch of B=16 padded to 18: B1p and
               B2 launch on it, its loss equal to B=16's within 1e-6;
  16. c5     — the c5 model at full width (bf16, sparse_khop 4) on
               C5_GRAPHS synthetic graphs of 100-500 nodes: serving the
               fullest batch of each node bucket (128/256/512; B5 =
               enc_layers per batch, no other kernel), the encoder on the
               card against f32 on the CPU, C5_TRAIN_STEPS training steps
               (B5s = B6d = B6s = B6b = enc_layers per step), the loss and
               every gradient against f32 on the CPU with three planted
               wrong B6s (B6d, B6s, B6b) and a planted wrong B5s (no k.a
               term), "sparse" against "block_sparse"
               on one batch, and a bit-identical resume;
  17. shapes — each kernel again, on the very inputs the serving runs (B1;
               B3, B3'; B5) and the training runs (B1p, B2; B3, B3', B4;
               B5s, B6d, B6s, B6b) gave it (`utils/kernel_calls.py`
               `capture`, as the bench records them), against its plain
               version and timed per batch: the table rows (a planted B2 with g_a zeroed, a
               planted B4 with g_t3 zeroed and two planted B3s, one reading
               t3 at the query row and one without the t2 term, must fail
               the gate there); B3, which the card's rule routes no bank
               to, on the tables build_tables makes of the B3' inputs;
  18. bench  — the port's bench (`python -m gtos_tpu_torch.bench`) in
               this process on its north-star and kernels cells with two
               repeats: its last line parses, every timing in it is
               positive and finite, and no reading beats its bound; the
               table rows of c2, c4 and c5 take its kernel times (one
               time a row: the median of the kernels cell on layer 0 of
               the model's first batch, `bench_timed`);
  19. compiled — the compiled step and search (CUDA graphs per batch
               signature, utils/graphs.py; ROADMAP A11): c2 "pallas_local"
               training at full width with dropout 0.2, 5 batches twice,
               twice uncaptured and once on the graphs: the same
               losses, the dropout generator and Adam's count, and every
               parameter and moment as close as the uncaptured runs come
               (COMPILED_SPREAD, COMPILED_FLOOR; these comparisons and
               those of eval and serving under deterministic
               algorithms, whose graphs are then dropped); the same for c2
               "pallas" (B3' and B4), c2 "sparse" and "xla", c4
               and c5 "block_sparse" (its first 3 batches, the backward
               plan built inside the step), and each run's eval step
               captured against uncaptured; the resume of phase 7 (and
               of c4, "pallas" and c5) runs on the graphs and must
               replay; serving the fullest batch of every bucket of c2
               ("pallas_local", "sparse", "xla"), c4 and c5 captured and
               uncaptured: the same tokens, lengths and final t, scores
               as close as two uncaptured searches; the encoder and
               gradient gates of phases 4 and 6 on a captured encode and
               a captured forward and backward, the planted B1s and B2s
               failing there; B1, B1p and B2 (c2, c4), B3', B4 (c2),
               B5 (c5 serving) and B5s, B6d, B6s and B6b (a c5 train
               step) inside a replay against their plain versions
               (B6b's bank rows one by one), and B6b on two planted work
               lists (its last chunk left out; a padding place read as a
               real pair) failing there; printed: host launch calls, device kernels, busy ms
               and idle share of a captured train and decode step (c5's
               too), the graph pool and capture ms;
  20. mesh compiled — the mesh step captured (ROADMAP A11 item 2), in
               this process on a data-parallel mesh of one NCCL rank (its
               token-count, metric and gradient all-reduces on the card):
               the first 3 train batches of c2 "pallas_local" and
               "pallas", c4 and c5 "block_sparse", twice, the mesh Trainer
               captured against the same Trainer uncaptured under
               deterministic algorithms: every loss, parameter, moment,
               Adam's count and the dropout generator the same bits, and
               the mesh eval step the same bits; two planted faults in
               the dropout generator's registration (MESH_PLANTS) fail
               that or are refused at capture; for c2 and c5 a profile
               of replayed and of uncaptured mesh steps (host launch
               calls, device kernels, NCCL kernels, busy ms, idle share,
               pool, capture ms) and the step from memory captured and
               uncaptured, median [min-max] of 5 passes, beside the card
               line;
  21. profile — with --profile only: torch.profiler over each served batch
               ("pallas_local"), over one train step ("pallas_local" and
               "pallas") and over one c4 and one c5 train step on each
               captured batch ("pallas_local", "block_sparse"), the device busy time, idle share,
               top kernels and each block-sparse kernel's share; for
               "pallas_local" also the shares of B1p, B2 and of any copy
               of the bank halves a/b (and of their slice backward), for
               "pallas" those of B3' and B4.
Each group of phases prints its seconds ("[time]"), and "[done]" all of
them. The last three lines are the kernel table (JSON), the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# the bench's cells' corpora and configs: raw_corpus(family, seed, n),
# corpus(family) (preprocessed, with vocabularies) and configs(family,
# impl) for "c2", "c4" and "c5"
from gtos_tpu_torch.bench import (
    C5_GRAPHS, C5_NODES, C5_SPEC, configs, corpus, raw_corpus)
# one copy of the measurement code (SPIN_CYCLES: chip_b6_variants.py
# reads this tree's)
from gtos_tpu_torch.utils.benchlib import (
    BANK_ROW_TOL, KERNEL_TOL, LAUNCH_APIS, PROBS_TOL, SPIN_CYCLES,  # noqa
    b4_largest, b6b_library, bank_row_disagreement, block_bound, card_line,
    deterministic_algorithms,
    disagreement, global_attention_bound, honest_batch, local_attention_bound,
    local_attention_bwd_bound, rel_to_largest, time_ms)
from gtos_tpu_torch.utils.benchlib import dtype_name as _dtype_name
# one way to record the kernel calls of a step and to plant a kernel
from gtos_tpu_torch.utils import kernel_calls
from gtos_tpu_torch.utils.kernel_calls import capture, replaced

ROOT = os.path.dirname(os.path.abspath(__file__))
BEAM, MAX_STEPS, SERVE_BATCHES = 8, 64, 3
TRAIN_STEPS, LOG_EVERY = 20, 5
# "pallas" training: the loader's first batches (B3' and B4)
PALLAS_STEPS = 16
AUTO_STEPS_PER_ROUTE = 3
WORK_SYNTHETIC, WORK_STEPS, WORK_GRAPHS = 256, 4, 48
OVERFIT_STEPS, OVERFIT_RATIO = 100, 0.5  # last loss < 0.5 x the first
RESUME_AT, RESUME_MORE = 4, 4
CAPTURE_BATCHES = 3                      # train batches behind the B1p/B2 rows
# stated tolerances (reasons in PERF.md): kernel vs plain version on the
# same inputs (KERNEL_TOL, PROBS_TOL: utils/benchlib.py); whole encoder on
# the card vs f32 on the CPU, each set between the sound kernel's gap and
# that of the planted wrong kernels
ENCODER_TOL = {"bfloat16": dict(max_abs=0.058, mean_abs=0.0076),
               "float32": dict(max_abs=2e-5, mean_abs=3e-6)}
# whole-model gradients on the card vs f32 on the CPU: the largest
# relative L2 gap over the parameters with a gradient, and the loss gap
GRAD_TOL = {"float32": dict(rel=1e-2, loss=1e-4),
            "bfloat16": dict(rel=0.4, loss=1e-2)}
# the c4 translator (configs/c4_nmt_ende.json: no copy, node positions)
# on C4_GRAPHS synthetic dependency trees of C4_LENGTHS tokens, a
# translator's sentence lengths; served requests are another seed of the
# same corpus. The c5 model (configs/c5_scaled_synthetic.json) on
# C5_GRAPHS synthetic graphs of C5_NODES nodes: the node buckets
# 128/256/512 with C5_SPEC's widened bank and edge-cell ladders; the
# loader bisects a batch whose bank overflows 65536 rows
C5_TRAIN_STEPS = 6
C5_RESUME_AT, C5_RESUME_MORE = 6, 4   # the resumed steps cross an epoch
C5_ENCODER_TOL = ENCODER_TOL
# "sparse" (plain torch, gathers and scatter-adds) against "block_sparse"
# (B5s, B6) on the same f32 weights and batch: one function, sums in
# another order
SPARSE_TOL = dict(rel=1e-3, loss=1e-5)
# phase_compiled: a captured run's gap to an uncaptured one (each loss,
# and each parameter or moment element, relative to the largest loss or
# to its tensor's largest value) may be COMPILED_SPREAD times the largest
# gap between uncaptured runs, and at least COMPILED_FLOOR of the largest
# value, a few f32 roundings of it: 8 for a loss or a tensor, 64 for a
# search's score, a sum of up to MAX_STEPS per-step log-probabilities; a
# captured search's tokens, lengths and final t must be equal. The runs
# compared take deterministic algorithms (benchlib.
# deterministic_algorithms): the default ones sum the copy mass, the char
# CNN's and the embeddings' gradients and "sparse"'s messages in no fixed
# order, and Adam turns a last-bit change of a gradient near 0 into a
# step of the learning rate, a tail that a few runs do not sample
COMPILED_SPREAD = 4.0
COMPILED_FLOOR = dict(loss=2.0 ** -20, state=2.0 ** -20, score=2.0 ** -17)
# phase_bench: the bench's cells that chip_smoke runs, and their repeats
BENCH_CELLS, BENCH_REPEATS = ("north_star_local", "kernels"), 2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------- inputs


def kernel_inputs(batch, H, Dh, dtype, seed=0):
    """B1's arguments for a batch, seeded: the banks a_loc, b_loc are the
    two halves of one [B, P_loc, 2 H Dh] tensor, as the encoder layer hands
    them (split_banks: views, rows 2 H Dh apart)."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import split_banks

    B, N = batch.concept_mask.shape
    P_loc = batch.bank_map.shape[1]
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    q, k, v = rnd(B, H, N, Dh), rnd(B, H, N, Dh), rnd(B, H, N, Dh)
    ab = rnd(B, P_loc, 2 * H * Dh) * 0.5
    dev = lambda x: x.to(device="cuda", dtype=dtype).contiguous()  # noqa
    return (dev(q), dev(k), dev(v), *split_banks(dev(ab), H),
            torch.from_numpy(batch.rel_index_loc).cuda(),
            torch.from_numpy(batch.concept_mask).cuda())


# ---------------------------------------------------------------- phases


def phase_build():
    """Every kernel source, one nvcc each, and the native path extractor
    (g++), all started together (benchlib.build_all); the extractor must
    build."""
    from gtos_tpu_torch.utils.benchlib import build_all

    extractor, results, total = build_all()
    if isinstance(extractor, Exception):
        fail(f"the native path extractor did not build: {extractor}")
    seconds, built = extractor
    print(f"[build] native/paths.cpp (g++): {seconds:.2f} s"
          + ("" if built else " (library already built)"))
    for source, seconds, log in results:
        print(f"[build] {source}: {seconds:.2f} s"
              + ("" if log else " (library already built)"))
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
                print(f"[build]   entry {entry}")
            elif "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all sources: {total:.2f} s", flush=True)


def check_b1(label, args):
    """B1's wrapper against its plain version on the same inputs, then
    both timed on the card; prints one line and returns its numbers."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import (
        local_relation_attention as lra, local_relation_attention_reference)

    q, rel_index_loc = args[0], args[5]
    B, H, N, Dh = q.shape
    dtype_name = _dtype_name(q)
    out = lra(*args)
    ref = local_relation_attention_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"B1 {label} {dtype_name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    try:
        torch.testing.assert_close(out.float(), ref.float(),
                                   **KERNEL_TOL[dtype_name])
    except AssertionError as e:
        fail(f"B1 {label} {dtype_name} disagrees with its plain version: {e}")
    rel = rel_to_largest((out,), (ref,))
    if rel > KERNEL_TOL[dtype_name]["rtol"]:
        fail(f"B1 {label} {dtype_name}: error {rel:.3e} of the largest "
             f"value, above {KERNEL_TOL[dtype_name]['rtol']}")
    bound_ms, bound_by = local_attention_bound(
        rel_index_loc.cpu().numpy(), H, Dh, dtype_name)
    ms = time_ms(lambda: lra(*args), bound_ms=bound_ms)
    plain_ms = time_ms(lambda: local_relation_attention_reference(*args))
    print(f"[kernel] B1 {label} B={B} H={H} N={N} Dh={Dh} "
          f"P_loc={args[3].shape[1]} {dtype_name}: max_abs_err={err:.3e} "
          f"(tol {KERNEL_TOL[dtype_name]}; {rel:.3e} of the largest value) "
          f"bound={bound_ms:.6f} ms "
          f"({bound_by}) kernel={ms:.6f} ms plain={plain_ms:.6f} ms",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_b1p(label, args):
    """B1p's wrapper against its plain version on the same inputs (out and
    the f32 probabilities), then both timed; returns its numbers."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import (
        local_relation_attention_with_probs as lrap,
        local_relation_attention_with_probs_reference as plain)

    q, rel_index_loc = args[0], args[5]
    B, H, N, Dh = q.shape
    dtype_name = _dtype_name(q)
    out, probs = lrap(*args)
    ref_out, ref_probs = plain(*args)
    torch.cuda.synchronize()
    if not (torch.isfinite(out.float()).all() and torch.isfinite(probs).all()):
        fail(f"B1p {label} {dtype_name}: non-finite output")
    err = max((out.float() - ref_out.float()).abs().max().item(),
              (probs - ref_probs).abs().max().item())
    try:
        torch.testing.assert_close(out.float(), ref_out.float(),
                                   **KERNEL_TOL[dtype_name])
        torch.testing.assert_close(probs, ref_probs, **PROBS_TOL)
    except AssertionError as e:
        fail(f"B1p {label} {dtype_name} disagrees with its plain version: "
             f"{e}")
    rel = rel_to_largest((out,), (ref_out,))
    if rel > KERNEL_TOL[dtype_name]["rtol"]:
        fail(f"B1p {label} {dtype_name}: out's error {rel:.3e} of its "
             f"largest value, above {KERNEL_TOL[dtype_name]['rtol']}")
    bound_ms, bound_by = local_attention_bound(
        rel_index_loc.cpu().numpy(), H, Dh, dtype_name, with_probs=True)
    ms = time_ms(lambda: lrap(*args), bound_ms=bound_ms)
    plain_ms = time_ms(lambda: plain(*args))
    print(f"[kernel] B1p {label} B={B} H={H} N={N} Dh={Dh} "
          f"P_loc={args[3].shape[1]} {dtype_name}: max_abs_err={err:.3e} "
          f"(tol {KERNEL_TOL[dtype_name]}, probs {PROBS_TOL}; out "
          f"{rel:.3e} of its largest value) "
          f"bound={bound_ms:.6f} ms ({bound_by}) kernel={ms:.6f} ms "
          f"plain={plain_ms:.6f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def b2_args(args, seed=1):
    """B2's arguments for B1's inputs: the f32 probabilities from B1p, a
    seeded cotangent (values of the input type, held in f32, as a training
    step hands B2 the output's cotangent), the walk order and, last, the
    work list over the runs (B2's `runs` keyword)."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import (
        local_relation_attention_with_probs_reference, bank_runs,
        slot_order)

    q, k, v, a_loc, b_loc, idx, mask = args
    gen = torch.Generator(device=q.device).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(
        q.dtype).float()
    _, probs = local_relation_attention_with_probs_reference(*args)
    order, start = slot_order(idx, a_loc.shape[1])
    return (q, k, v, g, probs, a_loc, b_loc, idx, order, start,
            bank_runs(start, q.shape[2]))


B2_NAMES = ("gq", "gk", "gv", "g_a_loc", "g_b_loc")


def check_b2(label, bargs, mask, plant=False):
    """B2's wrapper against autograd of B1's plain version on the same
    inputs, taken in f32 (the cotangent g into its output): gq, gk, gv,
    g_a_loc, g_b_loc (`disagreement`), and the same bits from a second
    call (no atomics); then B2 and its plain version timed; returns its
    numbers. In f32 because autograd of the bf16 forward would sum each bank
    slot's pairs in bf16, where B2 sums in f32 and rounds once. With plant,
    the kernel's gradients with g_a_loc zeroed must fail the same check."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import (
        local_relation_attention_bwd as lrab,
        local_relation_attention_bwd_reference as plain,
        local_relation_attention_reference as plain_fwd)

    q, k, v, g, probs, a_loc, b_loc, idx, order, start, runs = bargs
    B, H, N, Dh = q.shape
    P_loc = a_loc.shape[1]
    dtype_name = _dtype_name(q)
    call = lambda: lrab(*bargs[:10], runs=runs)  # noqa: E731
    grads = call()
    again = call()
    leaves = [x.detach().float().requires_grad_()
              for x in (q, k, v, a_loc, b_loc)]
    out = plain_fwd(*leaves, idx, mask)
    refs = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    err = 0.0
    for name, x, ref, y in zip(B2_NAMES, grads, refs, again):
        if x.dtype != q.dtype or not torch.isfinite(x.float()).all():
            fail(f"B2 {label} {dtype_name}: {name} non-finite or of "
                 f"type {x.dtype}")
        if not torch.equal(x, y):
            fail(f"B2 {label} {dtype_name}: {name} differs between two "
                 "calls on the same inputs")
        err = max(err, (x.float() - ref.float()).abs().max().item())
    why = disagreement(B2_NAMES, grads, refs, dtype_name)
    if why is not None:
        fail(f"B2 {label} {dtype_name}: {why}")
    rel = rel_to_largest(grads, refs)
    if plant:
        zeroed = (*grads[:3], torch.zeros_like(grads[3]), grads[4])
        why = disagreement(B2_NAMES, zeroed, refs, dtype_name)
        if why is None:
            fail(f"B2 {label} {dtype_name}: the gate passes a planted B2 "
                 "whose g_a_loc is all zero")
        atol_alone = all(torch.allclose(x.float(), y.float(),
                                        **KERNEL_TOL[dtype_name])
                         for x, y in zip(zeroed, refs))
        print(f"[kernel] B2 {label} {dtype_name}: a planted zero g_a_loc "
              f"fails ({why.splitlines()[0]}; KERNEL_TOL alone would "
              f"{'pass' if atol_alone else 'fail'} it)", flush=True)
    bound_ms, bound_by = local_attention_bwd_bound(
        idx.cpu().numpy(), H, Dh, P_loc, dtype_name)
    ms = time_ms(call, bound_ms=bound_ms)
    plain_ms = time_ms(lambda: plain(*bargs[:8]))
    print(f"[kernel] B2 {label} B={B} H={H} N={N} Dh={Dh} P_loc={P_loc} "
          f"{dtype_name}: max_abs_err={err:.3e} (tol "
          f"{KERNEL_TOL[dtype_name]}; {rel:.3e} of the largest value) "
          f"bound={bound_ms:.6f} ms ({bound_by}) "
          f"kernel={ms:.6f} ms plain={plain_ms:.6f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ------------------------------------------- global-bank kernels B3, B3', B4


def global_batch(n_graphs, seed, min_nodes, max_nodes, N, P):
    """A batch from the port's batchify on the synthetic AMR corpus,
    padded to the node bucket N, with a global relation bank of exactly P
    rows (its pairs reference fewer)."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus

    graphs, targets = synthetic_amr_corpus(
        n_graphs, seed=seed, min_nodes=min_nodes, max_nodes=max_nodes)
    return batchify(preprocess(graphs, targets),
                    *build_vocabs(graphs, targets),
                    batch_size_bucket=n_graphs, for_train=False,
                    spec=BucketSpec(nodes=(N,), bank=(P,)))


def global_inputs(batch, H, Dh, dtype, seed=0):
    """Seeded q, k, v [B, H, N, Dh] and banks [P, H, Dh] on the card in
    `dtype`, with the batch's rel_index and node mask: the arguments of
    B3' (and of build_tables). The banks are the two halves of one [P,
    2 H Dh] tensor, as the encoder layer hands them (split_banks: views,
    rows 2 H Dh apart)."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import split_banks

    B, N = batch.concept_mask.shape
    P = batch.rel_bank.shape[0]
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    dev = lambda x: x.to(device="cuda", dtype=dtype).contiguous()  # noqa
    return (dev(rnd(B, H, N, Dh)), dev(rnd(B, H, N, Dh)),
            dev(rnd(B, H, N, Dh)),
            *split_banks(dev(rnd(P, 2 * H * Dh) * 0.5), H),
            torch.from_numpy(batch.rel_index).cuda(),
            torch.from_numpy(batch.concept_mask).cuda())


def table_args(bank_args):
    """B3's arguments (q, k, v, t2, t3, rel_index, mask) from B3''s."""
    from gtos_tpu_torch.ops.relation_attention import build_tables

    q, k, v, a, b, idx, mask = bank_args
    return (q, k, v, *build_tables(q, k, a, b), idx, mask)


def b4_args(targs, seed=1):
    """B4's arguments for B3's inputs: a seeded cotangent in the input
    type and the walk orders."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import walk_orders

    q, k, v, t2, t3, idx, mask = targs
    gen = torch.Generator(device=q.device).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    return (q, k, v, g, t2, t3, idx, mask, *walk_orders(idx))


def _compare(kernel, label, dtype_name, pairs):
    """Each (name, kernel output, plain output) within KERNEL_TOL, finite;
    returns the largest absolute error."""
    import torch

    err = 0.0
    for name, x, ref in pairs:
        if not torch.isfinite(x.float()).all():
            fail(f"{kernel} {label} {dtype_name}: {name} non-finite")
        err = max(err, (x.float() - ref.float()).abs().max().item())
        try:
            torch.testing.assert_close(x.float(), ref.float(),
                                       **KERNEL_TOL[dtype_name])
        except AssertionError as e:
            fail(f"{kernel} {label} {dtype_name}: {name} disagrees with its "
                 f"plain version: {e}")
    return err


def _hold(kernel, label, dtype_name, pairs, largest=None):
    """`_compare`, then each output within KERNEL_TOL's rtol of its plain
    version's own largest value (`rel_to_largest`, with `largest`); returns
    the largest absolute error and that relative one."""
    err = _compare(kernel, label, dtype_name, pairs)
    rel = rel_to_largest([x for _, x, _ in pairs], [y for _, _, y in pairs],
                         largest)
    if rel > KERNEL_TOL[dtype_name]["rtol"]:
        fail(f"{kernel} {label} {dtype_name}: error {rel:.3e} of the largest "
             f"value, above {KERNEL_TOL[dtype_name]['rtol']}")
    return err, rel


B3_PLANTS = ("t3 read at the query row", "no t2 term")


def planted_b3(kind, targs):
    """The plain B3 with one fault (B3_PLANTS): t3[b, h, i, r] read in
    place of t3[b, h, j, r] (the transposition the TPU kernel's idxT
    guards against), or the t2 term dropped."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import (
        _attend, _default_scale, _scores)

    q, k, v, t2, t3, idx, mask = targs
    if kind == B3_PLANTS[0]:     # both table terms from query row i
        t2, t3 = t2.float() + t3.float(), torch.zeros_like(t3)
    else:
        t2 = torch.zeros_like(t2)
    return _attend(_scores(q, k, t2, t3, idx, mask,
                           _default_scale(q, None)), v)


def check_b3(label, targs, plant=False):
    """B3's wrapper against its plain version on the same tables (within
    KERNEL_TOL and its rtol of the largest value), then both timed; prints
    one line, with the bound and the sector floor (`global_attention_bound`
    with sectors), and returns its numbers. With plant, each planted plain
    B3 of B3_PLANTS must fail the same gate."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import (
        fused_relation_attention as fra, fused_relation_attention_reference)

    q, idx, P = targs[0], targs[5], targs[3].shape[-1]
    B, H, N, Dh = q.shape
    dtype_name = _dtype_name(q)
    out = fra(*targs)
    ref = fused_relation_attention_reference(*targs)
    torch.cuda.synchronize()
    err, rel = _hold("B3", label, dtype_name, [("out", out, ref)])
    for kind in B3_PLANTS if plant else ():
        bad = planted_b3(kind, targs)
        why = disagreement(("out",), (bad,), (ref,), dtype_name)
        if why is None:
            fail(f"B3 {label} {dtype_name}: the gate passes a planted B3 "
                 f"({kind})")
        atol_alone = torch.allclose(bad.float(), ref.float(),
                                    **KERNEL_TOL[dtype_name])
        print(f"[kernel] B3 {label} {dtype_name}: a planted B3 ({kind}) "
              f"fails: gap {(bad.float() - ref.float()).abs().max().item():.3e}"
              f", {rel_to_largest((bad,), (ref,)):.3e} of the largest value "
              f"({why.splitlines()[0]}; KERNEL_TOL alone would "
              f"{'pass' if atol_alone else 'fail'} it)", flush=True)
    idx_np = idx.cpu().numpy()
    bound_ms, bound_by = global_attention_bound(idx_np, H, Dh, P, dtype_name,
                                                "tables")
    floor_ms, _ = global_attention_bound(idx_np, H, Dh, P, dtype_name,
                                         "tables", sectors=True)
    ms = time_ms(lambda: fra(*targs), bound_ms=bound_ms)
    plain_ms = time_ms(lambda: fused_relation_attention_reference(*targs))
    print(f"[kernel] B3 {label} B={B} H={H} N={N} Dh={Dh} P={P} "
          f"{dtype_name}: max_abs_err={err:.3e} (tol {KERNEL_TOL[dtype_name]};"
          f" {rel:.3e} of the largest value)"
          f" bound={bound_ms:.6f} ms ({bound_by}) sector_floor="
          f"{floor_ms:.6f} ms kernel={ms:.6f} ms "
          f"plain={plain_ms:.6f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                sector_floor_ms=floor_ms)


def check_b3i(label, args):
    """B3''s wrapper against its plain version on the same banks (within
    KERNEL_TOL and its rtol of the largest value), then both timed; prints
    one line and returns its numbers."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import (
        fused_relation_attention_inline as frai,
        fused_relation_attention_inline_reference as plain)

    q, idx, P = args[0], args[5], args[3].shape[0]
    B, H, N, Dh = q.shape
    dtype_name = _dtype_name(q)
    out = frai(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err, rel = _hold("B3'", label, dtype_name, [("out", out, ref)])
    bound_ms, bound_by = global_attention_bound(
        idx.cpu().numpy(), H, Dh, P, dtype_name, "inline")
    ms = time_ms(lambda: frai(*args), bound_ms=bound_ms)
    plain_ms = time_ms(lambda: plain(*args))
    print(f"[kernel] B3' {label} B={B} H={H} N={N} Dh={Dh} P={P} "
          f"{dtype_name}: max_abs_err={err:.3e} (tol {KERNEL_TOL[dtype_name]};"
          f" {rel:.3e} of the largest value)"
          f" bound={bound_ms:.6f} ms ({bound_by}) kernel={ms:.6f} ms "
          f"plain={plain_ms:.6f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


B4_NAMES = ("gq", "gk", "gv", "g_t2", "g_t3")


def check_b4(label, bargs, plant=False):
    """B4's wrapper against its plain version on the same tables and
    cotangent (gq, gk, gv, g_t2, g_t3; within KERNEL_TOL and its rtol of
    each output's largest value, `b4_largest`), the same bits from a
    second call (no atomics), then both timed; returns its numbers. With
    plant, the kernel's outputs with g_t3 zeroed must fail the same
    check."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import (
        fused_relation_attention_bwd as frab,
        fused_relation_attention_bwd_reference as plain)

    q, t2, idx = bargs[0], bargs[4], bargs[6]
    B, H, N, Dh = q.shape
    P = t2.shape[-1]
    dtype_name = _dtype_name(q)
    grads, again = frab(*bargs), frab(*bargs)
    refs = plain(*bargs[:8])
    torch.cuda.synchronize()
    for name, x, ref, y in zip(B4_NAMES, grads, refs, again):
        if x.dtype != ref.dtype or x.shape != ref.shape:
            fail(f"B4 {label} {dtype_name}: {name} is {x.dtype} "
                 f"{tuple(x.shape)}, the plain version's {ref.dtype} "
                 f"{tuple(ref.shape)}")
        if not torch.equal(x, y):
            fail(f"B4 {label} {dtype_name}: {name} differs between two "
                 "calls on the same inputs")
    err, rel = _hold("B4", label, dtype_name,
                     list(zip(B4_NAMES, grads, refs)), b4_largest(refs))
    if plant:
        zeroed = (*grads[:4], torch.zeros_like(grads[4]))
        why = disagreement(B4_NAMES, zeroed, refs, dtype_name,
                           b4_largest(refs))
        if why is None:
            fail(f"B4 {label} {dtype_name}: the gate passes a planted B4 "
                 "whose g_t3 is all zero")
        atol_alone = all(torch.allclose(x.float(), y.float(),
                                        **KERNEL_TOL[dtype_name])
                         for x, y in zip(zeroed, refs))
        print(f"[kernel] B4 {label} {dtype_name}: a planted zero g_t3 fails "
              f"({why.splitlines()[0]}; g_t3's largest value "
              f"{refs[4].float().abs().max().item():.3e}; KERNEL_TOL alone "
              f"would {'pass' if atol_alone else 'fail'} it)", flush=True)
    idx_np = idx.cpu().numpy()
    bound_ms, bound_by = global_attention_bound(idx_np, H, Dh, P, dtype_name,
                                                "bwd")
    floor_ms, _ = global_attention_bound(idx_np, H, Dh, P, dtype_name, "bwd",
                                         sectors=True)
    ms = time_ms(lambda: frab(*bargs), bound_ms=bound_ms)
    plain_ms = time_ms(lambda: plain(*bargs[:8]))
    print(f"[kernel] B4 {label} B={B} H={H} N={N} Dh={Dh} P={P} "
          f"{dtype_name}: max_abs_err={err:.3e} (tol {KERNEL_TOL[dtype_name]};"
          f" {rel:.3e} of the largest value)"
          f" bound={bound_ms:.6f} ms ({bound_by}) sector_floor="
          f"{floor_ms:.6f} ms kernel={ms:.6f} ms "
          f"plain={plain_ms:.6f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                sector_floor_ms=floor_ms)


def phase_kernels():
    """B1, B1p and B2 against their plain versions on real batchify index
    arrays: the dominant N=32 bucket (B=32) and an N=128 bucket with the
    corpus's largest local bank, H=8, Dh=64, in f32 and bf16. Then B3, B3'
    and B4 on real batchify global index arrays at N=32 (B=16) and N=128
    (B=8) with P=2048 and P=4096, and B3 (with and without its table
    build) and B3' timed on the same inputs, beside the forward the
    card's rule (_inline_fits, set from chip_crossovers.py) picks."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import (
        _inline_fits, build_tables, fused_relation_attention,
        fused_relation_attention_inline)

    H, Dh = 8, 64
    cases = {"N32": honest_batch(32, 0, 10, 31),
             "N128": honest_batch(8, 1, 64, 80)}
    for name, batch in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = kernel_inputs(batch, H, Dh, dtype)
            check_b1(name, args)
            check_b1p(name, args)
            check_b2(name, b2_args(args), args[6])
    print("[kernel] library_ms: none — no single PyTorch call computes "
          "localized relation attention or its backward (the score gathers "
          "a bank row per pair), so there is no library yardstick")
    cases = {"N32_P2048": global_batch(16, 0, 10, 14, 32, 2048),
             "N32_P4096": global_batch(16, 0, 16, 20, 32, 4096),
             "N128_P2048": global_batch(8, 1, 12, 18, 128, 2048),
             "N128_P4096": global_batch(8, 1, 20, 30, 128, 4096)}
    for name, batch in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = global_inputs(batch, H, Dh, dtype)
            targs = table_args(args)
            check_b3(name, targs)
            check_b3i(name, args)
            check_b4(name, b4_args(targs))
            if dtype == torch.bfloat16:
                path = time_ms(lambda: fused_relation_attention(
                    *table_args(args)))
                tables = time_ms(lambda: build_tables(
                    *args[:2], *args[3:5]))
                inline = time_ms(lambda: fused_relation_attention_inline(
                    *args))
                faster = "B3'" if inline <= path else "B3"
                print(f"[kernel] B3 vs B3' {name} bf16: build_tables "
                      f"{tables:.6f} ms + B3 = {path:.6f} ms; B3' "
                      f"{inline:.6f} ms; the card's rule picks "
                      + ("B3'" if _inline_fits(args[0], args[3]) else "B3")
                      + f", the faster here {faster}", flush=True)
        torch.cuda.empty_cache()
    print("[kernel] library_ms: none — no single PyTorch call computes the "
          "global-bank relation attention or its backward (the score "
          "gathers a table entry per pair), so there is no library "
          "yardstick")


# the global-bank kernels' edge cases (B, H, N, Dh, P, layout), as
# tests/test_torch_cuda.py's GLOBAL_EDGE_CASES: "one_run" puts every pair
# of graph 0 on one bank row (each row and each column one run of N);
# "padded" pads each graph to N (pairs of padded nodes on row 0) and pads
# the last graph whole; "random" draws each pair's row. P=1, P=1001 (not a
# multiple of 8: table-gradient rows stored a value at a time) and
# P=65536, the largest bank of the ladders, where B4 stages each row of
# its dense table gradients in many tiles (f32: 64)
GLOBAL_EDGES = {"one_run": (2, 8, 32, 64, 512, "one_run"),
                "padded": (4, 8, 32, 64, 1024, "padded"),
                "N1": (2, 8, 1, 64, 16, "random"),
                "P1": (2, 8, 16, 64, 1, "random"),
                "P1001": (2, 8, 32, 64, 1001, "random"),
                "Dh32": (2, 8, 32, 32, 512, "random"),
                "Dh128": (2, 8, 32, 128, 512, "random"),
                "H12": (2, 12, 17, 64, 300, "random"),
                "P65536": (1, 8, 16, 64, 65536, "random")}


def global_edge_inputs(B, H, N, Dh, P, layout, dtype, seed=0):
    """Seeded arguments of B3' for a GLOBAL_EDGES case on the card (the
    banks the halves of one [P, 2 H Dh] tensor) and a cotangent g."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import split_banks

    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    q, k, v, g = (rnd(B, H, N, Dh) for _ in range(4))
    ab = rnd(P, 2 * H * Dh) * 0.5
    idx = torch.randint(0, P, (B, N, N), generator=gen)
    mask = torch.ones(B, N, dtype=torch.bool)
    if layout == "one_run":
        idx[0] = P // 2
    elif layout == "padded":
        for b in range(B):
            n = 0 if b == B - 1 else int(torch.randint(
                N // 2, N, (1,), generator=gen))
            mask[b, n:] = False
            idx[b, n:], idx[b, :, n:] = 0, 0
    dev = lambda x: x.to(device="cuda", dtype=dtype)  # noqa: E731
    return ((dev(q), dev(k), dev(v), *split_banks(dev(ab), H),
             idx.int().cuda(), mask.cuda()), dev(g))


def phase_global_edges():
    """B3, B3' and B4 on GLOBAL_EDGES in f32 and bf16 against their plain
    versions (`_hold`: KERNEL_TOL and its rtol of each output's largest
    value): B3' on the bank halves the same bits as on contiguous copies;
    B4 the same bits twice, its dense table gradients written in full
    (entries no pair refers to exactly 0) into memory that held NaN (the
    caching allocator hands the freed blocks to the wrapper's
    torch.empty)."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import (
        build_tables, fused_relation_attention as fra,
        fused_relation_attention_bwd as frab,
        fused_relation_attention_bwd_reference as frab_plain,
        fused_relation_attention_inline as frai,
        fused_relation_attention_inline_reference as frai_plain,
        fused_relation_attention_reference as fra_plain, walk_orders)

    for case, (B, H, N, Dh, P, layout) in GLOBAL_EDGES.items():
        for dtype in (torch.float32, torch.bfloat16):
            args, g = global_edge_inputs(B, H, N, Dh, P, layout, dtype)
            q, k, v, a, b, idx, mask = args
            name = _dtype_name(q)
            out = frai(*args)
            if not torch.equal(out, frai(q, k, v, a.contiguous(),
                                         b.contiguous(), idx, mask)):
                fail(f"B3' {case} {name}: the bank halves and contiguous "
                     "copies of them give different bits")
            t2, t3 = build_tables(q, k, a, b)
            targs = (q, k, v, t2, t3, idx, mask)
            rows, cols = walk_orders(idx)
            junk = [torch.full((B, N, H, P), float("nan"), dtype=dtype,
                               device="cuda") for _ in range(2)]
            del junk
            grads = frab(q, k, v, g, *targs[3:], rows, cols)
            again = frab(q, k, v, g, *targs[3:], rows, cols)
            refs = frab_plain(q, k, v, g, *targs[3:])
            torch.cuda.synchronize()
            errs = [_hold("B3'", case, name,
                          [("out", out, frai_plain(*args))]),
                    _hold("B3", case, name,
                          [("out", fra(*targs), fra_plain(*targs))]),
                    _hold("B4", case, name, list(zip(B4_NAMES, grads, refs)),
                          b4_largest(refs))]
            for label, x, y in zip(B4_NAMES, grads, again):
                if not torch.equal(x, y):
                    fail(f"B4 {case} {name}: {label} differs between two "
                         "calls on the same inputs")
            il = idx.long()
            used2 = torch.zeros(B, N, P, dtype=torch.bool, device="cuda")
            used2.scatter_(2, il, True)
            used3 = torch.zeros(B, N, P, dtype=torch.bool, device="cuda")
            used3.scatter_(2, il.transpose(1, 2), True)
            for label, x, used in (("g_t2", grads[3], used2),
                                   ("g_t3", grads[4], used3)):
                if torch.count_nonzero(x.permute(0, 1, 3, 2)[~used]):
                    fail(f"B4 {case} {name}: {label} is not 0 at entries "
                         "no pair refers to")
            print(f"[edge] {case} B={B} H={H} N={N} Dh={Dh} P={P} {name}: "
                  "B3' / B3 / B4 max_abs_err "
                  + " / ".join(f"{e:.3e} ({r:.3e} of the largest value)"
                               for e, r in errs), flush=True)
        torch.cuda.empty_cache()


KERNELS = {  # name in the JSON line -> (kernel, source, TPU kernel)
    "local_relation_attention_fwd": (
        "B1",
        "gtos_tpu_torch/ops/csrc/local_relation_attention_fwd.cu",
        "gtos_tpu/ops/pallas/local_relation_attention.py:145"),
    "local_relation_attention_fwd_probs": (
        "B1p",
        "gtos_tpu_torch/ops/csrc/local_relation_attention_fwd.cu",
        "gtos_tpu/ops/pallas/local_relation_attention.py:254"),
    "local_relation_attention_bwd": (
        "B2",
        "gtos_tpu_torch/ops/csrc/local_relation_attention_bwd.cu",
        "gtos_tpu/ops/pallas/local_relation_attention.py:326"),
    "relation_attention_fwd_tables": (
        "B3",
        "gtos_tpu_torch/ops/csrc/relation_attention_fwd.cu",
        "gtos_tpu/ops/pallas/relation_attention.py:41"),
    "relation_attention_fwd_inline": (
        "B3'",
        "gtos_tpu_torch/ops/csrc/relation_attention_fwd.cu",
        "gtos_tpu/ops/pallas/relation_attention.py:195"),
    "relation_attention_bwd": (
        "B4",
        "gtos_tpu_torch/ops/csrc/relation_attention_bwd.cu",
        "gtos_tpu/ops/pallas/relation_attention_bwd.py:33"),
    "block_sparse_attention_fwd": (
        "B5",
        "gtos_tpu_torch/ops/csrc/block_sparse_attention_fwd.cu",
        "gtos_tpu/ops/pallas/block_sparse_attention.py:43"),
    "block_sparse_attention_fwd_stats": (
        "B5s",
        "gtos_tpu_torch/ops/csrc/block_sparse_attention_fwd.cu",
        "gtos_tpu/ops/pallas/block_sparse_attention.py:116"),
    "block_sparse_attention_bwd_dst": (
        "B6d",
        "gtos_tpu_torch/ops/csrc/block_sparse_attention_bwd.cu",
        "gtos_tpu/ops/pallas/block_sparse_attention_bwd.py:85"),
    "block_sparse_attention_bwd_src": (
        "B6s",
        "gtos_tpu_torch/ops/csrc/block_sparse_attention_bwd.cu",
        "gtos_tpu/ops/pallas/block_sparse_attention_bwd.py:150"),
    # the bank gradients the TPU's dst and src passes sum in their g_bb /
    # g_ab output blocks (and finish_bank_grads's t4 term, :259)
    "block_sparse_bank_grads": (
        "B6b",
        "gtos_tpu_torch/ops/csrc/block_sparse_attention_bwd.cu",
        "gtos_tpu/ops/pallas/block_sparse_attention_bwd.py:85"),
}
# each kernel's design, as its source's header gives it (the JSON line's
# "design")
DESIGNS = {
    "local_relation_attention_fwd":
        "a block per (graph, node), head warps, 8 lanes a pair",
    "local_relation_attention_fwd_probs":
        "B1's body, the f32 probabilities written too",
    "local_relation_attention_bwd":
        "rows, columns and chunks, finish: 3 launches over the slot runs",
    "relation_attention_fwd_tables":
        "B3''s row body: a block per (graph, query row), head warps, "
        "8 lanes a pair, the table scalars gathered before the q.k rounds",
    "relation_attention_fwd_inline":
        "the row body shared with B3: bank-row chunks, t4 formed in the "
        "kernel",
    "relation_attention_bwd":
        "a row pass and a column pass, dense table rows through a "
        "shared-memory tile",
    "block_sparse_attention_fwd":
        "a block per node, one plane walk for all heads, a softmax per "
        "lane group",
    "block_sparse_attention_fwd_stats": "B5's body, m and l written too",
    "block_sparse_attention_bwd_dst":
        "a block per node, one plane walk for all heads, (ge, p) written "
        "src-major",
    "block_sparse_attention_bwd_src":
        "a block per node, one plane walk, (ge, p) read from the dst pass",
    "block_sparse_bank_grads":
        "each bank row's run walked once for all heads, long runs in "
        "256-pair chunks",
}
B1, B1P, B2 = ("local_relation_attention_fwd",
               "local_relation_attention_fwd_probs",
               "local_relation_attention_bwd")
B3, B3I, B4 = ("relation_attention_fwd_tables",
               "relation_attention_fwd_inline", "relation_attention_bwd")
B5, B5S, B6D, B6S, B6B = ("block_sparse_attention_fwd",
                          "block_sparse_attention_fwd_stats",
                          "block_sparse_attention_bwd_dst",
                          "block_sparse_attention_bwd_src",
                          "block_sparse_bank_grads")


def _wrapper(name):
    return kernel_calls.wrapper(KERNELS[name][0])


def zero_counts():
    for name in KERNELS:
        _wrapper(name).launches = 0


def read_counts():
    return {name: _wrapper(name).launches for name in KERNELS}


def table_row(name, rows, launches, model="c2"):
    """The JSON line's row of one kernel on one model's main path (its
    "model": "c2", "c4", "c5" or "c5 mesh"): the mean over that path's
    inputs of each number, the largest error. `bench_timed` replaces the
    times of the c2, c4 and c5 rows by the bench's."""
    _, source, replaces = KERNELS[name]
    row = dict(name=name, model=model, route="cuda", source=source,
               replaces=replaces, launches=launches[name], library_ms=None,
               design=DESIGNS[name])
    if all("library_ms" in r for r in rows):
        row["library_ms"] = sum(r["library_ms"] for r in rows) / len(rows)
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    for key in ("ms", "plain_ms", "bound_ms"):
        row[key] = sum(r[key] for r in rows) / len(rows)
    kinds = {r["bound_by"] for r in rows}
    row["bound_by"] = kinds.pop() if len(kinds) == 1 else "bytes"
    return row


def bench_timed(rows, bench_rows):
    """The c2, c4 and c5 rows with the times of the bench's kernels cell
    (phase_bench, this run): one kernel time per row, on the same model's
    layer 0 inputs of its first batch (the bench row's "source"), event
    ms, device ms and plain ms the medians of its samples, with its bound
    and library ms; the largest error of both gates. The mesh's rows keep
    their per-cell times."""
    out = []
    for row in rows:
        if row["model"] not in ("c2", "c4", "c5"):
            out.append(row)
            continue
        kernel = KERNELS[row["name"]][0]
        found = [b for b in bench_rows if b["kernel"] == kernel
                 and b["source"].split("_")[0] == row["model"]]
        if len(found) != 1:
            fail(f"{row['name']} ({row['model']}): {len(found)} bench rows")
        b = found[0]
        lib = b["library_ms"]
        out.append(dict(
            row, ms=b["ms"]["median"], device_ms=b["device_ms"]["median"],
            plain_ms=b["plain_ms"]["median"], bound_ms=b["bound_ms"],
            bound_by=b["bound_by"],
            library_ms=None if lib is None else lib["median"],
            max_abs_err=max(row["max_abs_err"], b["max_abs_err"]),
            timed_on=f"bench kernels cell, {b['source']} batch 0 ("
                     + " ".join(f"{k}={v}" for k, v in b["shape"].items())
                     + f"), median of {b['ms']['n']}"))
    return out


def phase_main_shapes(b1_inputs, serve_launches, train_inputs,
                      train_launches, model="c2"):
    """Each kernel on the inputs a model's main path gave it, held against
    its plain version and timed: B1 on layer 0 of each served batch
    (bf16), B1p and B2 on layer 0 of CAPTURE_BATCHES train batches (bf16;
    a planted B2 with g_a zeroed must fail B2's gate). The launches are
    those of the serving run (B1) and of the training run (B1p, B2)."""
    pre = "" if model == "c2" else f"{model} "
    b1 = [check_b1(f"{pre}serve{i}", args)
          for i, args in enumerate(b1_inputs)]
    b1p, b2 = [], []
    for i, (fwd, bwd) in enumerate(train_inputs):
        b1p.append(check_b1p(f"{pre}train{i}", fwd))
        b2.append(check_b2(f"{pre}train{i}", bwd, fwd[6], plant=True))
    return [table_row(B1, b1, serve_launches, model),
            table_row(B1P, b1p, train_launches, model),
            table_row(B2, b2, train_launches, model)]


def phase_global_shapes(serve_inputs, serve_launches, train_inputs,
                        train_launches):
    """B3, B3' and B4 on the inputs the "pallas" paths gave them, held
    against their plain versions and timed: layer 0's forward of each
    served batch and each captured train batch (the forward the card's
    rule gave the batch's bank: B3' at every shape the kernels take, and
    B3, which the rule routes no bank to, on the tables that build_tables
    makes of those inputs; on the train inputs the planted B3s of
    B3_PLANTS must fail B3's gate), layer 0's backward of each captured
    train batch (B4, where a planted zero g_t3 must fail the gate), bf16.
    The launches are those of the "pallas" serving run and training run
    together (B3, B3') and of the training run (B4)."""
    rows = {B3: [], B3I: [], B4: []}
    for tag, captured in (("serve", serve_inputs), ("train", train_inputs)):
        for i, (kind, args, bwd) in enumerate(captured):
            label = f"{tag}{i}"
            if kind == B3I:
                rows[B3I].append(check_b3i(label, args))
                args = table_args(args)
            rows[B3].append(check_b3(label, args, plant=tag == "train"))
            if bwd is not None:
                rows[B4].append(check_b4(label, bwd, plant=True))
    for name, found in rows.items():
        if not found:
            fail(f"the pallas paths gave {name} no inputs to check")
    launches = {name: serve_launches[name] + train_launches[name]
                for name in KERNELS}
    out = [table_row(name, rows[name], launches) for name in (B3, B3I, B4)]
    if not launches[B3]:
        out[0]["note"] = ("the card's rule (_inline_fits, set from "
                          "chip_crossovers.py) routes no bank to B3: held "
                          "and timed on the tables build_tables makes of "
                          "the main path's B3' inputs")
    return out


def tag_of(base, impl="pallas_local", family="c2"):
    """A phase's print tag: `base`, the impl unless "pallas_local", the
    family unless "c2" ("serve", "train pallas", "c4 grads")."""
    return " ".join(([family] if family != "c2" else []) + [base]
                    + ([impl] if impl != "pallas_local" else []))


def route_of(impl, arrays, cfg):
    """(the attention route of a batch under `impl`, and for the global
    route the forward kernel the card's rule (_inline_fits) gives its
    bank: B3' within the kernels' limits, else B3; for the localized
    route B1)."""
    import torch

    from gtos_tpu_torch.models.generator import resolve_attention_impl
    from gtos_tpu_torch.ops.relation_attention import _inline_fits

    route = resolve_attention_impl(impl, arrays)
    if route == "block_sparse":
        return route, B5
    if route != "pallas":
        return route, B1
    B, N = arrays["concept"].shape
    H, Dh = cfg.heads, cfg.d_model // cfg.heads
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    q = torch.empty(B, H, N, Dh, dtype=dt, device="meta")
    a = torch.empty(arrays["rel_bank"].shape[0], H, Dh, dtype=dt,
                    device="meta")
    return route, (B3I if _inline_fits(q, a) else B3)


def describe(batch):
    """A batch's shape line: B, N, T, the global bank P and, where built,
    the local bank P_loc."""
    B, N = batch.concept_mask.shape
    loc = ("" if batch.bank_map is None
           else f" P_loc={batch.bank_map.shape[1]}")
    return (f"B={B} N={N} T={batch.token_in.shape[1]} "
            f"P={batch.rel_bank.shape[0]}{loc}")


def serving_setup(impl="pallas_local", family="c2"):
    """The family's model at full width (random weights from seed 0) with
    the corpus's vocabularies under attention_impl `impl`, and a
    DataLoader of 1024 held-out requests (another seed of the same
    corpus) with the impl's loader flags."""
    import torch

    from gtos_tpu_torch.data import DataLoader
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.train import loader_flags

    cfg, _ = configs(family)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    tv, cv, rv, chv, lm = corpus(family)[1]
    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    req_g, req_t = raw_corpus(family, seed=1, n=1024)
    loader = DataLoader(preprocess(req_g, req_t), tv, cv, rv, chv, lm,
                        batch_size_tokens=4096, for_train=False,
                        **loader_flags(impl))
    return cfg, model, loader, tv


def phase_serve(impl="pallas_local", family="c2"):
    """Serve SERVE_BATCHES batches, the fullest of each of the smallest
    node buckets, through decode_batch, after one warm-up decode; and the
    fullest batch of a kernel the route's rules can pick that the others
    miss (`needs`). Returns the batches served,
    their seconds and the launches of each kernel in that run: enc_layers
    per batch of the kernel its route and bank select, none of any
    other."""
    import torch

    from gtos_tpu_torch.infer import decode
    from gtos_tpu_torch.infer.decode import decode_batch

    tag = tag_of("serve", impl, family)
    cfg, model, loader, tv = serving_setup(impl, family)
    print(f"[{tag}] model d={cfg.d_model} ff={cfg.d_ff} heads={cfg.heads} "
          f"enc={cfg.enc_layers} dec={cfg.dec_layers} {cfg.compute_dtype} "
          f"{cfg.attention_impl} use_copy={cfg.use_copy} "
          f"use_node_positions={cfg.use_node_positions}; vocab token="
          f"{cfg.token_vocab} concept={cfg.concept_vocab} relation="
          f"{cfg.relation_vocab}")
    steps = 0
    search = decode.beam_decode_arrays

    def counted(*a, **kw):  # the search's batched steps: its final t
        nonlocal steps
        res = search(*a, **kw)
        steps += int(res.steps)
        return res

    decode.beam_decode_arrays = counted
    fullest, counts = {}, {}  # per node bucket: its fullest batch; sizes
    by_kernel = {}            # per route's kernel: its fullest batch
    for batch, insts in loader.iter_with_instances():
        N = batch.concept_mask.shape[1]
        counts.setdefault(N, []).append(len(insts))
        if N not in fullest or len(insts) > len(fullest[N][1]):
            fullest[N] = (batch, insts)
        kern = route_of(impl, batch.arrays(), cfg)[1]
        if kern not in by_kernel or len(insts) > len(by_kernel[kern][1]):
            by_kernel[kern] = (batch, insts)
    for N, sizes in sorted(counts.items()):
        print(f"[{tag}] loader, node bucket N={N}: {len(sizes)} batches, "
              f"{sum(sizes)} requests, {min(sizes)}-{max(sizes)} per batch")
    plan = [fullest[N] for N in sorted(fullest)[:SERVE_BATCHES]]
    kernels = {route_of(impl, b.arrays(), cfg)[1] for b, _ in plan}
    # each of these must run: the forward kernel the card's rule gives
    # every "pallas" bank; "auto"'s localized route, which takes every
    # batch of its loader (each carries local banks)
    needs = {"pallas": [(B3I,)], "auto": [(B1,)]}
    for options in needs.get(impl, []):
        if not kernels & set(options):
            pick = next((k for k in options if k in by_kernel), None)
            if pick is None:
                fail(f"the {impl} serving loader has no batch for "
                     f"{' or '.join(options)}")
            plan.append(by_kernel[pick])
            kernels.add(pick)
    t0 = time.perf_counter()  # first use: cuBLAS set-up, allocator growth
    decode_batch(model, plan[0][0], tv, beam_size=BEAM, max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up decode of batch 0 (cold): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    batches, seconds = [], []
    expect = dict.fromkeys(KERNELS, 0)
    zero_counts()
    for batch, insts in plan:
        steps = 0
        t0 = time.perf_counter()
        hyps = decode_batch(model, batch, tv, beam_size=BEAM,
                            max_steps=MAX_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if len(hyps) != len(insts) or not all(
                isinstance(h, list) and all(isinstance(w, str) for w in h)
                for h in hyps):
            fail("decode_batch must return one list of strings per request")
        route, kern = route_of(impl, batch.arrays(), cfg)
        expect[kern] += cfg.enc_layers
        print(f"[{tag}] batch {len(batches)}: {len(insts)} requests "
              f"({describe(batch)}) route {route} ({kern}) beam {BEAM}: "
              f"{dt * 1e3:.3f} ms, {steps} decode steps, "
              f"{steps / dt:.3f} steps/s, {len(insts) / dt:.3f} "
              f"requests/s; first hypothesis: "
              f"{' '.join(hyps[0][:8])!r}", flush=True)
        batches.append(batch)
        seconds.append(dt)
    launches = read_counts()
    decode.beam_decode_arrays = search
    if len(batches) < 2:
        fail(f"only {len(batches)} batch(es) served")
    if launches != expect:
        fail(f"launches in the {impl} serving run: {launches}, expected "
             f"{expect} (enc_layers x batches of each route's kernel, no "
             "other kernel)")
    print(f"[{tag}] launches in the serving run: "
          f"{ {k: v for k, v in launches.items() if v} } "
          f"({cfg.enc_layers} layers x {len(batches)} batches)", flush=True)
    return cfg, model, tv, batches, seconds, launches


def encode(model, batch):
    """Generator.encode of a GraphBatch on the model's device, as f32 on
    the CPU."""
    import torch

    from gtos_tpu_torch.models.generator import batch_edges, batch_to_device

    t = batch_to_device(batch.arrays(), model.device)
    with torch.inference_mode():
        return model.encode(t["concept"], t["concept_char"],
                            t["concept_mask"], t["rel_bank"],
                            t["rel_length"], t["rel_index"],
                            edges=batch_edges(t)).float().cpu()


def capture_b1_inputs(model, batches):
    """The arguments the main path hands B1: layer 0's, for each served
    batch (one more encode per batch, `capture`)."""
    return [capture(model, b, False, model.device)["calls"]["B1"][0]
            for b in batches]


def planted_b1(kind):
    """B1 made wrong on purpose, as a control for the encoder check: its
    plain version without the bank terms a_r, b_r ("no bank"), or with
    padded keys let in ("no key mask")."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import (
        local_relation_attention_reference as plain)

    def wrong(q, k, v, a_loc, b_loc, rel_index_loc, node_mask):
        if kind == "no bank":
            a_loc, b_loc = torch.zeros_like(a_loc), torch.zeros_like(b_loc)
        else:
            node_mask = torch.ones_like(node_mask)
        return plain(q, k, v, a_loc, b_loc, rel_index_loc, node_mask)
    return wrong


def phase_encoder_check(cfg, model, batch, tag="encode", encoder=None):
    """Generator.encode on the card (kernel) vs the same weights on the
    CPU in f32 (plain version), over the batch's real nodes: the served
    bf16 model, and the same weights in f32 on the card. Each planted
    wrong B1 must fail both checks. encoder(model, batch): how the card
    encodes (default `encode`; `captured_encode` replays a CUDA graph)."""
    import torch

    from gtos_tpu_torch.models import Generator

    weights = {k: v.float() for k, v in model.state_dict().items()}
    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = Generator(f32_cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in weights.items()})
    card32 = Generator(f32_cfg, device="cuda")
    card32.load_state_dict(weights)
    ref = encode(cpu, batch)
    mask = torch.from_numpy(batch.concept_mask)

    def check(card, dtype_name, b1):
        out = (encoder or encode)(card, batch)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail(f"encoder output {tuple(out.shape)} not finite / wrong "
                 "shape")
        diff = (out - ref).abs()[mask]
        max_abs, mean_abs = diff.max().item(), diff.mean().item()
        tol = ENCODER_TOL[dtype_name]
        ok = max_abs <= tol["max_abs"] and mean_abs <= tol["mean_abs"]
        print(f"[{tag}] card {dtype_name} with {b1} vs cpu f32 over "
              f"{int(mask.sum())} real nodes: max_abs={max_abs:.4e} "
              f"mean_abs={mean_abs:.4e} (tol {tol}): "
              + ("within" if ok else "outside"), flush=True)
        return ok

    for card, dtype_name in ((model, "bfloat16"), (card32, "float32")):
        if not check(card, dtype_name, "B1"):
            fail(f"encoder on the card in {dtype_name} disagrees with the "
                 "f32 CPU run")
    for kind in ("no bank", "no key mask"):
        for card, dtype_name in ((model, "bfloat16"), (card32, "float32")):
            with replaced("B1", planted_b1(kind)):
                if check(card, dtype_name, f"planted B1 ({kind})"):
                    fail(f"the {dtype_name} encoder check passes a B1 "
                         f"with {kind}")


def phase_profile(model, tv, batches, seconds):
    """Where a served batch's time goes (--profile): torch.profiler over
    one more decode_batch of each served batch. Device busy time is the
    sum of the card's kernel and copy times; its idle share is measured
    against the unprofiled wall time of the same batch in the serving
    run. Prints the busiest kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gtos_tpu_torch.infer.decode import decode_batch

    for i, (batch, wall) in enumerate(zip(batches, seconds)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode_batch(model, batch, tv, beam_size=BEAM,
                         max_steps=MAX_STEPS)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        if busy_ms <= 0:
            fail("the profiler recorded no device time")
        launches = sum(e.count for e in dev)
        print(f"[profile] batch {i}: device busy {busy_ms:.3f} ms of "
              f"{wall * 1e3:.3f} ms wall, idle share "
              f"{1 - busy_ms / (wall * 1e3):.4f}; {launches} device "
              f"kernels/copies", flush=True)
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x {e.key[:90]}")


# ---------------------------------------------------------------- training


class StepLog:
    """The Trainer's metrics writer: keeps every record, with the
    host-clock ms per step since the record before, and prints the loss,
    accuracy, ms per step and the loop's tokens/s of step 1 and of every
    `every`-th step."""

    def __init__(self, tag, every=LOG_EVERY):
        self.tag, self.every, self.records = tag, every, []
        self.t, self.step = time.perf_counter(), 0

    def write(self, rec):
        now = time.perf_counter()
        if rec.get("kind") == "train":
            ms = (now - self.t) * 1e3 / max(rec["step"] - self.step, 1)
            rec = dict(rec, ms_per_step=ms)
            self.t, self.step = now, rec["step"]
            if rec["step"] == 1 or rec["step"] % self.every == 0:
                self._print(rec, ms)
        self.records.append(rec)

    def _print(self, rec, ms):
        print(f"[{self.tag}] step {rec['step']}: loss={rec['loss']:.6f} "
              f"acc={rec['acc']:.4f} grad_norm={rec['grad_norm']:.4f} "
              f"{ms:.3f} ms/step, {rec['tokens_per_s']:.1f} tokens/s",
              flush=True)

    def losses(self):
        return [r["loss"] for r in self.records if r.get("kind") == "train"]


def train_loader(seed=None, impl="pallas_local", family="c2", **kw):
    """for_train=True DataLoader over the family's corpus with the loader
    flags of attention_impl `impl`, as the train CLI builds it (8192-token
    batches), and the DataLoader keywords `kw` (workers, batch_multiple)."""
    from gtos_tpu_torch.data import BucketSpec, DataLoader
    from gtos_tpu_torch.train.train import loader_flags

    cfg, tcfg = configs(family)
    instances, vocabs = corpus(family)
    return DataLoader(instances, *vocabs,
                      batch_size_tokens=tcfg.batch_size_tokens,
                      spec=BucketSpec().for_model_max_oov(cfg.max_oov),
                      for_train=True, **loader_flags(impl),
                      seed=tcfg.seed if seed is None else seed, **kw)


def new_trainer(cfg, tcfg, seed, ckpt=None, log=None, family="c2"):
    import torch

    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.trainer import Trainer

    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(seed))
    example = next(iter(train_loader(family=family)))
    return Trainer(model, cfg, tcfg, example.arrays(), metrics_writer=log,
                   checkpoint_manager=ckpt, device="cuda")


def train_expect(impl, cfg, batches):
    """The launches a training run over `batches` must make: per step,
    enc_layers of the forward kernel its route and bank select and as
    many of each of that route's backward kernels (B2, B4, or B6d, B6s and
    B6b)."""
    expect = dict.fromkeys(KERNELS, 0)
    for batch in batches:
        kern = route_of(impl, batch.arrays(), cfg)[1]
        fwd, bwd = {B1: (B1P, (B2,)), B5: (B5S, (B6D, B6S, B6B))}.get(
            kern, (kern, (B4,)))
        for name in (fwd, *bwd):
            expect[name] += cfg.enc_layers
    return expect


def phase_train(impl="pallas_local", family="c2"):
    """Trainer.fit of the family's model at full width (bf16, dropout
    0.2, label smoothing 0.1, the config's schedule) under attention_impl
    `impl`, counting the launches of that run: "pallas_local" TRAIN_STEPS
    steps from the DataLoader, then for c2 the overfit; "pallas"
    PALLAS_STEPS steps (B3' and B4). Returns the trainer, its mean ms per
    step after the first logged interval, the launches and the batches
    trained on."""
    import torch

    cfg, tcfg = configs(family)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    tag = tag_of("train", impl, family)
    steps = TRAIN_STEPS if impl == "pallas_local" else PALLAS_STEPS
    source = train_loader(impl=impl, family=family)
    batches = [b for _, b in zip(range(steps),
                                 train_loader(impl=impl, family=family))]
    log = StepLog(tag)
    trainer = new_trainer(cfg, dataclasses.replace(
        tcfg, total_steps=steps, checkpoint_every=10 ** 9), 0, log=log,
        family=family)
    print(f"[{tag}] model d={cfg.d_model} ff={cfg.d_ff} heads={cfg.heads} "
          f"enc={cfg.enc_layers} dec={cfg.dec_layers} {cfg.compute_dtype} "
          f"{cfg.attention_impl} dropout={cfg.dropout} label_smoothing="
          f"{cfg.label_smoothing}; {steps} steps of "
          f"{tcfg.batch_size_tokens}-token batches", flush=True)
    if impl != "pallas_local" or family != "c2":
        for i, batch in enumerate(batches):
            print(f"[{tag}] step {i + 1} batch: {describe(batch)} -> "
                  f"{route_of(impl, batch.arrays(), cfg)[1]}")
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit(source, log_every=LOG_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect = train_expect(impl, cfg, batches)
    if trainer.step != steps or launches != expect:
        fail(f"training ran {trainer.step} steps with launches {launches}, "
             f"expected {steps} with {expect} (per step enc_layers of the "
             "route's forward and backward kernels, none of any other)")
    losses = log.losses()
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    steady = [r["ms_per_step"] for r in log.records[1:]]
    ms_step = sum(steady) / len(steady)
    tokens = sum(int(b.token_mask.sum()) for b in batches)
    print(f"[{tag}] {steps} steps in {wall:.3f} s; {ms_step:.3f} "
          f"ms/step after step {LOG_EVERY}; {tokens / wall:.1f} target "
          f"tokens/s over the run; launches "
          f"{ {k: v for k, v in launches.items() if v} } = "
          f"{cfg.enc_layers} layers x {steps} steps", flush=True)

    if impl == "pallas_local" and family == "c2":
        overfit(cfg, tcfg)
    return trainer, ms_step, launches, batches


def overfit(cfg, tcfg):
    """A fresh c2 model trained OVERFIT_STEPS steps on one fixed batch
    with dropout and label smoothing off (the objective of the JAX
    package's own overfit test), warm-up 30 steps to a peak learning rate
    of 8e-4: its loss must fall below OVERFIT_RATIO x its first. (With
    label smoothing 0.1, or peaks of 1.4e-3 and more, the batch stalls
    near the unigram loss: PERF.md, Findings.)"""
    batch = next(iter(train_loader()))
    log = StepLog("overfit", every=10)
    trainer = new_trainer(
        dataclasses.replace(cfg, dropout=0.0, label_smoothing=0.0),
        dataclasses.replace(tcfg, total_steps=OVERFIT_STEPS,
                            warmup_steps=30, lr_scale=0.1,
                            checkpoint_every=10 ** 9), 1, log=log)
    trainer.fit([batch] * OVERFIT_STEPS, log_every=1)
    first, last = log.losses()[0], log.losses()[-1]
    ok = last < OVERFIT_RATIO * first
    print(f"[overfit] one batch of {batch.concept_mask.shape[0]} graphs, "
          f"{OVERFIT_STEPS} steps: loss {first:.6f} at step 1 -> "
          f"{last:.6f}; must fall below {OVERFIT_RATIO} x the first: "
          + ("yes" if ok else "no"), flush=True)
    if not ok:
        fail("the overfit loss did not fall by its stated margin")


def planted_b2(kind):
    """B2 made wrong on purpose, as a control for the gradient check: the
    kernel's result with the bank gradients zeroed ("no bank gradient"),
    or with g_a_loc summing ge_ij k_j without the ge_ij b_r part of the
    t4 unfold ("no t4 b_r term", the plain version's g_a_loc with b_loc
    zeroed)."""
    import torch

    from gtos_tpu_torch.ops.local_relation_attention import (
        local_relation_attention_bwd as lrab,
        local_relation_attention_bwd_reference as plain)

    def wrong(q, k, v, g, probs, a_loc, b_loc, idx, pair_order=None,
              slot_start=None, scale=None, runs=None):
        gq, gk, gv, ga, gb = lrab(q, k, v, g, probs, a_loc, b_loc, idx,
                                  pair_order, slot_start, scale,
                                  runs=runs)
        if kind == "no bank gradient":
            return gq, gk, gv, torch.zeros_like(ga), torch.zeros_like(gb)
        ga = plain(q, k, v, g, probs, a_loc, torch.zeros_like(b_loc), idx,
                   scale)[3]
        return gq, gk, gv, ga, gb
    return wrong


def planted_b4(kind):
    """B4 made wrong on purpose, as a control for the gradient check: the
    kernel's result with the g_t3 table gradient zeroed ("no g_t3": the
    key side's bank terms are lost), or with g_t2 zeroed ("no g_t2": the
    query side's bank terms and the t4 redistribution are lost)."""
    import torch

    from gtos_tpu_torch.ops.relation_attention import (
        fused_relation_attention_bwd as frab)

    def wrong(*args, **kw):
        gq, gk, gv, gt2, gt3 = frab(*args, **kw)
        if kind == "no g_t3":
            return gq, gk, gv, gt2, torch.zeros_like(gt3)
        return gq, gk, gv, torch.zeros_like(gt2), gt3
    return wrong


PLANTS = {"pallas_local": ("B2", planted_b2,
                           ("no bank gradient", "no t4 b_r term")),
          "pallas": ("B4", planted_b4, ("no g_t3", "no g_t2"))}


def loss_and_grads(model, arrays):
    """The loss and every parameter gradient of one batch, f32 on the
    CPU (train mode; the config has dropout 0)."""
    import torch

    from gtos_tpu_torch.models.generator import batch_to_device

    model.train()
    names, params = zip(*model.named_parameters())
    loss, _ = model(batch_to_device(arrays, model.device))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), {n: (torch.zeros_like(p) if g is None else g
                             ).float().cpu()
                         for n, p, g in zip(names, params, grads)}


def grad_gap(ref, got):
    """(loss gap, largest relative L2 gap over the parameters, its name):
    ||g - g_ref|| / ||g_ref|| per parameter tensor, over those whose
    reference gradient is above 1e-6 of the largest (the attention key
    biases of the decoder have a zero gradient in exact arithmetic)."""
    (ref_loss, rg), (loss, g) = ref, got
    top = max(x.norm().item() for x in rg.values())
    worst, name = 0.0, None
    for n, x in rg.items():
        scale = x.norm().item()
        if scale > 1e-6 * top:
            rel = (g[n] - x).norm().item() / scale
            if rel > worst or not np.isfinite(rel):
                worst, name = rel, n
    return abs(loss - ref_loss), worst, name


def phase_grads(impl="pallas_local", family="c2", grads=None, runs=1,
                tag=None):
    """The loss and every parameter gradient of one train batch (dropout
    0) under attention_impl `impl` on the card with the kernels, the f32
    model and the bf16 one, against the same f32 weights on the CPU with
    the plain versions; then the same with each planted wrong backward
    kernel (B2, or B4 under "pallas"), which must fail the check.
    grads(model, arrays): how the card computes them (default
    `loss_and_grads`; `captured_loss_and_grads` replays a CUDA graph),
    launching each kernel `runs` times."""
    import torch

    from gtos_tpu_torch.models import Generator

    tag = tag or tag_of("grads", impl, family)
    cfg, _ = configs(family)
    cfg = dataclasses.replace(cfg, dropout=0.0, attention_impl=impl)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    loader = train_loader(seed=3, impl=impl, family=family)
    batch = next(b for b in loader if b.concept_mask.shape[1] == 32)
    arrays = batch.arrays()
    weights = Generator(cfg, device="cpu",
                        rng=torch.Generator().manual_seed(4)).state_dict()
    models = {}
    for name, c, dev in (("cpu", f32, "cpu"), ("float32", f32, "cuda"),
                         ("bfloat16", cfg, "cuda")):
        models[name] = Generator(c, device=dev)
        models[name].load_state_dict(weights)
    t0 = time.perf_counter()
    ref = loss_and_grads(models["cpu"], arrays)
    print(f"[{tag}] batch {describe(batch)}; cpu f32 loss {ref[0]:.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    bwd, planted, kinds = PLANTS[impl]

    def check(dtype_name, what):
        zero_counts()
        got = (grads or loss_and_grads)(models[dtype_name], arrays)
        launches = read_counts()
        expect = train_expect(impl, models[dtype_name].cfg, [batch] * runs)
        if launches != expect:
            fail(f"the {dtype_name} gradient run launched {launches}, "
                 f"expected {expect}")
        dloss, rel, name = grad_gap(ref, got)
        tol = GRAD_TOL[dtype_name]
        ok = dloss <= tol["loss"] and rel <= tol["rel"]
        print(f"[{tag}] card {dtype_name} with {what} vs cpu f32: loss gap "
              f"{dloss:.4e}, largest relative gradient gap {rel:.4e} "
              f"({name}) (tol {tol}): " + ("within" if ok else "outside"),
              flush=True)
        return ok

    for dtype_name in ("float32", "bfloat16"):
        if not check(dtype_name, bwd):
            fail(f"the {dtype_name} {impl} model's loss and gradients on "
                 "the card disagree with the f32 CPU run")
    # the check passes when both runs are within their limits; a planted
    # backward kernel must make it fail
    for kind in kinds:
        with replaced(bwd, planted(kind)):
            passed = [check(dtype_name, f"planted {bwd} ({kind})")
                      for dtype_name in ("float32", "bfloat16")]
        if all(passed):
            fail(f"the gradient check passes a {bwd} with {kind}")


def phase_resume(impl="pallas_local", family="c2", tag=None):
    """The c2 model under attention_impl `impl` trained RESUME_AT steps,
    saved, restored into a fresh model and trainer and trained RESUME_MORE
    more, against the unbroken run of the same seeds: the losses of the
    resumed steps must be the same bits (B2 walks each slot's pairs, B4
    each run of bank rows, in a fixed order; no atomics). The Trainer runs
    its steps on CUDA graphs, so the resumed run replays where the
    unbroken one did not and the other way round."""
    from gtos_tpu_torch.train.checkpoint import CheckpointManager

    tag = tag or tag_of("resume", impl, family)
    cfg, tcfg = configs(family)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    total = RESUME_AT + RESUME_MORE
    tcfg = dataclasses.replace(tcfg, total_steps=total,
                               checkpoint_every=RESUME_AT)
    loader = functools.partial(train_loader, impl=impl, family=family)
    whole = StepLog(tag)
    new_trainer(cfg, tcfg, 5, log=whole, family=family).fit(
        loader(), log_every=1)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        ckpt = CheckpointManager(tmp, cfg, tcfg)
        new_trainer(cfg, dataclasses.replace(tcfg, total_steps=RESUME_AT),
                    5, ckpt=ckpt, log=StepLog(tag), family=family).fit(
                        loader(), log_every=1)
        cont = StepLog(tag)
        trainer = new_trainer(cfg, tcfg, 6, ckpt=CheckpointManager(
            tmp, cfg, tcfg), log=cont, family=family)
        if trainer.restore_if_available() != RESUME_AT:
            fail("restore did not find the checkpoint of step "
                 f"{RESUME_AT}")
        trainer.fit(loader(), log_every=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want, got = whole.losses()[RESUME_AT:], cont.losses()
    same = want == got
    path = trainer.step_path(next(iter(loader())).arrays())
    print(f"[{tag}] steps {RESUME_AT + 1}-{total}: unbroken {want}, "
          f"resumed {got}: " + ("bit-identical" if same else "DIFFER")
          + f"; the steps {path} ({trainer._step.graphs.replays} replays "
          "in the resumed run)", flush=True)
    if not same:
        fail("the resumed run's losses differ from the unbroken run's")
    if path == "captured" and trainer._step.graphs.replays == 0:
        fail("the resumed run replayed no graph")


def phase_localize(batches, D=512):
    """The backward of localize_bank at training batches' shapes (bank
    [P, D], bank_map [B, P_loc]): autograd of the plain gather (a sorted
    index_put with accumulation) against the port's training path, the
    sorted prefix sum over the batch's loc_perm/loc_bnd (the JAX
    package's form); they agree in f32 to 1e-4 and both are timed in
    bf16."""
    import torch

    from gtos_tpu_torch.ops.localize import localize_bank

    for i, batch in enumerate(batches):
        bm = torch.from_numpy(batch.bank_map).cuda()
        aux = (torch.from_numpy(batch.loc_perm).cuda(),
               torch.from_numpy(batch.loc_bnd).cuda())
        P = batch.rel_bank.shape[0]
        times = {}
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(i)
            rel = torch.randn(P, D, generator=gen, device="cuda").to(
                dtype).requires_grad_()
            g = torch.randn(*bm.shape, D, generator=gen,
                            device="cuda").to(dtype)
            gather = lambda: torch.autograd.grad(  # noqa: E731
                localize_bank(rel, bm), rel, g)[0]
            prefix = lambda: torch.autograd.grad(  # noqa: E731
                localize_bank(rel, bm, *aux), rel, g)[0]
            if dtype == torch.float32:
                try:
                    torch.testing.assert_close(gather(), prefix(),
                                               atol=1e-4, rtol=1e-4)
                except AssertionError as e:
                    fail(f"localize backward: the gather's and the sorted "
                         f"prefix sum's disagree: {e}")
            else:
                times = dict(gather=time_ms(gather), prefix=time_ms(prefix))
        print(f"[localize] backward, B={bm.shape[0]} P_loc={bm.shape[1]} "
              f"P={P} D={D} bf16: autograd of the gather "
              f"{times['gather']:.6f} ms, sorted prefix sum over "
              f"loc_perm/loc_bnd (the port's) {times['prefix']:.6f} ms",
              flush=True)


def capture_train_inputs(trainer, batches):
    """The arguments the training path hands B1p and B2: layer 0's (the
    first forward call, the last backward call) for each batch, from one
    more forward and backward per batch (`capture`)."""
    out = []
    for batch in batches:
        calls = capture(trainer.model, batch, True,
                        trainer.model.device)["calls"]
        (fwd, _), (bwd, kw) = calls["B1p"], calls["B2"]
        out.append((fwd[:7], (*bwd[:10], kw.get("runs"))))
    return out


def capture_global_inputs(model, batches, train):
    """The arguments the "pallas" path hands the global-bank kernels, for
    each batch: layer 0's forward (B3's tables or B3''s banks, whichever
    the batch's bank takes) and, with train, layer 0's backward (B4, the
    last call), from one more encode (serving) or forward and backward
    (training) per batch (`capture`). Returns (kernel, forward arguments,
    B4 arguments or None) per batch."""
    out = []
    for batch in batches:
        calls = capture(model, batch, train, model.device)["calls"]
        kern = B3 if "B3" in calls else B3I
        fwd = calls["B3" if kern == B3 else "B3'"][0]
        out.append((kern, fwd[:7], calls["B4"][0][:10] if train else None))
    return out


def phase_auto():
    """attention_impl "auto" on the c2 model: Trainer.fit on batches of
    both routes (the auto loader's first AUTO_STEPS_PER_ROUTE batches,
    which carry local banks and so take the localized route under the
    card's AUTO_LOCAL_RATIO, and as many of the "pallas" loader's, which
    carry none and take the global one), each printed with its route, P
    and P_loc, and the launches of that run; then, for one batch of each
    route, the loss under "auto" against the loss under the fixed route
    (dropout off, the same weights): the same bits; then serving under
    "auto"."""
    import torch

    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device

    cfg, tcfg = configs()
    cfg = dataclasses.replace(cfg, attention_impl="auto")
    local, glob = ([b for _, b in zip(range(AUTO_STEPS_PER_ROUTE),
                                      train_loader(impl=impl))]
                   for impl in ("auto", "pallas"))
    plan = [b for pair in zip(local, glob) for b in pair]
    for i, batch in enumerate(plan):
        route, kern = route_of("auto", batch.arrays(), cfg)
        print(f"[auto] step {i + 1} batch: {describe(batch)} -> route "
              f"{route} ({kern})")
        if route != ("pallas_local", "pallas")[i % 2]:
            fail(f"auto routed batch {i} ({describe(batch)}) to {route}")
    log = StepLog("auto", every=1)
    trainer = new_trainer(cfg, dataclasses.replace(
        tcfg, total_steps=len(plan), checkpoint_every=10 ** 9), 0, log=log)
    zero_counts()
    trainer.fit(plan, log_every=1)
    torch.cuda.synchronize()
    launches = read_counts()
    expect = train_expect("auto", cfg, plan)
    if trainer.step != len(plan) or launches != expect:
        fail(f"auto training launched {launches}, expected {expect}")
    if not all(np.isfinite(log.losses())):
        fail(f"non-finite auto training loss: {log.losses()}")
    print(f"[auto] {len(plan)} steps, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)

    model = Generator(dataclasses.replace(cfg, dropout=0.0), device="cuda",
                      rng=torch.Generator().manual_seed(7)).train()
    for batch in (local[0], glob[0]):
        arrays = batch_to_device(batch.arrays(), "cuda")
        route = route_of("auto", batch.arrays(), cfg)[0]
        losses = []
        for impl in ("auto", route):
            model.cfg = dataclasses.replace(model.cfg, attention_impl=impl)
            losses.append(model(arrays)[0].item())
        same = losses[0] == losses[1]
        print(f"[auto] loss of a {route} batch ({describe(batch)}): auto "
              f"{losses[0]!r}, fixed {route} {losses[1]!r}: "
              + ("bit-identical" if same else "DIFFER"), flush=True)
        if not same:
            fail(f"the auto loss of a {route} batch differs from the fixed "
                 "route's")
    del model, trainer
    torch.cuda.empty_cache()
    phase_auto_tiles()
    phase_serve("auto")


def penman(graph) -> str:
    """A synthetic Graph as PENMAN text: a depth-first walk from node 0
    over its out-edges, a variable per node, an edge to a node already
    written as that node's variable."""
    out = {}
    for src, label, tgt in graph.edges:
        out.setdefault(src, []).append((label, tgt))
    seen = set()

    def node(i):
        seen.add(i)
        parts = [f"(n{i} / {graph.nodes[i]}"]
        for label, tgt in out.get(i, []):
            parts.append(f":{label} " + (f"n{tgt}" if tgt in seen
                                         else node(tgt)))
        return " ".join(parts) + ")"

    return node(0)


def run_cli(tag, cmd):
    """A CLI as a subprocess from the repo root; its stderr's last line
    and its wall time printed. Returns the completed process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *cmd], cwd=ROOT, env=env,
                         capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"{cmd[0]} failed:\n{res.stderr[-3000:]}")
    print(f"[{tag}] {' '.join(cmd)}: "
          f"{res.stderr.strip().splitlines()[-1]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


def phase_work():
    """The CLIs a user runs, as subprocesses on the card: the train CLI
    with the c2 config under "auto" on WORK_SYNTHETIC synthetic instances
    for WORK_STEPS steps writes a checkpoint; the work CLI rebuilds the
    model from that directory alone and decodes a PENMAN file of
    WORK_GRAPHS synthetic graphs written here (beam 8), printing BLEU and
    chrF. One hypothesis per graph; in corpus order, which a second, in
    process run checks with a decode that answers each graph's own
    sentence (the output must be the references, in file order)."""
    import re

    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.infer import work

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_work_", dir=ROOT)
    try:
        ckpt, sembank, output = (os.path.join(tmp, n) for n in (
            "ckpt", "test.amr", "hyps.txt"))
        run_cli("work", [
            "gtos_tpu_torch.train.train", "--config", "configs/c2_amr2.json",
            "--attention_impl", "auto", "--synthetic", str(WORK_SYNTHETIC),
            "--total_steps", str(WORK_STEPS), "--ckpt_dir", ckpt])
        graphs, targets = synthetic_amr_corpus(WORK_GRAPHS, seed=7)
        refs = [" ".join(t) for t in targets]
        with open(sembank, "w") as f:
            for i, (g, ref) in enumerate(zip(graphs, refs)):
                f.write(f"# ::id s{i} ::snt {ref}\n{penman(g)}\n\n")
        args = ["--ckpt_dir", ckpt, "--test_data", sembank, "--output",
                output, "--max_time_step", "32"]
        res = run_cli("work", ["gtos_tpu_torch.infer.work", *args,
                               "--eval_bleu", "--eval_chrf"])
        scores = dict(re.findall(r"^(BLEU|chrF) = ([0-9.]+)$", res.stderr,
                                 re.M))
        with open(output) as f:
            hyps = f.read().splitlines()
        print(f"[work] {len(hyps)} hypotheses for {len(graphs)} graphs, "
              f"BLEU {scores.get('BLEU')}, chrF {scores.get('chrF')}; "
              f"first: {hyps[0][:60]!r}", flush=True)
        if len(hyps) != len(graphs) or set(scores) != {"BLEU", "chrF"}:
            fail("the work CLI must write one hypothesis per graph and "
                 "print BLEU and chrF")

        def answer(model, batch, tv, **kw):  # each graph's own sentence
            return [m["snt"].split() for m in batch.meta]

        from gtos_tpu_torch.infer import decode
        real, decode.decode_batch = decode.decode_batch, answer
        try:
            bleu = work.main(args + ["--eval_bleu"])
        finally:
            decode.decode_batch = real
        with open(output) as f:
            ordered = f.read().splitlines() == refs
        print(f"[work] corpus order: a decode that answers each graph's "
              f"sentence gives BLEU {bleu:.2f} and the references in file "
              f"order: {'yes' if ordered else 'no'}", flush=True)
        if not ordered or abs(bleu - 100.0) > 1e-6:
            fail("the work CLI does not write hypotheses in corpus order")

        # the c5 model under the block-sparse tier, on one card
        ckpt5, out5 = os.path.join(tmp, "ckpt5"), os.path.join(tmp, "h5.txt")
        run_cli("work", [
            "gtos_tpu_torch.train.train", "--config",
            "configs/c5_scaled_synthetic.json", "--attention_impl",
            "block_sparse", "--graph", "1", "--dp", "0", "--synthetic",
            str(WORK_SYNTHETIC), "--total_steps", str(WORK_STEPS),
            "--ckpt_dir", ckpt5])
        res = run_cli("work", [
            "gtos_tpu_torch.infer.work", "--ckpt_dir", ckpt5, "--test_data",
            sembank, "--output", out5, "--max_time_step", "32",
            "--eval_bleu", "--eval_chrf"])
        with open(out5) as f:
            hyps = f.read().splitlines()
        scores = dict(re.findall(r"^(BLEU|chrF) = ([0-9.]+)$", res.stderr,
                                 re.M))
        print(f"[work] c5: {len(hyps)} hypotheses for {len(graphs)} graphs, "
              f"BLEU {scores.get('BLEU')}, chrF {scores.get('chrF')}",
              flush=True)
        if len(hyps) != len(graphs) or set(scores) != {"BLEU", "chrF"}:
            fail("the work CLI on the c5 checkpoint must write one "
                 "hypothesis per graph and print BLEU and chrF")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- c4


def describe_loader(tag, loader):
    """One epoch of a loader per node bucket N: its batches, the sentences
    in them, the batch sizes B (padded) and the instances per batch, the
    bank P (padded) and the rows in use, and P_loc, after the
    bank-overflow bisect."""
    shapes = {}
    for batch, insts in loader.iter_with_instances():
        B, N = batch.concept_mask.shape
        shapes.setdefault(N, []).append(
            (B, len(insts), batch.rel_bank.shape[0],
             int((batch.rel_length > 0).sum()) + 1,
             batch.bank_map.shape[1]))
    for N, rows in sorted(shapes.items()):
        col = lambda i: sorted({r[i] for r in rows})  # noqa: E731
        print(f"[{tag}] node bucket N={N}: {len(rows)} batches, "
              f"{sum(r[1] for r in rows)} sentences; B {col(0)}, "
              f"sentences per batch {min(col(1))}-{max(col(1))}; P "
              f"{col(2)}, bank rows in use {min(col(3))}-{max(col(3))}; "
              f"P_loc {min(col(4))}-{max(col(4))}", flush=True)


def phase_c4(profile=False):
    """The c4 translator (configs/c4_nmt_ende.json at full width: no copy,
    node positions) under "pallas_local" on C4_GRAPHS synthetic dependency
    trees of C4_LENGTHS tokens: the train loader's batch shapes, serving
    the fullest batch of each node bucket (B1 = enc_layers per batch, no
    other kernel), the encoder against f32 on the CPU with the planted
    B1s, TRAIN_STEPS training steps (B1p = B2 = enc_layers per step), the
    loss and every gradient against f32 on the CPU with the planted B2s,
    a bit-identical resume, and B1, B1p and B2 on c4's own inputs: the
    JSON line's rows of model "c4". With `profile`, one more profiled step
    on each captured train batch."""
    import torch

    describe_loader("c4 loader", train_loader(family="c4"))
    cfg, model, _, batches, _, serve_launches = phase_serve(family="c4")
    phase_encoder_check(cfg, model, batches[0], tag="c4 encode")
    b1_inputs = capture_b1_inputs(model, batches)
    del model
    torch.cuda.empty_cache()
    trainer, ms_step, train_launches, _ = phase_train(family="c4")
    captured = [b for _, b in zip(range(CAPTURE_BATCHES),
                                  train_loader(family="c4"))]
    train_inputs = capture_train_inputs(trainer, captured)
    if profile:
        for i, batch in enumerate(captured):
            phase_profile_train(trainer, ms_step, batch=batch,
                                label=f"c4 pallas_local train step {i + 1}")
    del trainer
    torch.cuda.empty_cache()
    phase_grads(family="c4")
    phase_resume(family="c4")
    torch.cuda.empty_cache()
    return phase_main_shapes(b1_inputs, serve_launches, train_inputs,
                             train_launches, "c4")


def conll(graph) -> str:
    """A dependency Graph as CoNLL lines `idx token head deprel` (head 0
    and the label "root" for the token without a head)."""
    heads = {t: (src, label) for src, label, t in graph.edges}
    rows = []
    for i, tok in enumerate(graph.nodes):
        h, label = heads.get(i, (-1, "root"))
        rows.append(f"{i + 1}\t{tok}\t{h + 1}\t{label}")
    return "\n".join(rows)


def phase_work_nmt():
    """The translator's CLIs as subprocesses on the card: the train CLI
    with configs/c4_nmt_ende.json on a CoNLL file and its target file
    (WORK_SYNTHETIC synthetic trees of C4_LENGTHS tokens; dev: 48 more)
    for WORK_STEPS steps, its batches built by 4 worker processes, writes
    a checkpoint; the work CLI rebuilds the model from it and decodes
    WORK_GRAPHS of the training sentences as a CoNLL test file with
    --test_target (beam 8), printing BLEU and chrF. One hypothesis per
    sentence, in file order, which a second, in-process run checks with
    a decode that answers each sentence's reference, spelled from its
    batch's token_out."""
    import re

    from gtos_tpu_torch.infer import decode, work

    graphs, targets = raw_corpus("c4", seed=7, n=WORK_SYNTHETIC + 48)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_nmt_", dir=ROOT)
    try:
        def write(name, sl):
            with open(os.path.join(tmp, f"{name}.conll"), "w") as f:
                f.write("\n\n".join(conll(g) for g in graphs[sl]) + "\n")
            with open(os.path.join(tmp, f"{name}.tgt"), "w") as f:
                f.writelines(" ".join(t) + "\n" for t in targets[sl])
            return os.path.join(tmp, name)

        train = write("train", slice(0, WORK_SYNTHETIC))
        dev = write("dev", slice(WORK_SYNTHETIC, None))
        # training sentences: every target word is in the token vocab, so
        # token_out spells each reference
        test = write("test", slice(0, WORK_GRAPHS))
        refs = [" ".join(t) for t in targets[:WORK_GRAPHS]]
        ckpt, output = os.path.join(tmp, "ckpt"), os.path.join(tmp, "h.txt")
        run_cli("work nmt", [
            "gtos_tpu_torch.train.train", "--config",
            "configs/c4_nmt_ende.json", "--task", "nmt", "--train_data",
            train + ".conll", "--train_target", train + ".tgt",
            "--dev_data", dev + ".conll", "--dev_target", dev + ".tgt",
            "--total_steps", str(WORK_STEPS), "--batchify_workers", "4",
            "--ckpt_dir", ckpt])
        args = ["--ckpt_dir", ckpt, "--task", "nmt", "--test_data",
                test + ".conll", "--test_target", test + ".tgt", "--output",
                output, "--max_time_step", "32"]
        res = run_cli("work nmt", ["gtos_tpu_torch.infer.work", *args,
                                   "--eval_bleu", "--eval_chrf"])
        scores = dict(re.findall(r"^(BLEU|chrF) = ([0-9.]+)$", res.stderr,
                                 re.M))
        with open(output) as f:
            hyps = f.read().splitlines()
        print(f"[work nmt] {len(hyps)} hypotheses for {WORK_GRAPHS} "
              f"sentences, BLEU {scores.get('BLEU')}, chrF "
              f"{scores.get('chrF')}; first: {hyps[0][:60]!r}", flush=True)
        if len(hyps) != WORK_GRAPHS or set(scores) != {"BLEU", "chrF"}:
            fail("the nmt work CLI must write one hypothesis per sentence "
                 "and print BLEU and chrF")

        def answer(model, batch, tv, **kw):  # each sentence's reference
            out = []
            for row in batch.token_out[: len(batch.meta)].tolist():
                out.append([tv.itos[i] for i in row[: row.index(
                    tv.end_id)]])
            return out

        real, decode.decode_batch = decode.decode_batch, answer
        try:
            bleu = work.main(args + ["--eval_bleu"])
        finally:
            decode.decode_batch = real
        with open(output) as f:
            ordered = f.read().splitlines() == refs
        print(f"[work nmt] file order: a decode that answers each "
              f"sentence's reference gives BLEU {bleu:.2f} and the "
              f"references in file order: {'yes' if ordered else 'no'}",
              flush=True)
        if not ordered or abs(bleu - 100.0) > 1e-6:
            fail("the nmt work CLI does not write hypotheses in file order")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- host


def epoch_digests(loader):
    """One epoch of a loader: per batch, a digest of every array (name,
    dtype, shape, bytes) and of its instances; the seconds it took."""
    import hashlib

    t0 = time.perf_counter()
    out = []
    for batch, insts in loader.iter_with_instances():
        h = hashlib.sha256(repr([i.orig_index for i in insts]).encode())
        for k, v in sorted(batch.arrays().items()):
            h.update(f"{k} {v.dtype} {v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        out.append(h.hexdigest())
    return out, time.perf_counter() - t0


def phase_host():
    """Host numbers of the card machine, with its CPU count: the native
    extractor's build (it must build: a failed build fails the phase);
    preprocess ms per graph with the native extractor and with the Python
    BFS on the c2 and c4 corpora, the two giving the same PackedPaths
    (per graph the same pair_idx and interned ids, one path table); two
    epochs of each family's train loader at workers 0, 2 and 4 (process)
    and 4 (thread), ms per batch, every array of every batch equal to
    workers=0's; 10 c2 training steps from a 4-worker loader (its pool
    created in the trainer's prefetch thread, after the CUDA context)
    with the same losses, bit for bit, as from a loader without
    workers."""
    import torch

    from gtos_tpu_torch import native
    from gtos_tpu_torch.data import dataloader
    from gtos_tpu_torch.graph.paths import pack_relation_paths

    host = f"host of {card_line()}, os.cpu_count() {os.cpu_count()}"
    try:
        native.load()
    except (OSError, RuntimeError) as e:
        fail(f"the native path extractor does not load: {e}")
    print(f"[host] {host}; native extractor "
          f"{native.library_path().name} (built in the build phase)",
          flush=True)
    real_packer = dataloader._path_packer
    for family in ("c2", "c4"):
        graphs, targets = raw_corpus(family)
        runs = {}
        for name in ("native", "python"):
            if name == "python":
                dataloader._path_packer = lambda: ("python",
                                                   pack_relation_paths)
            try:
                t0 = time.perf_counter()
                runs[name] = dataloader.preprocess(graphs, targets)
                ms = (time.perf_counter() - t0) * 1e3 / len(graphs)
            finally:
                dataloader._path_packer = real_packer
            if dataloader.EXTRACTOR != name:
                fail(f"preprocess ran the {dataloader.EXTRACTOR} extractor, "
                     f"{name} expected")
            runs[name + "_ms"] = ms
        same = (runs["native"][0].pair_paths.interner.paths
                == runs["python"][0].pair_paths.interner.paths
                and all(np.array_equal(a.pair_paths.pair_idx,
                                       b.pair_paths.pair_idx)
                        and np.array_equal(a.pair_paths.uniq_gid,
                                           b.pair_paths.uniq_gid)
                        for a, b in zip(runs["native"], runs["python"])))
        nodes = sum(g.num_nodes for g in graphs) / len(graphs)
        print(f"[host] {family} preprocess of {len(graphs)} graphs "
              f"({nodes:.1f} nodes each): native {runs['native_ms']:.4f} "
              f"ms/graph, python {runs['python_ms']:.4f} ms/graph "
              f"({runs['python_ms'] / runs['native_ms']:.2f}x); the same "
              f"PackedPaths: {'yes' if same else 'NO'} ({host})", flush=True)
        if not same:
            fail(f"the native and Python extractors differ on {family}")

        ref = None
        for workers, mode in ((0, "process"), (2, "process"),
                              (4, "process"), (4, "thread")):
            loader = train_loader(family=family, workers=workers,
                                  worker_mode=mode)
            try:
                got = [epoch_digests(loader) for _ in range(2)]
            finally:
                loader.close()
            digests = [d for d, _ in got]
            ref = ref or digests
            n = len(digests[0])
            kind = f"workers={workers}" + (f" {mode}" if workers else "")
            print(f"[host] {family} train loader, {kind}: "
                  f"{n} batches an epoch; epoch 1 (with the pool's start) "
                  f"{got[0][1] * 1e3 / n:.3f} ms/batch, epoch 2 "
                  f"{got[1][1] * 1e3 / len(digests[1]):.3f} ms/batch; every "
                  f"array equal to workers=0's: "
                  f"{'yes' if digests == ref else 'NO'} ({host})", flush=True)
            if digests != ref:
                fail(f"the {family} loader with {workers} {mode} workers "
                     "gives other batches than without workers")

    cfg, tcfg = configs()
    tcfg = dataclasses.replace(tcfg, total_steps=10,
                               checkpoint_every=10 ** 9)
    losses = {}
    for workers in (0, 4):
        log = StepLog(f"host fit workers={workers}")
        loader = train_loader(workers=workers)
        try:
            t0 = time.perf_counter()
            new_trainer(cfg, tcfg, 0, log=log).fit(loader, log_every=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            loader.close()
        losses[workers] = log.losses()
        print(f"[host] c2 Trainer.fit, 10 steps, batchify workers={workers}: "
              f"{wall:.3f} s", flush=True)
    same = losses[0] == losses[4] and len(losses[0]) == 10
    print(f"[host] c2 losses with 4 workers {losses[4]}, without "
          f"{losses[0]}: " + ("bit-identical" if same else "DIFFER"),
          flush=True)
    if not same:
        fail("training from a 4-worker loader gives other losses")
    torch.cuda.empty_cache()


def phase_batch_multiple():
    """One c2 train batch of 16 graphs loaded with batch_multiple=3 (B
    padded to 18, not a power of two) and without (B=16): B1p and B2
    launch enc_layers times each on the padded batch, and its loss
    (dropout 0, the same weights; the bf16 c2 model and the same weights
    in f32) equals the unpadded batch's within 1e-6 relative. The largest
    relative gradient gap is printed beside it, not gated: the padded
    rows change the GEMM shapes, so the sums run in another order."""
    import torch

    from gtos_tpu_torch.models import Generator

    cfg, _ = configs()
    cfg = dataclasses.replace(cfg, dropout=0.0)
    pair = next(((a, b) for a, b in zip(train_loader(),
                                        train_loader(batch_multiple=3))
                 if a.concept.shape[0] == 16), None)
    if pair is None:
        fail("the c2 train loader has no batch of B=16")
    plain, padded = pair
    if (padded.concept.shape[0] != 18
            or not np.array_equal(padded.concept[:16], plain.concept)):
        fail(f"batch_multiple=3 gave B={padded.concept.shape[0]}, 18 "
             "expected, or other rows")
    weights = Generator(cfg, device="cpu",
                        rng=torch.Generator().manual_seed(8)).state_dict()
    for dtype_name in ("bfloat16", "float32"):
        model = Generator(dataclasses.replace(cfg, compute_dtype=dtype_name),
                          device="cuda")
        model.load_state_dict(weights)
        ref = loss_and_grads(model, plain.arrays())
        zero_counts()
        got = loss_and_grads(model, padded.arrays())
        launches = read_counts()
        expect = train_expect("pallas_local", model.cfg, [padded])
        rel = abs(got[0] - ref[0]) / abs(ref[0])
        _, grad_rel, name = grad_gap(ref, got)
        print(f"[batch_multiple] {dtype_name}: c2 batch of "
              f"{int(plain.concept_mask[:, 0].sum())} graphs "
              f"({describe(plain)}) padded to B=18: loss {got[0]!r} vs "
              f"{ref[0]!r} at B=16, relative gap {rel:.3e} (tol 1e-6); "
              f"largest relative gradient gap {grad_rel:.3e} ({name}); "
              f"launches { {k: v for k, v in launches.items() if v} }",
              flush=True)
        if launches != expect:
            fail(f"the B=18 batch launched {launches}, expected {expect}")
        if not rel <= 1e-6:
            fail("the padded batch's loss differs from the unpadded one's")
        del model
    torch.cuda.empty_cache()


def phase_profile_train(trainer, ms_step, impl="pallas_local", batch=None,
                        label=None):
    """Where a train step's time goes (--profile): torch.profiler over one
    more step on `batch` (default: a train batch of the `impl` loader), its
    device busy time, the idle share against the unprofiled mean step time
    of the train phase, the busiest kernels, the share of device time of
    each hand-written block-sparse kernel that ran, under "pallas_local"
    `local_shares` and under "pallas" `global_shares`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gtos_tpu_torch.models.generator import batch_to_device

    if batch is None:
        batch = next(iter(train_loader(impl=impl)))
    arrays = batch_to_device(batch.arrays(), "cuda")
    trainer.train_step(arrays)                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step(arrays)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=impl == "pallas_local") as prof:
        trainer.train_step(arrays)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        fail("the profiler recorded no device time")
    label = label or f"{impl} train step"
    if impl == "pallas_local":
        local_shares(prof, dev, busy_ms, arrays, trainer.model.cfg.d_model)
    if impl == "pallas":
        global_shares(dev, busy_ms)
    print(f"[profile] {label} (B={batch.concept_mask.shape[0]} "
          f"N={batch.concept_mask.shape[1]} T={batch.token_in.shape[1]}): "
          f"device busy {busy_ms:.3f} ms; idle share {1 - busy_ms / wall:.4f}"
          f" of this step's {wall:.3f} ms wall, {1 - busy_ms / ms_step:.4f} "
          f"of the train phase's mean {ms_step:.3f} ms/step; "
          f"{sum(e.count for e in dev)} device kernels/copies", flush=True)
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:90]}")
    for e in dev:
        if "blk_" in e.key:
            print(f"[profile]   block-sparse kernel "
                  f"{e.self_device_time_total / 1e3:.3f} ms "
                  f"({e.self_device_time_total / 1e3 / busy_ms:.4f} of "
                  f"device busy) {e.count}x {e.key[:110]}")


# the global-bank kernels' names in a profile: this tree's (rel_attn_fwd_
# tables, rel_attn_fwd_inline, rel_bwd_rows/_cols) and those of the
# earlier sources (one forward template, B3 its <T, false> and B3' its
# <T, true> instance; rel_attn_bwd_kernel), so that one profile reads a
# checkout of either
GLOBAL_PROFILE_KEYS = {
    "B3": (("rel_attn_fwd_tables",), ("rel_attn_fwd_kernel", "false>")),
    "B3'": (("rel_attn_fwd_inline",), ("rel_attn_fwd_kernel", "true>")),
    "B4": (("rel_bwd_",), ("rel_attn_bwd_kernel",))}


def global_shares(dev, busy_ms):
    """Prints, for a profiled "pallas" train step, the device time, share
    of device busy and launches of B3, B3' and B4 (their kernels)."""
    for name, patterns in GLOBAL_PROFILE_KEYS.items():
        found = [e for e in dev
                 if any(all(p in e.key for p in pat) for pat in patterns)]
        ms = sum(e.self_device_time_total for e in found) / 1e3
        print(f"[profile]   {name}: {ms:.3f} ms ({ms / busy_ms:.4f} of device "
              f"busy), {sum(e.count for e in found)} launches", flush=True)


def local_shares(prof, dev, busy_ms, arrays, D):
    """Prints, for a profiled "pallas_local" train step, the device time
    and share of device busy of B1p (its kernel), of B2 (its kernels) and
    of the copies around them: `contiguous` calls on a [B, P_loc, H, Dh]
    bank half, the slice backward into a [B, P_loc, 2 D] bank gradient and
    the add of two such gradients (what a layer that copies a and b out
    of its bank projection adds to a step). Then B2's work list
    (`bank_runs`, built once per encoder stack, so once a step, where the
    checkout has it) profiled alone on the step's batch: its device time,
    device kernels and the host time to issue it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gtos_tpu_torch.ops import local_relation_attention as lra

    B, P_loc = arrays["bank_map"].shape
    kernels = {"B1p": ("local_rel_attn_fwd", "local_fwd<"),
               "B2": ("local_rel_attn_bwd", "local_bwd_")}
    for name, keys in kernels.items():
        found = [e for e in dev if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in found) / 1e3
        print(f"[profile]   {name}: {ms:.3f} ms ({ms / busy_ms:.4f} of device "
              f"busy), {sum(e.count for e in found)} launches", flush=True)

    def is_copy(e):
        s = list((e.input_shapes or [[]])[0])
        if s[:2] != [B, P_loc]:
            return False
        return ((e.name == "aten::contiguous" and len(s) == 4
                 and s[2] * s[3] == D)
                or (e.name == "aten::slice_backward" and s[2:] == [D])
                or (e.name == "aten::add" and s[2:] == [2 * D]))

    copies = [e for e in prof.events() if is_copy(e)]
    ms = sum(e.device_time_total for e in copies) / 1e3
    print(f"[profile]   copies of the bank halves a/b and their slice "
          f"backward: {ms:.3f} ms ({ms / busy_ms:.4f} of device busy), "
          f"{len(copies)} ops", flush=True)

    if not hasattr(lra, "bank_runs"):
        print("[profile]   bank_runs: not in this checkout", flush=True)
        return
    idx = arrays["rel_index_loc"]
    start = lra.slot_order(idx, P_loc)[1]
    runs = lambda: lra.bank_runs(start, idx.shape[1])  # noqa: E731
    runs()
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        runs()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as alone:
        runs()
        torch.cuda.synchronize()
    found = [e for e in alone.key_averages()
             if e.device_type == DeviceType.CUDA]
    ms = sum(e.self_device_time_total for e in found) / 1e3
    print(f"[profile]   bank_runs, once a step (profiled alone on this "
          f"batch): {ms:.3f} ms device ({ms / busy_ms:.4f} of the step's "
          f"device busy), {sum(e.count for e in found)} device kernels/"
          f"copies, {host_ms:.3f} ms host time to issue", flush=True)


# ------------------------------------- block-sparse kernels B5, B5s and B6


def block_batch(n_graphs, seed, min_nodes, max_nodes, N, khop):
    """A batch with the block-sparse tile layouts from the port's batchify
    on the synthetic AMR corpus, at node bucket N and sparse_khop khop."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus

    graphs, targets = synthetic_amr_corpus(
        n_graphs, seed=seed, min_nodes=min_nodes, max_nodes=max_nodes)
    spec = BucketSpec(**dict(C5_SPEC, nodes=(N,)))
    return batchify(preprocess(graphs, targets),
                    *build_vocabs(graphs, targets), batch_size_bucket=n_graphs,
                    for_train=True, spec=spec, build_block_tiles=True,
                    sparse_khop=khop)


def block_inputs(batch, H, Dh, dtype, seed=0):
    """Seeded q, k, v [B, H, N, Dh] and banks [P, H, Dh] on the card in
    `dtype` with the batch's tile layouts: B5's arguments; the src-major
    layout; and a cotangent of the input type."""
    import torch

    B, N = batch.concept_mask.shape
    P = batch.rel_bank.shape[0]
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    dev = lambda x: x.to(device="cuda", dtype=dtype).contiguous()  # noqa
    idx = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    return ((dev(rnd(B, H, N, Dh)), dev(rnd(B, H, N, Dh)),
             dev(rnd(B, H, N, Dh)), dev(rnd(P, H, Dh) * 0.5),
             dev(rnd(P, H, Dh) * 0.5), idx(batch.tile_src),
             idx(batch.tile_rel)),
            (idx(batch.tile_dst), idx(batch.tile_rel_src)),
            dev(rnd(B, H, N, Dh)))


def _block_line(kernel, label, q, P, E, dtype_name, err, bound, ms, plain_ms):
    B, H, N, Dh = q.shape
    print(f"[kernel] {kernel} {label} B={B} H={H} N={N} Dh={Dh} P={P} "
          f"pairs={E} {dtype_name}: max_abs_err={err:.3e} (tol "
          f"{KERNEL_TOL[dtype_name]}) bound={bound[0]:.6f} ms ({bound[1]}) "
          f"kernel={ms:.6f} ms plain={plain_ms:.6f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1])


def check_b5(label, args, with_stats=False):
    """B5's (with_stats: B5s's) wrapper against its plain version on the
    same inputs (B5s: the statistics m, l at PROBS_TOL), then both timed;
    returns its numbers."""
    import torch

    from gtos_tpu_torch.ops import block_sparse_attention as bsa

    q, P = args[0], args[3].shape[0]
    dtype_name = _dtype_name(q)
    t4 = bsa.bank_t4(args[3], args[4])
    kern = (bsa.block_sparse_attention_with_stats if with_stats
            else bsa.block_sparse_attention)
    plain = (bsa.block_sparse_attention_with_stats_reference if with_stats
             else bsa.block_sparse_attention_reference)
    got, ref = kern(*args, t4=t4), plain(*args, t4=t4)
    torch.cuda.synchronize()
    name = "B5s" if with_stats else "B5"
    if with_stats:
        for what, x, y in (("m", got[1], ref[1]), ("l", got[2], ref[2])):
            try:
                torch.testing.assert_close(x, y, **PROBS_TOL)
            except AssertionError as e:
                fail(f"{name} {label} {dtype_name}: {what} disagrees with its "
                     f"plain version: {e}")
        got, ref = got[0], ref[0]
    err = _compare(name, label, dtype_name, [("out", got, ref)])
    E = bsa.tile_pairs(args[5], args[6], q.shape[2], P)[3].numel()
    bound = block_bound(name, args)
    ms = time_ms(lambda: kern(*args, t4=t4), bound_ms=bound[0])
    plain_ms = time_ms(lambda: plain(*args, t4=t4))
    return _block_line(name, label, q, P, E, dtype_name, err, bound, ms,
                       plain_ms)


def b6_args(args, src, g):
    """B6's inputs for B5's: t4, gp, the forward's m, l and delta (from
    B5s's plain version), and the backward plan (src: the src-major
    layout)."""
    from gtos_tpu_torch.ops import block_sparse_attention as bsa
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
        backward_plan, pair_capacity, prep_bwd_invariants)

    q, a, b = args[0], args[3], args[4]
    t4 = bsa.bank_t4(a, b)
    out, m, l = bsa.block_sparse_attention_with_stats_reference(*args, t4=t4)
    gp, delta = prep_bwd_invariants(q, g, out)
    plan = backward_plan(args[5], args[6], *src, q.shape[2], a.shape[0],
                         pair_capacity(args[6]))
    return (*args[:5], t4, gp, m, l, delta), plan


RUN_BINS = ((1, 1), (2, 8), (9, 32), (33, 128), (129, 1024), (1025, None))


def run_histogram(plan, P):
    """The bank-row runs of a backward plan: per length bin, the runs and
    their pairs, and the distinct rows R against P (what sets B6b's
    time)."""
    import torch

    from gtos_tpu_torch.ops.block_sparse_attention_bwd import real_pairs

    r = real_pairs(plan)[3]
    lens = torch.unique(r, return_counts=True)[1].cpu().numpy()
    bins = []
    for lo, hi in RUN_BINS:
        sel = (lens >= lo) & (lens <= (hi or lens.max(initial=0)))
        bins.append(f"{lo}-{hi or 'inf'}: {int(sel.sum())} runs "
                    f"{int(lens[sel].sum())} pairs")
    return (f"R={len(lens)} of P={P} rows, E={int(lens.sum())} pairs, "
            f"longest {int(lens.max(initial=0))}; " + "; ".join(bins))


def check_b6(label, args, src, g=None, bwd=None):
    """B6d, B6s and B6b against their plain versions on the same inputs
    (dq and ge; dk and dv; g_a and g_b, and bank row by bank row against
    the plain B6b on B6d's ge, after work_list_covers holds the plan's
    work list), each giving the same bits on a
    second launch (no atomics; B6d's pair_s too), then each timed with its
    plain version (B6s reading the first B6d launch's pair_s); returns the
    three kernels' numbers. bwd: (B6 inputs, plan) as a training step gave
    them, else built from g."""
    import torch

    from gtos_tpu_torch.ops import block_sparse_attention_bwd as bwd_mod

    core, plan = bwd if bwd is not None else b6_args(args, src, g)
    q, k, a, b = core[0], core[1], core[3], core[4]
    ts, tr = args[5], args[6]
    dtype_name = _dtype_name(q)
    P, E = a.shape[0], int(plan["E"])
    dst = lambda: bwd_mod.block_sparse_attention_bwd_dst(  # noqa: E731
        *core, ts, tr, plan)
    srcp = lambda pair_s: bwd_mod.block_sparse_attention_bwd_src(  # noqa
        *core, *src, plan, pair_s)
    # B6d's ge and pair_s are [H, E_cap]: their E real columns
    cut = lambda o: (o[0], o[1][:, :E], o[2][:, :E])  # noqa: E731
    first, again = [], []
    for run in (first, again):
        run.append(dst())
        run.append(srcp(run[0][2]))
    pair_s = first[0][2]
    first[0], again[0] = cut(first[0]), cut(again[0])
    if not torch.equal(first[0][2], again[0][2]):
        fail(f"B6d {label} {dtype_name}: pair_s differs between two launches "
             "on the same inputs")
    ge = torch.zeros(q.shape[1], plan["cap"], device=q.device)
    ge[:, :E] = first[0][1]
    bank = lambda: bwd_mod.block_sparse_bank_grads(  # noqa: E731
        q, k, a, b, ge, plan)
    banks = (bank(), bank())
    ref_dst = bwd_mod.block_sparse_attention_bwd_dst_reference(*core, ts, tr)
    ref_src = bwd_mod.block_sparse_attention_bwd_src_reference(*core, *src)
    ref_bank = bwd_mod.block_sparse_bank_grads_reference(
        q, k, a, b, ref_dst[1], plan)
    torch.cuda.synchronize()
    print(f"[kernel] B6b {label} bank-row runs: {run_histogram(plan, P)}",
          flush=True)
    if not bool(bwd_mod.work_list_covers(plan, P)):
        fail(f"B6b {label}: the work list does not cover each real place "
             "once with its own bank row")
    rows = {}
    for kernel, names, got, twice, ref, fn, plain in (
            ("B6d", ("dq", "ge"), first[0], again[0], ref_dst, dst,
             lambda: bwd_mod.block_sparse_attention_bwd_dst_reference(
                 *core, ts, tr)),
            ("B6s", ("dk", "dv"), first[1], again[1], ref_src,
             lambda: srcp(pair_s),
             lambda: bwd_mod.block_sparse_attention_bwd_src_reference(
                 *core, *src)),
            ("B6b", ("g_a", "g_b"), banks[0], banks[1], ref_bank, bank,
             lambda: bwd_mod.block_sparse_bank_grads_reference(
                 q, k, a, b, ge, plan))):
        for name, x, y, z in zip(names, got, twice, ref):
            if x.dtype != z.dtype or x.shape != z.shape:
                fail(f"{kernel} {label} {dtype_name}: {name} is {x.dtype} "
                     f"{tuple(x.shape)}, the plain version's {z.dtype} "
                     f"{tuple(z.shape)}")
            if not torch.equal(x, y):
                fail(f"{kernel} {label} {dtype_name}: {name} differs between "
                     "two launches on the same inputs")
        err = _compare(kernel, label, dtype_name, list(zip(names, got, ref)))
        # a training step's gradients can be far below KERNEL_TOL's atol:
        # each output also within its rtol of its own largest value
        rel = rel_to_largest(got, ref)
        if rel > KERNEL_TOL[dtype_name]["rtol"]:
            fail(f"{kernel} {label} {dtype_name}: error {rel:.3e} of the "
                 f"largest value, above {KERNEL_TOL[dtype_name]['rtol']}")
        by_row = ""
        if kernel == "B6b":
            # each bank row against the plain B6b on the kernel's own ge
            # (`ref` sums the plain B6d's, whose bf16 roundings of ge
            # differ from the kernel's in a few pairs)
            why, worst = bank_row_disagreement(names, got, plain())
            if why is not None:
                fail(f"B6b {label} {dtype_name}: {why}")
            by_row = (f"; bank rows {worst:.3e} of their largest values "
                      f"beyond one rounding (within {BANK_ROW_TOL})")
        print(f"[kernel] {kernel} {label} {dtype_name}: largest error "
              f"relative to the largest value {rel:.3e}{by_row}")
        bound = block_bound(kernel, args, src)
        rows[kernel] = _block_line(
            kernel, label, q, P, E, dtype_name, err, bound,
            time_ms(fn, bound_ms=bound[0]), time_ms(plain))
    lib, lib_type, lib_err, refused = b6b_library(q, k, a, ge, plan)
    for why in refused:
        print(f"[kernel] B6b yardstick: torch.sparse.mm refuses {why}; "
              f"timed in {lib_type}", flush=True)
    rows["B6b"]["library_ms"] = time_ms(lib)
    print(f"[kernel] B6b {label} {dtype_name}: library torch.sparse.mm "
          f"({lib_type}; its sums without the dt4 term, max_abs_err "
          f"{lib_err:.3e} against the plain version's) "
          f"{rows['B6b']['library_ms']:.6f} ms", flush=True)
    return rows


BLOCK_CASES = {  # c5's sizes: graphs of 0.8N to N-2 nodes at bucket N
    "N256_B4_khop4": (4, 3, 205, 254, 256, 4),
    "N512_B2_khop4": (2, 5, 410, 510, 512, 4),
    "N128_B8_khop0": (8, 7, 102, 126, 128, 0)}


def phase_block_kernels():
    """B5, B5s, B6d, B6s and B6b against their plain versions on the port's
    batchify tile layouts at c5 widths (H=8, Dh=64), bf16 and f32, at the
    three sizes of BLOCK_CASES; each timed beside its bound."""
    import torch

    H, Dh = 8, 64
    for name, spec in BLOCK_CASES.items():
        batch = block_batch(*spec)
        print(f"[kernel] block-sparse case {name}: {describe(batch)} "
              f"tile_src {tuple(batch.tile_src.shape)} tile_dst "
              f"{tuple(batch.tile_dst.shape)}, "
              f"{int((batch.tile_rel >= 0).sum())} kept pairs", flush=True)
        for dtype in (torch.float32, torch.bfloat16):
            args, src, g = block_inputs(batch, H, Dh, dtype)
            check_b5(name, args)
            check_b5(name, args, with_stats=True)
            check_b6(name, args, src, g)
        torch.cuda.empty_cache()
    print("[kernel] library_ms: none for B5, B5s, B6d and B6s — no single "
          "PyTorch call computes the block-sparse relation attention or its "
          "dq, dk, dv (each pair reads its own bank rows); B6b's per-row "
          "sums are one torch.sparse.mm, timed beside it (without the dt4 "
          "term)")


# ---------------------------------------------------------------- mesh

# the ring's cases: c5's sizes cut into S node blocks (graphs, seed, min and
# max nodes, N, khop, S): N=512 B=2 at S=2 and 4, N=256 B=4 at S=2
MESH_CASES = {"N512_B2_khop4_S2": (2, 5, 410, 510, 512, 4, 2),
              "N512_B2_khop4_S4": (2, 5, 410, 510, 512, 4, 4),
              "N256_B4_khop4_S2": (4, 3, 205, 254, 256, 4, 2)}
MESH_KERNELS = (B5S, B6D, B6S, B6B)
# the edge schedules (plain torch in f32, so a bf16 input's gradient is the
# f32 sum rounded once) against f32 "sparse" on the same values, element by
# element: |x - y| <= rtol |y| + of_largest max|y|; bf16's rtol twice its
# rounding bound (2^-8), of_largest for the summation order near zero
MESH_EDGE_TOL = {"float32": dict(rtol=1e-4, of_largest=1e-5),
                 "bfloat16": dict(rtol=2 ** -7, of_largest=1e-4)}


def mesh_batches(n_graphs, seed, min_nodes, max_nodes, N, khop, S):
    """The same instances batchified at cp_shards=S (edge cells and the
    per-cell tile layouts) and at 1 (edge cells and tiles): training
    batches, c5's bucket spec at node bucket N."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus

    graphs, targets = synthetic_amr_corpus(
        n_graphs, seed=seed, min_nodes=min_nodes, max_nodes=max_nodes)
    inst, vocabs = preprocess(graphs, targets), build_vocabs(graphs, targets)
    kw = dict(batch_size_bucket=n_graphs, for_train=True, build_edges=True,
              build_block_tiles=True, sparse_khop=khop,
              spec=BucketSpec(**dict(C5_SPEC, nodes=(N,))))
    return (batchify(inst, *vocabs, cp_shards=S, **kw),
            batchify(inst, *vocabs, cp_shards=1, **kw))


def mesh_gap(got, ref, dtype_name):
    """(within the gate, largest absolute error, largest error relative to
    each output's largest value): every output finite and within
    KERNEL_TOL's rtol of its own largest value; in f32 each output, in
    bf16 the first (the attention's output) also within KERNEL_TOL
    element by element. (In bf16 two summation orders of a gradient, each
    rounded to bf16, differ element by element beyond KERNEL_TOL near
    zero: the single-device kernels' gradients do against f32 too.)"""
    import torch

    tol = KERNEL_TOL[dtype_name]
    whole = got if dtype_name == "float32" else got[:1]
    ok = all(torch.isfinite(x.float()).all().item() for x in got) and all(
        torch.allclose(x.float(), y.float(), **tol)
        for x, y in zip(whole, ref))
    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(got, ref))
    rel = rel_to_largest(got, ref)
    return ok and rel <= tol["rtol"], err, rel


def no_alpha_merge(state, out_t, m_t, l_t):
    """A planted wrong merge: the running partials are not rescaled by
    alpha when a step raises the running max."""
    import torch

    m, l, o = state
    new_m = torch.maximum(m, m_t)
    beta = torch.where(l_t > 0, torch.exp(m_t - new_m), 0.0)
    return new_m, l + l_t * beta, o + out_t.float() * (l_t * beta)[..., None]


def edge_gap(got, ref, dtype_name):
    """(within MESH_EDGE_TOL, the largest of |x - y| / (rtol |y| +
    of_largest max|y|) over the outputs' elements: 1 at the limit)."""
    import torch

    tol = MESH_EDGE_TOL[dtype_name]
    worst, ok = 0.0, True
    for x, y in zip(got, ref):
        x, y = x.float(), y.float()
        ok = ok and bool(torch.isfinite(x).all().item())
        lim = tol["rtol"] * y.abs() + tol["of_largest"] * y.abs().max()
        worst = max(worst, ((x - y).abs() / lim.clamp_min(1e-30))
                    .max().item())
    return ok and worst <= 1.0, worst


def drop_cell(edge_mask):
    """A planted fault: the edge mask without the off-diagonal cell that
    keeps the fewest pairs (of those that keep any); (mask, cell, pairs)."""
    S = edge_mask.shape[1]
    kept = {(d, s): int(edge_mask[:, d, s].sum().item())
            for d in range(S) for s in range(S) if d != s}
    cell = min((c for c in kept if kept[c]), key=kept.get)
    mask = edge_mask.clone()
    mask[:, cell[0], cell[1]] = False
    return mask, cell, kept[cell]


def phase_mesh_cli():
    """(a) The train CLI on the c5 config under "block_sparse" as a mesh
    of one rank (--graph 1 --dp 1: init_process_group with NCCL,
    shard_arrays, the loss over the all-reduced token count, the gradient
    all-reduce; its [mesh] line must report the step captured) against
    --dp 0 on the same synthetic corpus and seed: the
    same losses and parameters after WORK_STEPS steps, bit for bit; and
    the mesh run stopped at half the steps and resumed (rank 0 reads the
    checkpoint and broadcasts it, every data rank's dropout generator in
    it) ends with the same bits too. (c) --dp 2 on this one-card machine
    raises naming the card count."""
    import re

    import torch

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_mesh_", dir=ROOT)
    try:
        runs = {}
        half = str(WORK_STEPS // 2)
        for tag, flags in (("dp0", ["--dp", "0"]), ("dp1", ["--dp", "1"]),
                           ("cut", ["--dp", "1", "--total_steps", half]),
                           ("cut", ["--dp", "1", "--resume"])):
            ckpt = os.path.join(tmp, tag)
            t0 = time.perf_counter()
            res = run_cli("mesh", [
                "gtos_tpu_torch.train.train", "--config",
                "configs/c5_scaled_synthetic.json", "--attention_impl",
                "block_sparse", "--graph", "1", *flags[:2], "--synthetic",
                str(WORK_SYNTHETIC), "--total_steps", str(WORK_STEPS),
                "--ckpt_dir", ckpt, *flags[2:]])
            wall = time.perf_counter() - t0
            if "--total_steps" in flags:
                continue
            with open(os.path.join(ckpt, "metrics.jsonl")) as f:
                lines = [json.loads(x) for x in f]
            mesh = re.findall(r"^\[mesh\] (.*)$", res.stderr, re.M)
            params = torch.load(os.path.join(ckpt, f"step_{WORK_STEPS}",
                                             "params.pt"))
            runs[tag] = (lines[-1], params)
            print(f"[mesh] c5 CLI --dp {flags[1]} {' '.join(flags[2:])}: "
                  f"{mesh[0] if mesh else 'no mesh'}; loss "
                  f"{lines[-1]['loss']!r} at step {lines[-1]['step']}, "
                  f"{lines[-1]['tokens_per_s']:.1f} target tokens/s, "
                  f"{1e3 * wall / WORK_STEPS:.1f} ms a step of CLI wall "
                  f"({wall:.1f} s, start-up included)", flush=True)
            if tag != "dp0" and (not mesh or "nccl" not in mesh[0]
                                 or "world 1" not in mesh[0]
                                 or "step captured" not in mesh[0]):
                fail(f"the --dp 1 run ({tag}) did not report an NCCL mesh "
                     f"of one rank whose step is captured: {mesh}")
        (l0, p0), (l1, p1) = runs["dp0"], runs["dp1"]
        same = (l0["loss"] == l1["loss"] and p0.keys() == p1.keys()
                and all(torch.equal(p0[k], p1[k]) for k in p0))
        print(f"[mesh] --dp 1 against --dp 0: losses {l1['loss']!r} / "
              f"{l0['loss']!r}, {len(p0)} parameter tensors, the same bits: "
              f"{'yes' if same else 'no'}", flush=True)
        if not same:
            fail("the NCCL mesh of one rank does not train the --dp 0 run's "
                 "bits")
        l2, p2 = runs["cut"]
        same = (l2["loss"] == l1["loss"] and p2.keys() == p1.keys()
                and all(torch.equal(p1[k], p2[k]) for k in p1))
        print(f"[mesh] --dp 1 resumed at step {half} against unbroken: "
              f"losses {l2['loss']!r} / {l1['loss']!r}, the same bits: "
              f"{'yes' if same else 'no'}", flush=True)
        if not same:
            fail("the resumed NCCL mesh run does not end with the unbroken "
                 "run's bits")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]))
        res = subprocess.run(
            [sys.executable, "-m", "gtos_tpu_torch.train.train", "--config",
             "configs/c5_scaled_synthetic.json", "--attention_impl",
             "block_sparse", "--graph", "1", "--dp", "2", "--synthetic",
             "16", "--total_steps", "1", "--ckpt_dir",
             os.path.join(tmp, "dp2")], cwd=ROOT, env=env,
            capture_output=True, text=True)
        cards = torch.cuda.device_count()
        said = f"{cards} card(s) are visible" in res.stderr
        print(f"[mesh] --dp 2 on {cards} card(s): rc {res.returncode}, "
              f"{res.stderr.strip().splitlines()[-1][:200]}", flush=True)
        if res.returncode == 0 or not said:
            fail("--dp 2 on a one-card machine must raise naming the card "
                 "count")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mesh_rings():
    """(b) The three CP schedules of S ranks emulated in one process on the
    card (parallel/*: the loops the distributed modules run, each exchange
    a rotation of a list) at c5 widths (H=8, Dh=64), f32 and bf16, on
    MESH_CASES: the B5s/B6 ring (out, dq, dk, dv, g_a, g_b) against
    single-device "block_sparse" (B5s, B6) on the cp_shards=1 layout, with
    B5s = B6d = B6s = B6b = S*S launches; a planted merge without the
    alpha rescale must fail that gate; the edge-cell ring and a2a against
    f32 single-device "sparse" on the same values (MESH_EDGE_TOL), where
    the same schedule without one cell's pairs must fail. Then each kernel
    on rank 0's S
    cells (bf16) against its plain version, timed beside its bound: the
    JSON line's rows of model "c5 mesh". Returns those rows."""
    import torch

    from gtos_tpu_torch.ops.block_sparse_attention import (
        block_sparse_relation_attention_trainable)
    from gtos_tpu_torch.ops.sparse_relation import (
        flatten_edge_cells, sparse_relation_attention)
    from gtos_tpu_torch.parallel import (
        a2a_attention, ring_attention, ring_block_sparse as rbs)

    H, Dh = 8, 64
    t0 = time.perf_counter()
    rows = {name: [] for name in MESH_KERNELS}
    launches = {name: 0 for name in MESH_KERNELS}
    cuda = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    for case, spec in MESH_CASES.items():
        S = spec[-1]
        cp, one = mesh_batches(*spec)
        print(f"[mesh] case {case}: {describe(one)}, ctile_src "
              f"{tuple(cp.ctile_src.shape)}, ctile_dst "
              f"{tuple(cp.ctile_dst.shape)}, "
              f"{int(cp.edge_mask.sum())} kept pairs", flush=True)
        ctiles = [cuda(getattr(cp, k)) for k in (
            "ctile_src", "ctile_rel", "ctile_dst", "ctile_rel_src")]
        edges = [cuda(getattr(cp, k)) for k in (
            "edge_src", "edge_dst", "edge_rel", "edge_mask")]
        N = one.concept_mask.shape[1]
        flat = flatten_edge_cells(*(cuda(getattr(one, k)) for k in (
            "edge_src", "edge_dst", "edge_rel", "edge_mask")), N)
        for dtype in (torch.float32, torch.bfloat16):
            args, src, g = block_inputs(one, H, Dh, dtype)
            dtype_name = _dtype_name(args[0])
            leaves = [x.detach().requires_grad_() for x in args[:5]]
            ref_out = block_sparse_relation_attention_trainable(
                *leaves, *args[5:], tile_dst=src[0], tile_rel_src=src[1])
            ref = [ref_out] + list(torch.autograd.grad(ref_out, leaves, g))
            zero_counts()
            got = rbs.emulate(*args[:5], *ctiles[:2], S, *ctiles[2:],
                              g_out=g)
            torch.cuda.synchronize()
            counts = read_counts()
            want = {name: (S * S if name in MESH_KERNELS else 0)
                    for name in KERNELS}
            print(f"[mesh] {case} {dtype_name} launches of one B5s/B6 ring "
                  f"call over {S} ranks: "
                  + ", ".join(f"{k}={v}" for k, v in counts.items() if v),
                  flush=True)
            if counts != want:
                fail(f"the ring at S={S} launched {counts}, not {want}")
            for name in MESH_KERNELS:
                launches[name] += counts[name]
            ok, err, rel = mesh_gap(got, ref, dtype_name)
            print(f"[mesh] {case} {dtype_name} B5s/B6 ring against "
                  f"single-device block_sparse (out, dq, dk, dv, g_a, g_b): "
                  f"max_abs_err {err:.3e}, {rel:.3e} of the largest value "
                  f"(tol {KERNEL_TOL[dtype_name]})", flush=True)
            if not ok:
                fail(f"the B5s/B6 ring disagrees with single-device "
                     f"block_sparse at {case} {dtype_name}")
            planted = rbs.emulate(*args[:5], *ctiles[:2], S,
                                  merge_fn=no_alpha_merge)
            caught = not mesh_gap([planted], ref[:1], dtype_name)[0]
            print(f"[mesh] {case} {dtype_name} planted merge without the "
                  f"alpha rescale fails the gate: "
                  f"{'yes' if caught else 'no'}", flush=True)
            if not caught:
                fail("a ring merge without the alpha rescale passes the gate")
            # the edge schedules against f32 single-device "sparse" on the
            # same values (MESH_EDGE_TOL); a dropped cell must fail
            leaves = [x.detach().float().requires_grad_() for x in args[:5]]
            out = sparse_relation_attention(*leaves, *flat)
            exact = [out] + list(torch.autograd.grad(out, leaves, g.float()))
            mask, cell, pairs = drop_cell(edges[3])
            for name, fn in (("edge-cell ring", ring_attention.emulate_ring),
                             ("a2a", a2a_attention.emulate_a2a)):
                leaves = [x.detach().requires_grad_() for x in args[:5]]
                out = fn(*leaves, *edges, S)
                got = [out] + list(torch.autograd.grad(out, leaves, g))
                ok, worst = edge_gap(got, exact, dtype_name)
                err = max((x.float() - y).abs().max().item()
                          for x, y in zip(got, exact))
                planted = fn(*args[:5], *edges[:3], mask, S)
                caught = not edge_gap([planted], exact[:1], dtype_name)[0]
                print(f"[mesh] {case} {dtype_name} {name} against f32 "
                      "single-device sparse (out, dq, dk, dv, g_a, g_b): "
                      f"{worst:.3f} of the limit {MESH_EDGE_TOL[dtype_name]}"
                      f", max_abs_err {err:.3e}; cell {cell} ({pairs} "
                      f"pairs) dropped fails the gate: "
                      f"{'yes' if caught else 'no'}", flush=True)
                if not ok:
                    fail(f"the {name} disagrees with single-device sparse at "
                         f"{case} {dtype_name}")
                if not caught:
                    fail(f"the {name} without cell {cell} passes the gate")
            del leaves, ref, got, exact
            torch.cuda.empty_cache()
        # each kernel on rank 0's cells (0, j), bf16: a rank's per-step work
        args, _, g = block_inputs(one, H, Dh, torch.bfloat16)
        Nl = N // S
        blk = lambda x, s: x[:, :, s * Nl:(s + 1) * Nl].contiguous()  # noqa
        for j, cell in enumerate(rbs.rank_cells(0, S, *ctiles)):
            label = f"{case} cell (0,{j})"
            cargs = (blk(args[0], 0), blk(args[1], j), blk(args[2], j),
                     args[3], args[4], *cell[:2])
            if int((cell[1] >= 0).sum()) == 0:
                print(f"[mesh] {label}: no kept pair, not timed", flush=True)
                continue
            rows[B5S].append(check_b5(label, cargs, with_stats=True))
            b6 = check_b6(label, cargs, cell[2:], blk(g, 0))
            for name, kern in ((B6D, "B6d"), (B6S, "B6s"), (B6B, "B6b")):
                rows[name].append(b6[kern])
        torch.cuda.empty_cache()
    print(f"[mesh] the ring phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return [table_row(name, rows[name], launches, model="c5 mesh")
            for name in MESH_KERNELS]


def phase_mesh():
    """The multi-device tier on one card: phase_mesh_cli, then
    phase_mesh_rings (their docstrings); returns the JSON rows."""
    t0 = time.perf_counter()
    phase_mesh_cli()
    rows = phase_mesh_rings()
    print(f"[mesh] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


@functools.lru_cache(maxsize=None)
def c5_corpus():
    """The c5 model's data: the bench's corpus("c5"), C5_GRAPHS synthetic
    AMR graphs of C5_NODES nodes (seed 0), preprocessed, with their
    vocabularies."""
    t0 = time.perf_counter()
    out = corpus("c5")
    print(f"[c5] corpus: {C5_GRAPHS} graphs of {C5_NODES[0]}-{C5_NODES[1]} "
          f"nodes preprocessed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def c5_configs(impl="block_sparse"):
    """The ModelConfig and TrainConfig of configs/c5_scaled_synthetic.json
    (one card: its graph/dp split is not a field of either) with the c5
    corpus's vocabulary sizes, under attention_impl `impl`."""
    return configs("c5", impl)


def c5_loader(for_train, seed=None, impl="block_sparse"):
    """The c5 DataLoader as the CLIs build it (c5's 8192-token batches,
    sparse_khop 4, edge cells and tiles), with C5_SPEC's widened bank and
    edge-cell ladders; the loader bisects a batch whose bank overflows."""
    from gtos_tpu_torch.data import BucketSpec, DataLoader
    from gtos_tpu_torch.train.train import loader_flags

    cfg, tcfg = c5_configs()
    instances, vocabs = c5_corpus()
    return DataLoader(instances, *vocabs,
                      batch_size_tokens=tcfg.batch_size_tokens,
                      spec=BucketSpec(**C5_SPEC).for_model_max_oov(
                          cfg.max_oov),
                      for_train=for_train,
                      seed=tcfg.seed if seed is None else seed,
                      **loader_flags(impl, cfg.sparse_khop))


def c5_trainer(cfg, tcfg, seed, ckpt=None, log=None):
    import torch

    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.trainer import Trainer

    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(seed))
    example = next(iter(c5_loader(True)))
    return Trainer(model, cfg, tcfg, example.arrays(), metrics_writer=log,
                   checkpoint_manager=ckpt, device="cuda")


def phase_c5_serve(cfg, model, tv):
    """Serve the fullest batch of each c5 node bucket (N=128/256/512)
    through decode_batch (beam BEAM, MAX_STEPS steps), after a warm-up
    decode; B5 = enc_layers per batch, no other kernel. Returns the
    batches, their seconds and the launches, and layer 0's B5 inputs of
    each batch."""
    import torch

    from gtos_tpu_torch.infer.decode import decode_batch

    fullest = {}
    for batch, insts in c5_loader(False).iter_with_instances():
        N = batch.concept_mask.shape[1]
        if N not in fullest or len(insts) > len(fullest[N][1]):
            fullest[N] = (batch, insts)
    plan = [fullest[N] for N in sorted(fullest)]
    decode_batch(model, plan[0][0], tv, beam_size=BEAM, max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    zero_counts()
    batches, seconds = [], []
    for batch, insts in plan:
        t0 = time.perf_counter()
        hyps = decode_batch(model, batch, tv, beam_size=BEAM,
                            max_steps=MAX_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if len(hyps) != len(insts):
            fail("decode_batch must return one hypothesis per request")
        print(f"[c5 serve] batch {len(batches)}: {len(insts)} requests "
              f"({describe(batch)}, {int(batch.edge_mask.sum())} kept pairs)"
              f" beam {BEAM}: {dt * 1e3:.3f} ms, "
              f"{len(insts) / dt:.3f} requests/s", flush=True)
        batches.append(batch)
        seconds.append(dt)
    launches = read_counts()
    expect = dict.fromkeys(KERNELS, 0)
    expect[B5] = cfg.enc_layers * len(batches)
    if launches != expect or len(batches) < 3:
        fail(f"c5 serving of {len(batches)} batches launched {launches}, "
             f"expected {expect}")
    print(f"[c5 serve] launches {launches[B5]} of B5 = {cfg.enc_layers} "
          f"layers x {len(batches)} batches, no other kernel", flush=True)
    first = [capture(model, b, False, model.device)["calls"]["B5"][0]
             for b in batches]
    return batches, seconds, launches, first


def phase_c5_encoder(cfg, model, batch):
    """Generator.encode of the c5 model on the card (B5), bf16 as served
    and the same weights in f32, against f32 on the CPU (plain version),
    over the real nodes of one batch, within C5_ENCODER_TOL."""
    import torch

    from gtos_tpu_torch.models import Generator

    weights = {k: v.float() for k, v in model.state_dict().items()}
    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = Generator(f32_cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in weights.items()})
    card32 = Generator(f32_cfg, device="cuda")
    card32.load_state_dict(weights)
    ref = encode(cpu, batch)
    mask = torch.from_numpy(batch.concept_mask)
    bad = []
    for card, dtype_name in ((model, "bfloat16"), (card32, "float32")):
        out = encode(card, batch)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail("c5 encoder output not finite / wrong shape")
        diff = (out - ref).abs()[mask]
        max_abs, mean_abs = diff.max().item(), diff.mean().item()
        tol = C5_ENCODER_TOL[dtype_name]
        ok = max_abs <= tol["max_abs"] and mean_abs <= tol["mean_abs"]
        print(f"[c5 encode] card {dtype_name} (B5) vs cpu f32 over "
              f"{int(mask.sum())} real nodes ({describe(batch)}): "
              f"max_abs={max_abs:.4e} mean_abs={mean_abs:.4e} (tol {tol}): "
              + ("within" if ok else "outside"), flush=True)
        if not ok:
            bad.append(dtype_name)
    if bad:
        fail(f"the c5 encoder on the card ({bad}) disagrees with the f32 CPU "
             "run")


def c5_train_expect(cfg, steps):
    expect = dict.fromkeys(KERNELS, 0)
    for name in (B5S, B6D, B6S, B6B):
        expect[name] = cfg.enc_layers * steps
    return expect


def phase_c5_train():
    """Trainer.fit of the c5 model (bf16, dropout 0.1, the c5 schedule)
    under "block_sparse" on C5_TRAIN_STEPS for_train=True loader batches:
    B5s = B6d = B6s = B6b = enc_layers per step, no other kernel. Returns
    the trainer and its batches."""
    import torch

    cfg, tcfg = c5_configs()
    batches = [b for _, b in zip(range(C5_TRAIN_STEPS), c5_loader(True))]
    log = StepLog("c5 train", every=1)
    trainer = c5_trainer(cfg, dataclasses.replace(
        tcfg, total_steps=C5_TRAIN_STEPS, checkpoint_every=10 ** 9), 0,
        log=log)
    for i, batch in enumerate(batches):
        print(f"[c5 train] step {i + 1} batch: {describe(batch)}, "
              f"{int(batch.edge_mask.sum())} kept pairs")
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit(batches, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect = c5_train_expect(cfg, C5_TRAIN_STEPS)
    if trainer.step != C5_TRAIN_STEPS or launches != expect:
        fail(f"c5 training ran {trainer.step} steps with launches "
             f"{launches}, expected {expect}")
    if not all(np.isfinite(log.losses())):
        fail(f"non-finite c5 training loss: {log.losses()}")
    steady = [r["ms_per_step"] for r in log.records[1:]]
    tokens = sum(int(b.token_mask.sum()) for b in batches)
    ms_step = sum(steady) / len(steady)
    print(f"[c5 train] {C5_TRAIN_STEPS} steps in {wall:.3f} s; "
          f"{ms_step:.3f} ms/step after step 1; "
          f"{tokens / wall:.1f} target tokens/s; launches "
          f"{ {k: v for k, v in launches.items() if v} } = "
          f"{cfg.enc_layers} layers x {C5_TRAIN_STEPS} steps", flush=True)
    return trainer, batches, launches, ms_step


def planted_b6(kind):
    """B6 made wrong on purpose, as a control for the gradient check: B6d's
    dq without its b_r term ("no GT2.b term in dq"), B6s's dk without its
    a_r term ("no GT3.a term in dk": the wrapper's dk less each kept
    pair's ge' a_r, with ge from the plain pair gradients), or B6b's bank
    gradients without the t4 redistribution ("no t4 redistribution").
    Returns (the kernel, the planted function)."""
    import torch

    from gtos_tpu_torch.ops import block_sparse_attention_bwd as bwd_mod
    from gtos_tpu_torch.ops.block_sparse_attention import tile_pairs
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import real_pairs
    from gtos_tpu_torch.ops.relation_attention import _default_scale

    if kind == "no GT2.b term in dq":
        real = bwd_mod.block_sparse_attention_bwd_dst

        def wrong(q, k, v, a, b, t4, gp, m, l, delta, ts, tr, plan=None,
                  scale=None):
            dq, ge, pair_s = real(q, k, v, a, b, t4, gp, m, l, delta, ts, tr,
                                  plan, scale)
            bi, i, _, r = real_pairs(plan)
            B, H, N, Dh = q.shape
            w = ge[:, :len(r)].T.to(q.dtype).float()[..., None] * \
                b[r].float()
            part = torch.zeros(B * N, H, Dh, device=q.device).index_add_(
                0, bi * N + i, w).view(B, N, H, Dh).transpose(1, 2)
            return (dq.float() - part).to(dq.dtype), ge, pair_s
        return "B6d", wrong
    if kind == "no GT3.a term in dk":
        real_src = bwd_mod.block_sparse_attention_bwd_src

        def wrong_src(q, k, v, a, b, t4, gp, m, l, delta, td, trs,
                      plan=None, pair_s=None, scale=None):
            dk, dv = real_src(q, k, v, a, b, t4, gp, m, l, delta, td, trs,
                              plan, pair_s, scale)
            B, H, N, Dh = q.shape
            bi, j, i, r, _ = tile_pairs(td, trs, N, a.shape[0])
            ge, _ = bwd_mod._pair_grads(
                q, k, v, a, b, t4, gp, m, l, delta, bi, i, j, r,
                _default_scale(q, scale))
            w = ge.to(q.dtype).float()[..., None] * a[r].float()
            part = torch.zeros(B * N, H, Dh, device=q.device).index_add_(
                0, bi * N + j, w).view(B, N, H, Dh).transpose(1, 2)
            return (dk.float() - part).to(dk.dtype), dv
        return "B6s", wrong_src
    real = bwd_mod.block_sparse_bank_grads

    def wrong(q, k, a, b, ge, plan):
        g_a, g_b = real(q, k, a, b, ge, plan)
        r = real_pairs(plan)[3]
        dt4 = torch.zeros(a.shape[:2], device=q.device).index_add_(
            0, r, ge[:, :len(r)].T.to(q.dtype).float())[..., None]
        return ((g_a.float() - dt4 * b.float()).to(g_a.dtype),
                (g_b.float() - dt4 * a.float()).to(g_b.dtype))
    return "B6b", wrong


def planted_b5s():
    """B5s made wrong on purpose, as a control for the c5 gradient check:
    its scores without the relation term k_j.a_r ("no k.a term"; the real
    kernel given a zero a bank, with the true t4). Returns (the kernel,
    the planted function)."""
    import torch

    from gtos_tpu_torch.ops import block_sparse_attention as fwd_mod

    real = fwd_mod.block_sparse_attention_with_stats

    def wrong(q, k, v, a, b, ts, tr, scale=None, t4=None):
        t4 = fwd_mod.bank_t4(a, b) if t4 is None else t4
        return real(q, k, v, torch.zeros_like(a), b, ts, tr, scale, t4)
    return "B5s", wrong


B6B_PLANTS = ("the work list's last chunk left out",
              "a padding place read as a real pair")


def planted_b6b_list(kind):
    """B6b made wrong on purpose inside a CUDA graph, as a control for the
    replay gate (bench.check_kernel, which holds B6b's bank rows one by
    one): the kernel launched on a changed work list, made on the card
    with no host read, so it captures. B6B_PLANTS[0]: the list's last
    chunk given no pair (on c5's first batch a run of 35 pairs, a whole
    bank row); [1]: the entry that ends at the last real place reads one
    place further, the first padding place, whose ge column is set to
    ge's largest magnitude (the kernel's padding columns are unwritten).
    Returns (the kernel, the planted function)."""
    import torch

    from gtos_tpu_torch.ops import block_sparse_attention_bwd as bwd_mod

    real = bwd_mod.block_sparse_bank_grads

    def wrong(q, k, a_bank, b_bank, ge, plan):   # the wrapper's names
        counts, E, cap = plan["bank_counts"].long(), plan["E"].long(), \
            plan["cap"]
        at = lambda x: torch.arange(len(x), device=x.device)  # noqa: E731
        if kind == B6B_PLANTS[0]:
            chunks = plan["bank_chunks"].clone()
            chunks[:, 1] = torch.where(at(chunks) == counts[0] - 1, 0,
                                       chunks[:, 1])
            return real(q, k, a_bank, b_bank, ge,
                        dict(plan, bank_chunks=chunks))
        lists = dict(plan)
        for name, n, most in (("bank_chunks", counts[0], bwd_mod.BANK_CHUNK),
                              ("bank_shorts", counts[1], bwd_mod.SHORT_RUN)):
            w = plan[name].clone()
            w[:, 1] += ((at(w) < n) & (w[:, 0] + w[:, 1] == E)
                        & (w[:, 1] < most)).to(w.dtype)
            lists[name] = w
        live = torch.arange(cap, device=ge.device) < E
        top = torch.where(live, ge.abs(), 0.0).amax(1, keepdim=True)
        ge = ge.clone().index_copy_(1, E.clamp_max(cap - 1).view(1), top)
        return real(q, k, a_bank, b_bank, ge, lists)
    return "B6b", wrong


def c5_grad_batch():
    """The c5 train batch of the gradient checks: the corpus's first two
    graphs of the N=256 bucket (two node tiles), batched as the loader
    batches them, small enough for the f32 reference on the CPU."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.train.train import loader_flags

    cfg, _ = c5_configs()
    instances, vocabs = c5_corpus()
    pick = [i for i in instances if 128 <= len(i.concepts) < 256][:2]
    spec = BucketSpec(**C5_SPEC).for_model_max_oov(cfg.max_oov)
    return batchify(pick, *vocabs, spec=spec, for_train=True,
                    **loader_flags("block_sparse", cfg.sparse_khop))


def phase_c5_grads():
    """The loss and every parameter gradient of one c5 train batch
    (dropout 0) under "block_sparse" on the card (B5s and B6), the f32
    model then the bf16 one, against the same f32 weights on the CPU (plain
    versions), within GRAD_TOL; each planted wrong B6, and a B5s without
    its k.a term, must fail in one of the two types. Then the same batch under "sparse" (the edge-list
    attention, plain torch on the card) against "block_sparse" in f32,
    within SPARSE_TOL, and launching none of the kernels."""
    import torch

    from gtos_tpu_torch.models import Generator

    cfg, _ = c5_configs()
    cfg = dataclasses.replace(cfg, dropout=0.0)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = c5_grad_batch()
    arrays = batch.arrays()
    weights = Generator(cfg, device="cpu",
                        rng=torch.Generator().manual_seed(4)).state_dict()
    models = {}
    for name, c, dev in (("cpu", f32, "cpu"), ("float32", f32, "cuda"),
                         ("bfloat16", cfg, "cuda")):
        models[name] = Generator(c, device=dev)
        models[name].load_state_dict(weights)
    t0 = time.perf_counter()
    ref = loss_and_grads(models["cpu"], arrays)
    print(f"[c5 grads] batch {describe(batch)}, {int(batch.edge_mask.sum())}"
          f" kept pairs; cpu f32 loss {ref[0]:.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def check(dtype_name, what, ref=ref, tol=None, impl="block_sparse"):
        zero_counts()
        got = loss_and_grads(models[dtype_name], arrays)
        launches = read_counts()
        expect = (c5_train_expect(cfg, 1) if impl == "block_sparse"
                  else dict.fromkeys(KERNELS, 0))
        if launches != expect:
            fail(f"the {dtype_name} {impl} gradient run launched {launches}, "
                 f"expected {expect}")
        dloss, rel, name = grad_gap(ref, got)
        tol = tol or GRAD_TOL[dtype_name]
        ok = dloss <= tol["loss"] and rel <= tol["rel"]
        print(f"[c5 grads] card {dtype_name} with {what} vs "
              f"{'cpu f32' if ref is refs[0] else 'card f32 block_sparse'}: "
              f"loss gap {dloss:.4e}, largest relative gradient gap "
              f"{rel:.4e} ({name}) (tol {tol}): "
              + ("within" if ok else "outside"), flush=True)
        return ok, got

    refs = [ref]
    sound = {}
    for dtype_name in ("float32", "bfloat16"):
        ok, sound[dtype_name] = check(dtype_name, "B5s/B6")
        if not ok:
            fail(f"the {dtype_name} c5 model's loss and gradients on the card"
                 " disagree with the f32 CPU run")
    for kind in ("no GT2.b term in dq", "no GT3.a term in dk",
                 "no t4 redistribution"):
        with replaced(*planted_b6(kind)):
            passed = [check(dtype_name, f"planted B6 ({kind})")[0]
                      for dtype_name in ("float32", "bfloat16")]
        if all(passed):
            fail(f"the c5 gradient check passes a B6 with {kind}")
    with replaced(*planted_b5s()):
        passed = [check(dtype_name, "planted B5s (no k.a term)")[0]
                  for dtype_name in ("float32", "bfloat16")]
    if all(passed):
        fail("the c5 gradient check passes a B5s with no k.a term")
    models["float32"].cfg = dataclasses.replace(f32, attention_impl="sparse")
    refs.append(sound["float32"])
    ok, _ = check("float32", "sparse", ref=sound["float32"], tol=SPARSE_TOL,
                  impl="sparse")
    models["float32"].cfg = f32
    if not ok:
        fail("c5 under 'sparse' disagrees with 'block_sparse'")


def phase_c5_resume():
    """The c5 model trained C5_RESUME_AT steps, saved, restored into a
    fresh model and trainer and trained C5_RESUME_MORE more, against the
    unbroken run: the resumed steps' losses the same bits (B6 sums each
    node's and each bank row's pairs in a fixed order; no atomics). The
    Trainers run the captured step, the backward plan built inside it:
    the resumed steps cross into the loader's second epoch, whose
    signatures repeat, so the resumed run must replay."""
    from gtos_tpu_torch.train.checkpoint import CheckpointManager

    cfg, tcfg = c5_configs()
    total = C5_RESUME_AT + C5_RESUME_MORE
    tcfg = dataclasses.replace(tcfg, total_steps=total,
                               checkpoint_every=C5_RESUME_AT)
    whole = StepLog("c5 resume")
    c5_trainer(cfg, tcfg, 5, log=whole).fit(c5_loader(True), log_every=1)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        ckpt = CheckpointManager(tmp, cfg, tcfg)
        c5_trainer(cfg, dataclasses.replace(tcfg, total_steps=C5_RESUME_AT),
                   5, ckpt=ckpt, log=StepLog("c5 resume")).fit(
                       c5_loader(True), log_every=1)
        cont = StepLog("c5 resume")
        trainer = c5_trainer(cfg, tcfg, 6, ckpt=CheckpointManager(
            tmp, cfg, tcfg), log=cont)
        if trainer.restore_if_available() != C5_RESUME_AT:
            fail(f"restore did not find the checkpoint of step {C5_RESUME_AT}")
        trainer.fit(c5_loader(True), log_every=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want, got = whole.losses()[C5_RESUME_AT:], cont.losses()
    same = want == got
    path = trainer.step_path(next(iter(c5_loader(True))).arrays())
    replays = trainer._step.graphs.replays
    print(f"[c5 resume] steps {C5_RESUME_AT + 1}-{total}: unbroken {want}, "
          f"resumed {got}: " + ("bit-identical" if same else "DIFFER")
          + f"; the steps {path} ({replays} replays in the resumed run)",
          flush=True)
    if not same:
        fail("the resumed c5 run's losses differ from the unbroken run's")
    if path != "captured" or replays == 0:
        fail(f"the resumed c5 run is {path} with {replays} replays")


def capture_block_train_inputs(trainer, batches):
    """The arguments the c5 training path hands B5s and B6: layer 0's (the
    first forward call; the last calls of B6d, B6s and B6b) for each
    batch, from one more forward and backward per batch (`capture`).
    Returns (B5s args, src-major layout, (B6 inputs, plan)) per batch."""
    out = []
    for batch in batches:
        calls = capture(trainer.model, batch, True,
                        trainer.model.device)["calls"]
        dst = calls["B6d"][0]
        out.append((calls["B5s"][0][:7], calls["B6s"][0][10:12],
                    (dst[:10], dst[12])))
    return out


def phase_block_shapes(serve_inputs, serve_launches, train_inputs,
                       train_launches):
    """B5 on layer 0 of each c5 served batch, B5s and B6 on layer 0 of
    the captured c5 train batches, against their plain versions and
    timed: the table rows, with the serving run's (B5) and the training
    run's (B5s, B6) launches."""
    rows = {B5: [], B5S: [], B6D: [], B6S: [], B6B: []}
    for i, args in enumerate(serve_inputs):
        rows[B5].append(check_b5(f"serve{i}", args))
    for i, (args, src, bwd) in enumerate(train_inputs):
        rows[B5S].append(check_b5(f"train{i}", args, with_stats=True))
        got = check_b6(f"train{i}", args, src, bwd=bwd)
        for kernel, name in (("B6d", B6D), ("B6s", B6S), ("B6b", B6B)):
            rows[name].append(got[kernel])
    launches = {name: serve_launches[name] + train_launches[name]
                for name in KERNELS}
    return [table_row(name, found, launches, "c5")
            for name, found in rows.items()]


def phase_block_sparse(profile=False):
    """The c5 model at full width under "block_sparse": serving, the
    encoder check, training (with `profile`, one more profiled step on
    each of the captured train batches), the gradient check with planted
    B6s and "sparse", a bit-identical resume, and the kernel table's rows
    on the main path's own inputs."""
    import torch

    from gtos_tpu_torch.models import Generator

    cfg, _ = c5_configs()
    tv = c5_corpus()[1][0]
    print(f"[c5] model d={cfg.d_model} ff={cfg.d_ff} heads={cfg.heads} "
          f"enc={cfg.enc_layers} dec={cfg.dec_layers} {cfg.compute_dtype} "
          f"{cfg.attention_impl} sparse_khop={cfg.sparse_khop} dropout="
          f"{cfg.dropout}; vocab token={cfg.token_vocab} concept="
          f"{cfg.concept_vocab} relation={cfg.relation_vocab}", flush=True)
    model = Generator(cfg, device="cuda", rng=torch.Generator().manual_seed(0))
    batches, _, serve_launches, serve_inputs = phase_c5_serve(cfg, model, tv)
    phase_c5_encoder(cfg, model, batches[0])
    del model
    torch.cuda.empty_cache()
    trainer, train_batches, train_launches, ms_step = phase_c5_train()
    train_inputs = capture_block_train_inputs(
        trainer, train_batches[:CAPTURE_BATCHES])
    if profile:
        for i, batch in enumerate(train_batches[:CAPTURE_BATCHES]):
            phase_profile_train(trainer, ms_step, "block_sparse",
                                batch=batch,
                                label=f"c5 block_sparse train step {i + 1}")
    del trainer
    torch.cuda.empty_cache()
    phase_c5_grads()
    torch.cuda.empty_cache()
    phase_c5_resume()
    torch.cuda.empty_cache()
    return phase_block_shapes(serve_inputs, serve_launches, train_inputs,
                              train_launches)


def phase_auto_tiles():
    """"auto" on a c2-model batch of N=128 graphs (102-126 nodes, no khop)
    whose paths overflow the local-bank ladder: batchify falls back to the
    tile layouts, the batch routes to "block_sparse" (B5s in a training
    forward, enc_layers launches), and its loss under "auto" equals the
    fixed route's to the last bit."""
    import torch

    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device

    cfg, _ = configs()
    cfg = dataclasses.replace(cfg, attention_impl="auto", dropout=0.0)
    graphs, targets = synthetic_amr_corpus(8, seed=2, min_nodes=102,
                                           max_nodes=126)
    spec = BucketSpec(nodes=(128,), bank=C5_SPEC["bank"]).for_model_max_oov(
        cfg.max_oov)
    batch = batchify(preprocess(graphs, targets), *corpus()[1], spec=spec,
                     for_train=True, build_block_tiles="auto",
                     build_local_banks="auto")
    route = route_of("auto", batch.arrays(), cfg)[0]
    if route != "block_sparse" or batch.bank_map is not None:
        fail(f"an N=128 batch overflowing the local-bank ladder routed to "
             f"{route} (bank_map built: {batch.bank_map is not None})")
    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(7)).train()
    arrays = batch_to_device(batch.arrays(), "cuda")
    losses = []
    for impl in ("auto", "block_sparse"):
        model.cfg = dataclasses.replace(model.cfg, attention_impl=impl)
        zero_counts()
        losses.append(model(arrays)[0].item())
        launches = read_counts()
        expect = dict.fromkeys(KERNELS, 0)
        expect[B5S] = cfg.enc_layers
        if launches != expect:
            fail(f"the {impl} forward of the tile batch launched {launches}, "
                 f"expected {expect}")
    same = losses[0] == losses[1]
    print(f"[auto] tile fallback: {describe(batch)} "
          f"tile_src {tuple(batch.tile_src.shape)} -> route {route}; loss "
          f"auto {losses[0]!r}, fixed block_sparse {losses[1]!r}: "
          + ("bit-identical" if same else "DIFFER"), flush=True)
    if not same:
        fail("the auto loss of the tile batch differs from the fixed route's")


# ---------------------------------------------------------------- compiled

# phase_compiled: train batches per cell, each run twice (so that every
# signature replays), and the host-side calls that launch work on the card
COMPILED_BATCHES = {("c2", "pallas_local"): 5, ("c2", "pallas"): 3,
                    ("c4", "pallas_local"): 3, ("c2", "sparse"): 2,
                    ("c2", "xla"): 2, ("c5", "block_sparse"): 3}
# (d): the served (family, impl) pairs, every bucket of each, and the
# routes whose uncaptured searches need not repeat their own tokens:
# "sparse" sums its encoder's messages with scatter-adds in no fixed order,
# and a beam search turns a near tie of bf16 log-probabilities into other
# tokens
UNREPRODUCIBLE_SEARCH = ("sparse",)
COMPILED_SERVE = (("c2", "pallas_local"), ("c4", "pallas_local"),
                  ("c5", "block_sparse"), ("c2", "sparse"), ("c2", "xla"))
PROFILED_STEPS = 4


def _ids(tv):
    return dict(str_id=tv.str_id, end_id=tv.end_id, unk_id=tv.unk_id)


@functools.lru_cache(maxsize=None)
def compiled_batches(family, impl):
    """The cell's train batches: the loader's first ones."""
    n = COMPILED_BATCHES[(family, impl)]
    loader = (c5_loader(True) if family == "c5"
              else train_loader(impl=impl, family=family))
    return [b for _, b in zip(range(n), loader)]


def train_run(family, impl, batches, compiled):
    """Trainer.train_step over the batches twice from one seeded start
    (weights seed 0, the config's dropout and its generator's seed):
    (losses, final state: parameters, Adam's moments and count, the
    dropout generator's state; the trainer)."""
    import torch

    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.train.trainer import Trainer, check_metrics

    cfg, tcfg = configs(family, impl)
    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, tcfg, batches[0].arrays(), device="cuda",
                      compiled=compiled)
    on_card = [batch_to_device(b.arrays(), "cuda") for b in batches] * 2
    metrics = [trainer.train_step(a) for a in on_card]
    for m in metrics:
        check_metrics(m)
    losses = torch.stack([m["loss"] for m in metrics])
    st = trainer.opt.state
    state = dict(tensors=[t.detach().clone() for t in
                          [*trainer.params, *st["mu"], *st["nu"]]],
                 count=int(st["count"]), rng=model.dropout_rng.get_state())
    return losses.tolist(), state, trainer


def run_gap(a, b):
    """(largest loss gap relative to the largest loss, largest gap of a
    parameter or moment element relative to its tensor's largest value)
    between two train runs."""
    (la, sa), (lb, sb) = a, b
    loss = (max(abs(x - y) for x, y in zip(la, lb))
            / max(abs(y) for y in lb))
    worst = 0.0
    for x, y in zip(sa["tensors"], sb["tensors"]):
        top = y.abs().max().item()
        if top > 0:
            worst = max(worst, (x - y).abs().max().item() / top)
    return loss, worst


def compiled_train(family, impl):
    """(a)/(b): the cell's batches twice uncaptured (compiled=False) in
    two runs, then on the graphs (phase_compiled runs this under
    deterministic algorithms): the captured run must agree with the
    first uncaptured run as closely as the uncaptured runs agree
    (COMPILED_SPREAD times their largest gap, at least COMPILED_FLOOR),
    every signature must replay, and the dropout generator and Adam's
    count must end equal. Returns the captured trainer and its
    batches."""
    tag = tag_of("compiled train", impl, family)
    batches = compiled_batches(family, impl)
    e1, e2 = (train_run(family, impl, batches, False) for _ in range(2))
    got = train_run(family, impl, batches, None)
    trainer = got[2]
    spread = run_gap(e2[:2], e1[:2])
    gap = run_gap(got[:2], e1[:2])
    graphs = trainer._step.graphs
    print(f"[{tag}] {len(batches)} batches twice "
          f"({', '.join(describe(b) for b in batches)}): "
          f"{graphs.captures} signatures captured, {graphs.replays} "
          f"replays; uncaptured runs: loss gap {spread[0]:.3e}, state gap "
          f"{spread[1]:.3e}; captured: loss gap {gap[0]:.3e}, "
          f"state gap {gap[1]:.3e}; losses eager {e1[0]} captured "
          f"{got[0]}", flush=True)
    if graphs.replays != 2 * len(batches) - graphs.captures:
        fail(f"{tag}: {graphs.captures} captures and {graphs.replays} "
             f"replays over {2 * len(batches)} steps")
    for x, y, what in ((got[1]["count"], e1[1]["count"], "Adam's count"),
                       (e2[1]["count"], e1[1]["count"], "Adam's count")):
        if x != y:
            fail(f"{tag}: {what} {x} != {y}")
    import torch
    if not all(torch.equal(r[1]["rng"], e1[1]["rng"]) for r in (e2, got)):
        fail(f"{tag}: the dropout generator ends in another state on the "
             "graphs")
    for i, what in ((0, "loss"), (1, "state")):
        limit = max(COMPILED_SPREAD * spread[i], COMPILED_FLOOR[what])
        print(f"[{tag}] {what} gap limit {limit:.3e}", flush=True)
        if not gap[i] <= limit:
            fail(f"{tag}: the captured run's {what} gap {gap[i]:.3e} is "
                 f"over {limit:.3e} (uncaptured runs: {spread[i]:.3e})")
    return trainer, batches


def compiled_eval(family, impl, model, batches):
    """make_eval_step of `model` (a captured train run's, left in train
    mode by its last step, or a served one) on each of the batches: twice
    on the graphs (the signature's first call captures, later ones
    replay) and twice uncaptured (compiled=False): n_tok equal, the
    loss (relative to itself) within COMPILED_SPREAD times the uncaptured
    runs' gap and at least COMPILED_FLOOR["loss"]. acc counts argmax
    hits, so a route whose uncaptured runs differ ("sparse": scatter-adds
    in no fixed order) can flip a near tie: its hits may differ by
    COMPILED_SPREAD times the uncaptured runs' flips and at least one,
    and where the uncaptured runs are bit-equal, by none. Every signature
    must replay, and no call may draw from the dropout generator."""
    import torch

    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.train.trainer import make_eval_step
    from gtos_tpu_torch.utils.graphs import for_model

    tag = tag_of("compiled eval", impl, family)
    captured, eager = make_eval_step(model), make_eval_step(model, False)
    graphs = for_model(model)
    rng, replays = model.dropout_rng.get_state(), graphs.replays

    def gaps(m, r):     # (relative loss gap, argmax hits that differ)
        return (abs(m["loss"] - r["loss"]) / abs(r["loss"]),
                round(abs(m["acc"] - r["acc"]) * r["n_tok"]))

    worst = [(0.0, 0), (0.0, 0)]
    for batch in batches:
        arrays = batch_to_device(batch.arrays(), "cuda")
        cap1, cap2, ref, *more = (
            {k: v.item() for k, v in step(arrays).items()}
            for step in (captured, captured, eager, eager))
        spread = tuple(max(x) for x in zip(*(gaps(m, ref) for m in more)))
        exact = all(m == ref for m in more)
        limit = (max(COMPILED_SPREAD * spread[0], COMPILED_FLOOR["loss"]),
                 0 if exact else max(1, int(COMPILED_SPREAD * spread[1])))
        for got, what in ((cap1, "capturing"), (cap2, "replayed")):
            gap = gaps(got, ref)
            if got["n_tok"] != ref["n_tok"] or not (
                    gap[0] <= limit[0] and gap[1] <= limit[1]):
                fail(f"{tag} ({describe(batch)}): the {what} eval step "
                     f"gives {got}, uncaptured {ref} (loss gap "
                     f"{gap[0]:.3e} of at most {limit[0]:.3e}, {gap[1]} "
                     f"argmax flips of at most {limit[1]})")
        worst = [tuple(map(max, worst[0], spread)),
                 tuple(map(max, worst[1], gaps(cap1, ref), gaps(cap2, ref)))]
    if graphs.replays - replays < len(batches):
        fail(f"{tag}: {graphs.replays - replays} replays over "
             f"{2 * len(batches)} captured eval calls")
    if not torch.equal(model.dropout_rng.get_state(), rng):
        fail(f"{tag}: an eval step drew from the dropout generator")
    print(f"[{tag}] {len(batches)} batches: loss gaps uncaptured "
          f"{worst[0][0]:.3e}, captured {worst[1][0]:.3e}; argmax flips "
          f"uncaptured {worst[0][1]}, captured {worst[1][1]}; the dropout "
          "generator untouched", flush=True)


def replay_kernels(label, run, kernels, planted=None):
    """Each kernel of `kernels` inside a replay against its plain version:
    `run()` is a captured step whose first call captures (the wrappers
    record each kernel's first call in the capture, whose tensors the
    graph rewrites at every replay) and whose second call replays; then
    each recorded output is held against the plain version of the
    recorded inputs (the bench's check_kernel: KERNEL_TOL and its rtol of
    the largest value; B6b's bank rows one by one, and its work list
    must cover each real place once: work_list_covers). planted: what the
    kernels' wrappers were replaced with (kernel_calls.replaced), which
    must fail that check."""
    import torch

    from gtos_tpu_torch.bench import BenchFailure, check_kernel, plain_call
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
        work_list_covers)

    store = {}

    def make(kernel, real):
        if kernel not in kernels:
            return real

        def rec(*args, **kw):
            out = real(*args, **kw)
            if torch.cuda.is_current_stream_capturing() and \
                    kernel not in store:
                store[kernel] = (args, kw, out)
            return out
        return rec

    with kernel_calls.kernels_wrapped(make):
        run()
        run()
        torch.cuda.synchronize()
    for kernel in kernels:
        if kernel not in store:
            fail(f"{label}: {kernel} was not captured")
        args, kw, out = store[kernel]
        named = kernel_calls.named(kernel, args, kw)
        if kernel == "B6b" and planted is None and not bool(
                work_list_covers(named["plan"], named["a_bank"].shape[0])):
            fail(f"inside a replay of {label}: B6b's work list does not "
                 "cover each real place once with its own bank row")
        try:
            err, rel, rows = check_kernel(kernel, label, out,
                                          plain_call(kernel, named)())
        except BenchFailure as e:
            if planted is None:
                fail(f"inside a replay: {e}")
            print(f"[compiled kernels] planted {kernel} ({planted}) inside "
                  f"a replay of {label} fails its gate: {e}", flush=True)
            continue
        if planted is not None:
            fail(f"inside a replay of {label}: the planted {kernel} "
                 f"({planted}) passes its gate")
        by_row = ("" if rows is None else
                  f"; bank rows {rows:.3e} of their largest values beyond "
                  f"one rounding (within {BANK_ROW_TOL}; the work list "
                  "covers each real place once)")
        print(f"[compiled kernels] {kernel} inside a replay of {label}: "
              f"max_abs_err {err:.3e}, {rel:.3e} of the largest value "
              f"(within {KERNEL_TOL}){by_row}", flush=True)


def encode_graph(model, batch):
    """A function that encodes the batch as a CUDA graph: its first call
    captures Generator.encode (on static copies of the batch's arrays),
    each later call replays it and returns the graph's output."""
    import torch

    from gtos_tpu_torch.models.generator import batch_edges, batch_to_device
    from gtos_tpu_torch.utils import graphs

    cache = graphs.Graphs(model.device, True)
    static = cache.inputs("encode", batch_to_device(batch.arrays(),
                                                    model.device))

    def encode_static():
        return model.encode(static["concept"], static["concept_char"],
                            static["concept_mask"], static["rel_bank"],
                            static["rel_length"], static["rel_index"],
                            edges=batch_edges(static))

    def run():
        with torch.inference_mode():
            return cache.run("encode", encode_static)
    run.graphs = cache
    return run


def captured_encode(model, batch):
    """Generator.encode of a batch as a CUDA graph's replay, f32 on the
    CPU."""
    run = encode_graph(model, batch)
    run()
    out = run()
    if run.graphs.replays != 1:
        fail("the captured encode did not replay")
    return out.float().cpu()


def captured_loss_and_grads(model, arrays):
    """loss_and_grads as a CUDA graph's replay (captured on the first
    call, replayed on the second; the kernels launch twice)."""
    import torch

    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.utils import graphs

    if model.device.type != "cuda":
        return loss_and_grads(model, arrays)
    cache = graphs.Graphs(model.device, True)
    names, params = zip(*model.named_parameters())
    static = cache.inputs("grads", batch_to_device(arrays, model.device))

    def run():
        model.train()
        loss, _ = model(static)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [loss.detach()] + [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(params, grads)]

    cache.run("grads", run)
    out = cache.run("grads", run)
    return out[0].item(), {n: g.float().cpu() for n, g in
                           zip(names, out[1:])}


def compiled_serve(family, impl="pallas_local"):
    """(d): the fullest batch of every node bucket of the family's
    serving loader under `impl` (c5: its own loader, "block_sparse"),
    searched uncaptured (compiled=False) twice and on the graphs twice
    (capture, then replay): tokens, lengths and the final t must be
    equal, the scores as close as the uncaptured runs' (COMPILED_SPREAD,
    COMPILED_FLOOR of the largest score: the copy mix lands its mass with
    a scatter-add, whose sums of colliding copy targets run in no fixed
    order). Where the two uncaptured searches of a route in
    UNREPRODUCIBLE_SEARCH already differ in their tokens, the captured
    searches' best hypotheses may differ from the first uncaptured one's in
    COMPILED_SPREAD times as many requests as the second one's do, at
    least one, and their scores must be finite."""
    import torch

    from gtos_tpu_torch.infer.decode import beam_decode_arrays, search_graphs
    from gtos_tpu_torch.models import Generator

    tag = tag_of("compiled serve", impl, family)
    if family == "c5":
        cfg, _ = c5_configs()
        model = Generator(cfg, device="cuda",
                          rng=torch.Generator().manual_seed(0))
        tv = c5_corpus()[1][0]
        loader = c5_loader(False)
    else:
        cfg, model, loader, tv = serving_setup(impl, family=family)
    fullest = {}
    for batch, insts in loader.iter_with_instances():
        N = batch.concept_mask.shape[1]
        if N not in fullest or len(insts) > len(fullest[N][1]):
            fullest[N] = (batch, insts)
    graphs = search_graphs(model)
    for N in sorted(fullest):
        batch = fullest[N][0]
        arrays = batch.arrays()
        kw = dict(beam_size=BEAM, max_steps=MAX_STEPS, **_ids(tv))
        runs, ms = [], []
        for compiled in (False, False, None, None):
            t0 = time.perf_counter()
            runs.append(beam_decode_arrays(model, arrays, compiled=compiled,
                                           **kw))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        eager = runs[0]

        def score_gap(res):
            return (res.scores - eager.scores).abs().max().item()

        def rows_differ(res):   # requests whose best hypothesis differs
            return int((res.seqs[:, 0] != eager.seqs[:, 0]).any(-1).sum())

        if impl in UNREPRODUCIBLE_SEARCH and not all(
                torch.equal(getattr(runs[1], f), getattr(eager, f))
                for f in ("seqs", "lengths", "steps")):
            limit = max(1, int(COMPILED_SPREAD * rows_differ(runs[1])))
            for res, what in ((runs[2], "capturing"), (runs[3], "replayed")):
                if not (rows_differ(res) <= limit
                        and bool(res.scores.isfinite().all())):
                    fail(f"{tag} N={N}: the {what} search's best "
                         f"hypotheses differ from the uncaptured search's "
                         f"in {rows_differ(res)} requests, over {limit}, "
                         "or its scores are not finite")
            print(f"[{tag}] N={N} ({describe(batch)}): the uncaptured "
                  f"searches differ in their tokens: best hypotheses "
                  f"differ in {rows_differ(runs[1])} of {len(eager.seqs)} "
                  f"requests uncaptured, {rows_differ(runs[2])} / "
                  f"{rows_differ(runs[3])} captured (at most {limit}); "
                  f"ms uncaptured {ms[0]:.3f} / {ms[1]:.3f}, capturing "
                  f"{ms[2]:.3f}, replayed {ms[3]:.3f}", flush=True)
            continue
        spread = score_gap(runs[1])
        limit = max(COMPILED_SPREAD * spread, COMPILED_FLOOR["score"]
                    * eager.scores.abs().max().item())
        for res, what in ((runs[1], "second uncaptured"),
                          (runs[2], "capturing"), (runs[3], "replayed")):
            for field in ("seqs", "lengths", "steps"):
                if not torch.equal(getattr(res, field),
                                   getattr(eager, field)):
                    fail(f"{tag} N={N}: the {what} search's {field} differ "
                         "from the uncaptured search's")
            if not score_gap(res) <= limit:
                fail(f"{tag} N={N}: the {what} search's scores differ by "
                     f"{score_gap(res):.3e}, over {limit:.3e}")
        print(f"[{tag}] N={N} ({describe(batch)}): {int(eager.steps)} "
              f"steps; tokens, lengths and final t equal; score gaps "
              f"uncaptured {spread:.3e}, captured "
              f"{max(score_gap(runs[2]), score_gap(runs[3])):.3e}; ms "
              f"uncaptured {ms[0]:.3f} / {ms[1]:.3f}, capturing "
              f"{ms[2]:.3f}, replayed {ms[3]:.3f}", flush=True)
    print(f"[{tag}] {graphs.captures} graphs, pool "
          f"{(graphs.pool_bytes() or 0) / 2 ** 20:.1f} MiB", flush=True)
    return model, tv, fullest


def profile_steps(label, step, steps_per_call, n, card, graphs=None,
                  warm=1):
    """(f), printed: `n` calls of `step` under torch.profiler, after `warm`
    calls: host calls that launch work on the card (LAUNCH_APIS) a step,
    device kernels and copies a step, busy ms a step, idle share of the
    wall, and the graph pool's size and capture ms. Returns (the
    profiler's key averages, steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = sum(steps_per_call(step()) for _ in range(n))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in LAUNCH_APIS)
    work = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in work) / 1e3
    pool = ("" if graphs is None or graphs.pool_bytes() is None else
            f", graph pool {graphs.pool_bytes() / 2 ** 20:.1f} MiB, "
            f"capture ms per signature "
            f"{sorted(round(v, 3) for v in graphs.capture_ms().values())}")
    print(f"[compiled profile] {label}: {launches / steps:.2f} host launch "
          f"calls a step, {sum(e.count for e in work) / steps:.1f} device "
          f"kernels and copies a step, busy {busy / steps:.3f} ms a step, "
          f"idle {1 - busy / (wall * 1e3):.3f} of {wall * 1e3 / n:.3f} ms "
          f"a call ({steps} steps){pool}; card {card}", flush=True)
    return events, steps


def phase_compiled():
    """The compiled step and search (ROADMAP A11): (a) c2 "pallas_local"
    training at full width with dropout, eager against captured, within
    the eager-vs-eager spread; (b) the same for c2 "pallas", "sparse" and
    "xla", for c4 and for c5 "block_sparse", and each run's eval step
    captured against uncaptured; (c) a resume on the captured path gives
    the unbroken captured run's losses (phase_resume and phase_c5_resume,
    whose Trainers run the graphs);
    (d) serving c2 ("pallas_local", "sparse", "xla"), c4 and c5 on every
    bucket, the captured search equal to the uncaptured one ((a), (b) and
    (d) under deterministic algorithms, their graphs dropped after); (e)
    planted wrong B1s and B2s fail the encoder and
    gradient gates on the captured path, and B1 and B1p, B2 (c2 and c4),
    B3, B3', B4 (c2), B5 (c5 serving) and B5s, B6d, B6s and B6b (a c5
    train step; B6b on the planted work lists of B6B_PLANTS must fail)
    match their plain versions inside replays; (f) printed: host launch calls, device kernels, busy ms
    and idle share of a captured train or decode step, with the graph
    pool and capture times."""
    import torch

    from gtos_tpu_torch.infer.decode import beam_decode_arrays, search_graphs
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.train.trainer import EAGER_MESH
    from gtos_tpu_torch.utils.graphs import for_model

    card = card_line()
    t_start = time.perf_counter()
    print(f"[compiled] uncaptured on the card: {EAGER_MESH}", flush=True)
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[compiled] {name} in {now - t_part:.1f} s", flush=True)
        t_part = now

    # (a), (b), (d) compare runs under deterministic algorithms (the
    # COMPILED_SPREAD note), then drop their graphs: the gates of (e), the
    # profiles of (f) and the resume (c) run graphs of the default ones
    trainers = {}
    with deterministic_algorithms():
        for family, impl in COMPILED_BATCHES:
            trainers[(family, impl)] = compiled_train(family, impl)
            trainer, batches = trainers[(family, impl)]
            compiled_eval(family, impl, trainer.model, batches)
            torch.cuda.empty_cache()
        part("(a), (b) training and evaluation")
        # (c) is phase_resume's: its Trainers run the graphs, and the
        # resumed run must replay
        served = {key: compiled_serve(*key) for key in COMPILED_SERVE}
        part("(d) serving")
    for trainer, _ in trainers.values():
        for_model(trainer.model).clear()
    for model, _, _ in served.values():
        for_model(model).clear()
        search_graphs(model).clear()
    torch.cuda.empty_cache()
    # (e): the gates on the captured path, and the kernels inside replays
    cfg, model, tv, fullest = (configs("c2")[0],
                               *served[("c2", "pallas_local")])
    batch = fullest[min(fullest)][0]
    phase_encoder_check(cfg, model, batch, tag="compiled encode",
                        encoder=captured_encode)
    part("(e) encoder gate")
    phase_grads(tag="compiled grads", grads=captured_loss_and_grads, runs=2)
    part("(e) gradient gate")
    for family, impl, kernel in (("c2", "pallas_local", "B1"),
                                 ("c4", "pallas_local", "B1"),
                                 ("c5", "block_sparse", "B5")):
        fam_model, _, fam_fullest = served[(family, impl)]
        replay_kernels(f"{family} serving encode", encode_graph(
            fam_model, fam_fullest[min(fam_fullest)][0]), (kernel,))
    for family, impl, fwd, kernels in (
            ("c2", "pallas_local", B1, ("B1p", "B2")),
            ("c4", "pallas_local", B1, ("B1p", "B2")),
            ("c2", "pallas", B3I, ("B3'", "B4"))):
        trainer, batches = trainers[(family, impl)]
        pick = next(b for b in batches
                    if route_of(impl, b.arrays(), cfg)[1] == fwd)
        arrays = batch_to_device(pick.arrays(), "cuda")
        replay_kernels(f"a {family} {impl} train step ({describe(pick)})",
                       lambda: trainer.train_step(arrays), kernels)
    # c5: the forward and the three backward kernels, B6b walking the
    # backward plan built inside the step; then B6b on each planted work
    # list must fail the same gate
    trainer, batches = trainers[("c5", "block_sparse")]
    arrays = batch_to_device(batches[0].arrays(), "cuda")
    label = f"a c5 block_sparse train step ({describe(batches[0])})"
    replay_kernels(label, lambda: trainer.train_step(arrays),
                   ("B5s", "B6d", "B6s", "B6b"))
    for kind in B6B_PLANTS:
        with replaced(*planted_b6b_list(kind)):
            replay_kernels(label, lambda: trainer.train_step(arrays),
                           ("B6b",), planted=kind)
    part("(e) kernels inside replays")
    # (f): the captured paths (the bench's --checkout holds them against
    # the parent's uncaptured ones)
    for (family, impl), (trainer, batches) in trainers.items():
        on_card = [batch_to_device(b.arrays(), "cuda") for b in batches]
        it = iter(range(10 ** 9))
        profile_steps(
            f"{family} {impl} train step, captured",
            lambda: trainer.train_step(on_card[next(it) % len(on_card)]),
            lambda m: 1, PROFILED_STEPS, card, trainer._step.graphs,
            warm=len(on_card))
    for (family, impl), (model, tv, fullest) in served.items():
        arrays = fullest[min(fullest)][0].arrays()
        profile_steps(
            f"{tag_of('decode', impl, family)}, N={min(fullest)}, "
            "captured",
            lambda: beam_decode_arrays(model, arrays, beam_size=BEAM,
                                       max_steps=MAX_STEPS, **_ids(tv)),
            lambda res: int(res.steps), 1, card, search_graphs(model))
    part("(f) profiles")
    print(f"[compiled] phase in {time.perf_counter() - t_start:.1f} s",
          flush=True)


# phase_mesh_compiled: the cells whose mesh step is captured against
# uncaptured (MESH_BATCHES of each, twice, so that every signature
# replays), those profiled and timed, and the timed repeats
MESH_COMPILED = (("c2", "pallas_local"), ("c2", "pallas"),
                 ("c4", "pallas_local"), ("c5", "block_sparse"))
MESH_BATCHES = 3
MESH_TIMED = (("c2", "pallas_local"), ("c5", "block_sparse"))
MESH_REPEATS = 5
# the kernels a captured mesh train step launches, by route: (forward
# kernels, which together launch once a layer, and backward kernels, each
# once a layer)
MESH_ROUTE_KERNELS = {"pallas_local": (("B1p",), ("B2",)),
                      "pallas": (("B3", "B3'"), ("B4",)),
                      "block_sparse": (("B5s",), ("B6d", "B6s", "B6b"))}


# phase_mesh_compiled (b): planted faults in the dropout generator's
# registration with the mesh step's graphs
MESH_PLANTS = {
    "left out": "the dropout generator left out of every graph but the "
                "first signature's",
    "advance undone": "the dropout generator set back after each replay, "
                      "so that every replay redraws the masks of the one "
                      "before"}


def mesh_run(family, impl, batches, compiled, mesh, plant=None):
    """Trainer(mesh=mesh).train_step over the batches twice from one
    seeded start (weights seed 0, the config's dropout): (losses, state:
    parameters, Adam's moments and count, the dropout generator's state;
    the trainer). plant: a key of MESH_PLANTS."""
    import torch

    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.trainer import Trainer, check_metrics

    cfg, tcfg = configs(family, impl)
    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, tcfg, batches[0].arrays(), device="cuda",
                      compiled=compiled, mesh=mesh)
    if plant is not None:
        plant_registration(trainer, plant)
    on_card = [trainer._put(b.arrays()) for b in batches] * 2
    metrics = [trainer.train_step(a) for a in on_card]
    for m in metrics:
        check_metrics(m)
    st = trainer.opt.state
    state = dict(tensors=[t.detach().clone() for t in
                          [*trainer.params, *st["mu"], *st["nu"]]],
                 count=int(st["count"]), rng=model.dropout_rng.get_state())
    return [m["loss"].item() for m in metrics], state, trainer


def plant_registration(trainer, plant):
    """Patch the trainer's graph cache with the fault MESH_PLANTS[plant]
    in the dropout generator's registration."""
    graphs, first, rng = trainer._step.graphs, [], trainer.model.dropout_rng
    sound = graphs.run

    def left_out(key, fn, generators=()):
        first[:] = first or [key]
        return sound(key, fn, generators if key == first[0] else ())

    def advance_undone(key, fn, generators=()):
        if key not in graphs.graphs:
            return sound(key, fn, generators)
        state = rng.get_state()
        out = sound(key, fn, generators)
        rng.set_state(state)
        return out

    graphs.run = {"left out": left_out,
                  "advance undone": advance_undone}[plant]


def same_bits(a, b) -> bool:
    """Two mesh_runs end with the same losses, state and generator."""
    import torch

    (la, sa, _), (lb, sb, _) = a, b
    return (la == lb and sa["count"] == sb["count"]
            and torch.equal(sa["rng"], sb["rng"])
            and all(torch.equal(x, y) for x, y in zip(sa["tensors"],
                                                      sb["tensors"])))


def mesh_eval(tag, captured, eager, batches):
    """The mesh eval step of two trainers whose parameters are the same
    bits: captured (the first call of a signature captures, the second
    replays) against uncaptured, the same metrics bit for bit."""
    for batch in batches:
        raw = batch.arrays()
        got = [captured._eval_step(captured._put(raw)) for _ in range(2)]
        got = [{k: v.item() for k, v in m.items()} for m in got]
        ref = {k: v.item() for k, v in
               eager._eval_step(eager._put(raw)).items()}
        if any(m != ref for m in got):
            fail(f"{tag} ({describe(batch)}): the captured mesh eval step "
                 f"gives {got}, uncaptured {ref}")


def mesh_launches(tag, impl, trainer, steps):
    """The kernel launches of a captured mesh run (counts zeroed before
    it; a replay adds what its capture recorded): the route's forward
    kernels enc_layers a step together, each backward kernel
    enc_layers a step, and no other kernel."""
    by_id = {KERNELS[name][0]: n for name, n in read_counts().items() if n}
    fwd, bwd = MESH_ROUTE_KERNELS[impl]
    want = trainer.model.cfg.enc_layers * steps
    print(f"[{tag}] kernel launches over {steps} steps: {by_id}",
          flush=True)
    if (sum(by_id.get(k, 0) for k in fwd) != want
            or any(by_id.get(k, 0) != want for k in bwd)
            or set(by_id) - set(fwd) - set(bwd)):
        fail(f"{tag}: launches {by_id}, {want} expected of {fwd} together "
             f"and of each of {bwd}")


def mesh_plants(family, impl, batches, mesh, eager):
    """(b): each of MESH_PLANTS on a captured mesh run of the batches
    must give other bits than the uncaptured run `eager`, or PyTorch must
    refuse its capture."""
    for plant, what in MESH_PLANTS.items():
        try:
            passed = same_bits(mesh_run(family, impl, batches, None, mesh,
                                        plant), eager)
            said = f"the same bits as compiled=False: {passed}"
        except RuntimeError as e:
            passed, said = False, f"PyTorch refused the capture: {e}"
        print(f"[mesh compiled] planted {what}: {said}"[:400], flush=True)
        if passed:
            fail(f"a mesh run with {what} passed gate (a)")


def time_steps(trainer, on_card):
    """ms a step from memory: MESH_REPEATS passes over the batches after
    one warm-up pass, each pass's wall (synchronized) over its steps."""
    import torch

    out = []
    for i in range(MESH_REPEATS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in on_card:
            trainer.train_step(a)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / len(on_card))
    return out[1:]


def phase_mesh_compiled():
    """The mesh step captured (ROADMAP A11 item 2), in this process on a
    data-parallel mesh of one NCCL rank (its token-count, metric and
    gradient all-reduces run on the card): (a) for each cell of
    MESH_COMPILED its first MESH_BATCHES train batches twice, the mesh
    Trainer captured against the same Trainer with compiled=False from the
    same weights and seed, under deterministic algorithms: every loss,
    parameter, moment, Adam's count and the dropout generator the same
    bits, and the mesh eval step captured against uncaptured on the same
    batches the same bits, the captured run's kernel launches those of
    its route (MESH_ROUTE_KERNELS); (b) on the first cell, each of
    MESH_PLANTS
    must fail (a) or be refused by PyTorch at its capture; (c) for
    MESH_TIMED,
    printed: a profile of a replayed mesh step (host launch calls, device
    kernels, NCCL kernels, busy ms, idle share, pool MiB, capture ms)
    against an uncaptured one, whose host launch calls must be at least
    10x the replay's; (d) the mesh step from memory captured and uncaptured,
    median [min-max] of MESH_REPEATS passes after a warm-up, beside the
    card line."""
    import torch
    import torch.distributed as dist

    from gtos_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from gtos_tpu_torch.utils.graphs import for_model

    card = card_line()
    t_start = t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[mesh compiled] {name} in {now - t_part:.1f} s", flush=True)
        t_part = now

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_nccl_", dir=ROOT)
    init_distributed(0, 1, f"file://{os.path.join(tmp, 'rdv')}", "cuda")
    try:
        mesh = make_mesh(dp=1)
        print(f"[mesh compiled] {mesh.shape}, backend {mesh.backend}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}",
              flush=True)
        for family, impl in MESH_COMPILED:
            tag = tag_of("mesh compiled", impl, family)
            batches = compiled_batches(family, impl)[:MESH_BATCHES]
            with deterministic_algorithms():
                eager = mesh_run(family, impl, batches, False, mesh)
                zero_counts()
                got = mesh_run(family, impl, batches, None, mesh)
                trainer = got[2]
                mesh_launches(tag, impl, trainer, len(got[0]))
                graphs = trainer._step.graphs
                path = trainer.step_path(batches[0].arrays())
                same = same_bits(got, eager)
                print(f"[{tag}] {len(batches)} batches twice "
                      f"({', '.join(describe(b) for b in batches)}): step "
                      f"{path}; {graphs.captures} signatures captured, "
                      f"{graphs.replays} replays; losses, parameters, "
                      f"moments, count and generator the same bits as "
                      f"compiled=False: {'yes' if same else 'no'}; losses "
                      f"{got[0]}", flush=True)
                if path != "captured" or graphs.replays < len(batches):
                    fail(f"{tag}: step {path}, {graphs.replays} replays")
                if not same:
                    fail(f"{tag}: the captured mesh step does not give the "
                         f"uncaptured one's bits (losses {got[0]} against "
                         f"{eager[0]})")
                mesh_eval(tag, trainer, eager[2], batches)
                print(f"[{tag}] eval step captured against uncaptured on "
                      f"the {len(batches)} batches: the same bits",
                      flush=True)
                if (family, impl) == MESH_COMPILED[0]:
                    mesh_plants(family, impl, batches, mesh, eager)
            part(f"{tag} (a), (b)")
            if (family, impl) in MESH_TIMED:
                # (c), (d) on graphs of the default algorithms
                for_model(trainer.model).clear()
                on_card = [trainer._put(b.arrays()) for b in batches]
                # one step profiled, after a pass that captures anew
                for run, label in ((trainer, "captured"),
                                   (eager[2], "uncaptured")):
                    it = iter(range(10 ** 9))
                    events, steps = profile_steps(
                        f"{tag} step, {label}",
                        lambda: run.train_step(
                            on_card[next(it) % len(on_card)]),
                        lambda m: 1, 1, card,
                        run._step.graphs if run is trainer else None,
                        warm=len(on_card) if run is trainer else 0)
                    nccl = sum(e.count for e in events
                               if e.device_type.name == "CUDA"
                               and "nccl" in e.key.lower())
                    launches = sum(e.count for e in events
                                   if e.key in LAUNCH_APIS) / steps
                    print(f"[{tag}] {label}: {nccl / steps:.1f} NCCL kernels "
                          "a step" + ("" if nccl else
                                      ": NCCL launches no kernel for a "
                                      "one-rank all-reduce, so the card "
                                      "checks the captured collectives' "
                                      "calls, not NCCL inside a replay"),
                          flush=True)
                    if run is trainer:
                        captured_launches = launches
                    elif not launches >= 10 * captured_launches:
                        fail(f"{tag}: {captured_launches:.1f} host launch "
                             f"calls a replayed step against {launches:.1f}"
                             " uncaptured")
                ms = [time_steps(r, on_card) for r in (trainer, eager[2])]
                print(f"[{tag}] step from memory ({len(on_card)} batches, "
                      f"{MESH_REPEATS} repeats after a warm-up): captured "
                      f"{np.median(ms[0]):.3f} [{min(ms[0]):.3f}-"
                      f"{max(ms[0]):.3f}] ms, uncaptured "
                      f"{np.median(ms[1]):.3f} [{min(ms[1]):.3f}-"
                      f"{max(ms[1]):.3f}] ms; card {card}", flush=True)
                part(f"{tag} (c), (d)")
            del eager, got, trainer, graphs
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[mesh compiled] phase in {time.perf_counter() - t_start:.1f} s",
          flush=True)


def _metrics(node, path="cells"):
    """Every metric of a bench result (a dict with "unit" and "median"),
    with its path."""
    if isinstance(node, dict):
        if "unit" in node and "median" in node:
            yield path, node
            return
        for k, v in node.items():
            yield from _metrics(v, f"{path}.{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _metrics(v, f"{path}[{i}]")


def phase_bench():
    """The port's bench (gtos_tpu_torch/bench.py) in this process on
    BENCH_CELLS with BENCH_REPEATS repeats: its last line must parse as
    JSON, every metric in it be measured (n >= BENCH_REPEATS) with
    positive, finite numbers, every kernel row give event ms, device ms,
    plain ms and its bound, and no reading (north-star ms, each kernel
    row's event and device ms) fall below BOUND_SLACK x its bound.
    Returns the bench's kernel rows."""
    import io

    from gtos_tpu_torch import bench
    from gtos_tpu_torch.utils.benchlib import BOUND_SLACK

    out = os.path.join(ROOT, "chiprun_out", "bench", "chip_smoke")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench.main(["--cells", *BENCH_CELLS, "--repeats",
                    str(BENCH_REPEATS), "--out", out])
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines[:-1]:
        print(line if line.startswith("[bench]") else f"[bench] {line}")
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError) as e:
        fail(f"the bench's last line is not JSON: {e}")
    cells = result["cells"]
    if sorted(cells) != sorted(BENCH_CELLS):
        fail(f"the bench ran {sorted(cells)}, {BENCH_CELLS} asked")
    for path, m in _metrics(cells):
        values = [m[k] for k in ("median", "min", "max", "q1", "q3")]
        if m["n"] < BENCH_REPEATS or not all(
                v is not None and v > 0 and np.isfinite(v) for v in values):
            fail(f"bench metric {path}: {m}")
    ns = cells["north_star_local"]
    for name in ("b1", "b1p_b2"):
        low = ns["metrics"][f"{name}_ms"]["min"]
        if low < BOUND_SLACK * ns["info"][f"{name}_bound_ms"]:
            fail(f"bench north star {name}: {low} ms beats its bound")
    for side in ("serve", "train"):
        ratio = ns["metrics"][f"{side}_vs_baseline"]["value"]
        print(f"[bench] north star {side}: "
              f"{ns['metrics'][f'{side}_edges_per_s']['median']:.4g} edges/s"
              f", dense reference {ns['metrics'][f'dense_{side}_edges_per_s']['median']:.4g}"  # noqa: E501
              f", vs_baseline {ratio:.3f}", flush=True)
        if not ratio > 0:
            fail(f"bench north star {side}: vs_baseline {ratio}")
    rows = cells["kernels"]["rows"]
    if {r["kernel"] for r in rows} != {k for k, _ in
                                       bench.Bench.KERNEL_SOURCES}:
        fail(f"bench kernel rows {[r['kernel'] for r in rows]}")
    for r in rows:
        for key in ("ms", "device_ms"):
            if r[key]["min"] < BOUND_SLACK * r["bound_ms"]:
                fail(f"bench {r['kernel']} ({r['source']}): {key} "
                     f"{r[key]['min']} beats its bound {r['bound_ms']}")
        print(f"[bench] {r['kernel']} ({r['source']}): "
              f"{r['ms']['median']:.6f} ms (events, median of "
              f"{r['ms']['n']}), {r['device_ms']['median']:.6f} ms device, "
              f"bound {r['bound_ms']:.6f} ({r['bound_by']}), plain "
              f"{r['plain_ms']['median']:.6f}", flush=True)
    print(f"[bench] phase took {seconds:.1f} s; JSON in {out}", flush=True)
    return rows


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the served batches and a train step "
                         "on the card")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    # before cuBLAS's first call: its deterministic setting, which
    # phase_compiled's comparisons ask for
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, ROOT)
    import gtos_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = last = time.perf_counter()
    laps = []

    def lap(name):      # each group of phases' seconds, printed
        nonlocal last
        now = time.perf_counter()
        laps.append(f"{name} {now - last:.1f}")
        print(f"[time] {name}: {now - last:.1f} s", flush=True)
        last = now

    phase_build()
    lap("build")
    phase_kernels()
    phase_global_edges()
    phase_block_kernels()
    lap("kernels")
    torch.cuda.empty_cache()   # free the plain versions' GBs before serving
    # "pallas_local": serving, encoder check, training, grads, resume
    cfg, model, tv, batches, seconds, serve_launches = phase_serve()
    phase_encoder_check(cfg, model, batches[0])
    b1_inputs = capture_b1_inputs(model, batches)
    trainer, ms_step, train_launches, _ = phase_train()
    phase_grads()
    phase_resume()
    train_batches = [b for _, b in zip(range(CAPTURE_BATCHES),
                                       train_loader())]
    phase_localize(train_batches)
    train_inputs = capture_train_inputs(trainer, train_batches)
    rows = phase_main_shapes(b1_inputs, serve_launches, train_inputs,
                             train_launches)
    lap("pallas_local")
    torch.cuda.empty_cache()
    # "pallas": the global-bank kernels B3, B3' and B4
    _, g_model, _, g_batches, _, g_serve_launches = phase_serve("pallas")
    g_serve_inputs = capture_global_inputs(g_model, g_batches, train=False)
    del g_model
    g_trainer, g_ms_step, g_train_launches, g_train_batches = \
        phase_train("pallas")
    g_train_inputs = capture_global_inputs(
        g_trainer.model, g_train_batches[:CAPTURE_BATCHES]
        + g_train_batches[-CAPTURE_BATCHES:], train=True)
    if not args.profile:
        del g_trainer
    torch.cuda.empty_cache()
    phase_grads("pallas")
    phase_resume("pallas")
    torch.cuda.empty_cache()
    phase_auto()
    phase_work()
    lap("pallas, auto, work")
    rows += phase_global_shapes(g_serve_inputs, g_serve_launches,
                                g_train_inputs, g_train_launches)
    lap("global shapes")
    del g_serve_inputs, g_train_inputs
    torch.cuda.empty_cache()
    # the c4 translator under "pallas_local", its CLIs on CoNLL files; the
    # host pipeline (native extractor, worker pools); batch_multiple
    rows += phase_c4(args.profile)
    phase_work_nmt()
    lap("c4, work nmt")
    phase_host()
    phase_batch_multiple()
    lap("host, batch_multiple")
    if not args.profile:
        del trainer, model
    torch.cuda.empty_cache()
    # "block_sparse": the c5 model and the kernels B5, B5s, B6d, B6s, B6b
    rows += phase_block_sparse(args.profile)
    lap("c5 block_sparse")
    torch.cuda.empty_cache()
    # the multi-device tier: a mesh of one NCCL rank, the rings emulated
    rows += phase_mesh()
    lap("mesh")
    torch.cuda.empty_cache()
    # the compiled step and search: CUDA graphs against eager
    phase_compiled()
    lap("compiled")
    torch.cuda.empty_cache()
    # the mesh step captured: a data-parallel mesh of one NCCL rank
    phase_mesh_compiled()
    lap("mesh compiled")
    # the port's bench on its north-star and kernel cells; the kernel
    # rows take its times
    rows = bench_timed(rows, phase_bench())
    lap("bench")
    if args.profile:
        phase_profile(model, tv, batches, seconds)
        phase_profile_train(trainer, ms_step)
        phase_profile_train(g_trainer, g_ms_step, "pallas")
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s "
          f"({', '.join(laps)})", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
