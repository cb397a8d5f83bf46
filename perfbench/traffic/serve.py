"""The serving traffic: offline decoding of a test set with the work CLI's
loop: the requests' file read with the program's reader, the loader of
`for_train=False` batches in its plan order, and `decode_batch` with the
CLI's search settings, the hypotheses post-processed as the CLI writes
them.

Parameters (the workload file's "params"):
  train_graphs    the size of the training corpus whose vocabularies the
                  served model has (made from the seed)
  requests        the test set's size (made from the seed + 1)
  batch_tokens, beam, alpha, max_time_step   the work CLI's
  sample          requests the check compares (the longest among them)
  trace_seconds   the traced run's profiled share of the window (null:
                  all of it)

Set-up builds the vocabularies, preprocesses the requests, builds the
model with the benchmark's weights, batches one pass of the plan and
decodes the first batch of each batch signature, so that every search
graph of the plan is captured. The window then decodes the test set pass
after pass, batching each batch anew, and ends with the pass in hand once
`--seconds` have passed: a user decodes whole test sets, and the plan
runs in the loader's order (small graphs in large batches first), so a
window ending inside a pass would hold another mix wherever it ended. A
request's latency runs from the start of building its batch to its
hypothesis string; its 95th percentile is a
per-layer reading of the traced run (the cell decodes back to back, at
saturation, where the throughput is what a user of a test-set decode
pays for and a tail swings with the batches a window happens to hold).
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from perfbench.harness import program, work
from perfbench.harness.trace import Profile, Spans
from perfbench.reference import batch_check
from perfbench.reference.model import Reference, init_weights, param_spec


def _signature(arrays):
    return tuple((k, v.shape, v.dtype.str) for k, v in sorted(arrays.items()))


class Served:
    """The search results of the window's batches, kept on the card until
    the window closes: decode.beam_decode_arrays's result per call."""

    def __init__(self, decode_module):
        self.mod = decode_module
        self.real = decode_module.beam_decode_arrays
        self.results = []

    def __enter__(self):
        def kept(*a, **kw):
            res = self.real(*a, **kw)
            self.results.append((res.seqs[:, 0], res.scores[:, 0],
                                 res.lengths[:, 0], res.steps))
            return res
        self.mod.beam_decode_arrays = kept
        return self

    def __exit__(self, *exc):
        self.mod.beam_decode_arrays = self.real
        return False


def run(ctx) -> dict:
    from gtos_tpu_torch.data.postprocess import postprocess_hypothesis
    from gtos_tpu_torch.infer import decode
    from gtos_tpu_torch.infer.decode import decode_batch

    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    params, config = cell["params"], ctx.config
    t_setup = time.perf_counter()
    train = ctx.generate(params["train_graphs"], seed)
    vocabs = program.vocabularies(
        program.read(config["task"], train, ctx.workdir, "train"))
    reqs = program.read(config["task"], ctx.generate(params["requests"],
                                                     seed + 1),
                        ctx.workdir, "requests")
    cfg = program.sizes(config, vocabs)
    dl = program.loader(program.preprocess(reqs), vocabs, cfg,
                        params["batch_tokens"], False)
    tv = vocabs[0]
    search = dict(beam_size=params["beam"], alpha=params["alpha"],
                  max_steps=params["max_time_step"])
    spans = Spans(ctx.trace)
    model = program.model(cfg, seed, device)
    if ctx.plant:
        ctx.plant(model)
    seen = set()
    for batch, _ in dl.iter_with_instances():    # warm every signature
        sig = _signature(batch.arrays())
        if sig not in seen:
            seen.add(sig)
            decode_batch(model, batch, tv, **search)
    ctx.sync()
    setup_s = time.perf_counter() - t_setup

    # ---- the window
    graphs = decode.search_graphs(model)
    captured = graphs.captures
    batches, latencies = [], []
    prof = profiled = None
    record_end = 0
    with Served(decode) as served:
        if ctx.trace:
            prof = profiled = Profile(device).__enter__()
            prof.start()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        trace_end = (t0 + params["trace_seconds"]
                     if params.get("trace_seconds") else deadline)
        it = dl.iter_with_instances()
        while True:
            tb = time.perf_counter()
            if prof is not None and tb >= trace_end:
                prof.stop()
                prof.__exit__(None, None, None)
                record_end, prof = len(batches), None
                # the stop takes seconds: no request's latency holds it
                tb = time.perf_counter()
            with spans.span("serve/batchify"):
                nxt = next(it, None)
            if nxt is None:                 # a pass of the test set ends
                if tb >= deadline:
                    break
                it = dl.iter_with_instances()
                continue
            batch, group = nxt
            with spans.span("serve/decode_batch"):
                hyps = decode_batch(model, batch, tv, **search)
            lines = [postprocess_hypothesis(
                h, entity_map=(inst.meta or {}).get("entities"),
                bpe_marker=None) for h, inst in zip(hyps, group)]
            te = time.perf_counter()
            latencies += [te - tb] * len(lines)
            batches.append((batch, group, hyps))
        if prof is not None:
            prof.stop()
            prof.__exit__(None, None, None)
            record_end, prof = len(batches), None
        window = te - t0 if batches else time.perf_counter() - t0
    results = [(s.cpu(), sc.cpu(), ln.cpu(), int(st))
               for s, sc, ln, st in served.results]
    requests = len(latencies)
    memory = ctx.memory_peak()
    record = None
    if ctx.trace:
        done = batches[:record_end]
        flops = bound = 0.0
        for (batch, group, _), (_, _, _, st) in zip(done, results):
            a = batch.arrays()
            flops += work.serve_flops(a, len(group), st, params["beam"], cfg)
            bound += work.relattn_bound_s(a, cfg, False)
        # the latency tail over the requests served after the profiler
        # stopped (it slows the traced ones)
        after = sum(len(g) for _, g, _ in done)
        record = profiled.record(
            spans, dict(batches=len(done), requests=after,
                        flops=flops, relattn_bound_s=bound,
                        peak_flops=work.PEAK_OPS_PER_S[cfg["compute_dtype"]],
                        latency_p95_ms=float(np.percentile(
                            latencies[after:], 95)) * 1e3
                        if latencies[after:] else None))
    counters = dict(captures=graphs.captures,
                    captures_in_window=graphs.captures - captured,
                    replays=graphs.replays)
    del model, graphs
    gc.collect()
    ctx.free()
    dl.close()
    numbers = compare(ctx, cfg, vocabs, reqs.corpus, batches, results,
                      params, ctx.control)
    e2e = {"decode_graphs_per_s": requests / window}
    return dict(setup_s=setup_s, window_s=window, attempted=requests,
                failed=0, memory_peak=memory, counters=counters, e2e=e2e,
                record=record, numbers=numbers)


def scores(ref, sub, seqs, lengths, rows, unk_id, alpha):
    """The reference's score of each row's tokens: their summed log P over
    the hypothesis length, over ((5 + length) / 6) ** alpha, as the search
    normalises it."""
    T = int(max(int(lengths[r]) for r in rows)) + 1
    logp = ref.sequence_log_probs(sub, seqs[rows, :T].to(sub["concept"]
                                                          .device), unk_id)
    out = []
    for k, r in enumerate(rows):
        n = int(lengths[r])
        out.append(float(logp[k, :n].sum()) / ((5.0 + n) / 6.0) ** alpha)
    return out


def compare(ctx, cfg, vocabs, corpus, batches, results, params,
            control=False) -> dict:
    """The check's numbers: over a sample of the window's requests drawn
    from the seed, with the longest served one in it, the widest gap
    between the score the search gave a request's hypothesis (its
    length-normalised log-probability) and the reference's score of the
    same tokens (control: the float8 reference's score in the search's
    place); the batch check's faults; and the hypotheses whose strings
    are not their tokens."""
    device = ctx.device
    tv, cv, rv, chv, _ = vocabs
    itos = (tv.itos, cv.itos, rv.itos, chv.itos)
    done = [(i, r) for i, (_, group, _) in enumerate(batches)
            for r in range(len(group))]
    if not done:
        return dict(score_gap=float("inf"), batch_faults=0, wrong_strings=0,
                    detail={})
    rng = random.Random(ctx.seed)
    pick = rng.sample(done, min(params["sample"], len(done)))
    longest = max(done, key=lambda ir: int(results[ir[0]][2][ir[1]]))
    if longest not in pick:
        pick.append(longest)
    by_batch = {}
    for i, r in pick:
        by_batch.setdefault(i, []).append(r)
    w = init_weights(param_spec(cfg), ctx.seed, device)
    ref = Reference(cfg, w, "f32")
    low = Reference(cfg, w, "fp8") if control else None
    alpha, worst, faults, wrong, tokens = params["alpha"], 0.0, [], 0, 0
    for i, rows in sorted(by_batch.items()):
        batch, group, hyps = batches[i]
        seqs, served, lengths, _ = results[i]
        arrays = batch.arrays()
        idx = [inst.orig_index for inst in group]
        faults += batch_check.all_faults(arrays, corpus, idx, itos, rows,
                                         with_target=False)
        for r in rows:
            words = []
            for x in seqs[r, 1:int(lengths[r]) + 1].tolist():
                if x == tv.end_id:
                    break
                oov = batch.oov_lists[r]
                j = x - len(tv.itos)
                words.append(tv.itos[x] if j < 0 else
                             oov[j] if j < len(oov) else "<UNK>")
            wrong += words != list(hyps[r])
            tokens += int(lengths[r])
        sub = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
               for k, v in arrays.items()
               if k in ("concept", "concept_char", "concept_mask",
                        "rel_index", "cp_seq", "copy_mask")}
        sub["rel_bank"] = torch.from_numpy(arrays["rel_bank"]).to(device)
        sub["rel_length"] = torch.from_numpy(arrays["rel_length"]).to(device)
        want = scores(ref, sub, seqs, lengths, rows, tv.unk_id, alpha)
        got = (scores(low, sub, seqs, lengths, rows, tv.unk_id, alpha)
               if control else [float(served[r]) for r in rows])
        worst = max([worst] + [abs(a - b) for a, b in zip(got, want)])
    return dict(score_gap=worst, batch_faults=len(faults),
                wrong_strings=wrong,
                detail=dict(compared=len(pick), tokens=tokens,
                            faults=faults[:3]))
