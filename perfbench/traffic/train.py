"""The training traffic: a user training on a corpus with the train CLI's
loader and `Trainer.fit`, epoch after epoch.

Parameters (the workload file's "params"):
  train_graphs       the corpus size, made from the seed by the
                     configuration's generator
  batchify_workers   the loader's worker processes (or threads)
  worker_mode        "process" or "thread"
  prefetch, max_inflight   Trainer's
  trace_seconds      the traced run's profiled share of the window

Set-up reads the corpus files with the program's reader, builds the
vocabularies, preprocesses, builds the loader, the model with the
benchmark's weights and the Trainer, then trains through `fit` on one
pass of the loader's epoch plan: its first three batches (the start the
check compares: the first call of a signature runs uncaptured), then the
first batch of each batch signature not trained yet, so that every graph
of the plan is captured; then the first three batches of the next pass
that set-up has not trained, each a replay of a graph captured on
another batch, as nearly every step of the window is (the check compares
these too, from a copy of the state they start at). The
window then runs `fit` over the same plan pass after pass (the loader
re-batches it each pass, as every epoch does; the plan is the same, so
no signature is captured in the window) until `--seconds` have passed;
the batch in hand when they have is the last. The window ends once the
card has finished every step.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from perfbench.harness import program, work
from perfbench.harness.trace import Profile, Spans
from perfbench.reference import batch_check
from perfbench.reference.model import Adam, Reference, init_weights, \
    param_spec

# steps the check follows from the start of training
CHECK_STEPS = 3
# leaves whose reference gradient is below this share of the median
# leaf's move under Adam by round-off alone: out of the change's reading
STILL_SHARE = 1e-3


class StepLimit:
    """The TrainConfig that fit reads, with a total_steps that the feed
    sets when it stops (fit runs until its step reaches it)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.total_steps = 10 ** 12

    def __getattr__(self, name):
        return getattr(self.cfg, name)


class Feed:
    """The loader as fit iterates it: the epoch plan pass after pass, a
    bounded stretch at each fit call (`take`). Runs on fit's prefetch
    thread."""

    def __init__(self, loader, limit: StepLimit, trainer, spans: Spans):
        self.loader, self.limit, self.trainer = loader, limit, trainer
        self.spans = spans
        self.stream = self._passes()
        self.kept = []          # (batch, instances) of the check's steps
        self.keep = 0
        self.end = None
        self.seen = None        # set-up: the batch signatures trained
        self.warm = False       # set-up: train only unseen signatures
        self.trained = set()    # set-up: places in the pass trained
        self.avoid = None       # places in the pass to pass over

    def _passes(self):
        while True:
            self.loader.epoch = 0           # the first epoch's plan
            for at, (batch, group) in enumerate(
                    self.loader.iter_with_instances()):
                yield at, batch, group, False
            yield None, None, None, True    # a pass ends here

    def take(self, steps=None, deadline=None, pass_end=False, warm=False):
        """Let the next fit call run `steps` steps, or until `deadline`
        (perf_counter), or to the end of the pass; warm: only the batches
        of signatures not trained yet."""
        self.steps, self.deadline, self.pass_end = steps, deadline, pass_end
        self.warm = warm
        self.given = self.tokens = 0
        self.start = self.trainer.step
        self.limit.total_steps = 10 ** 12

    def __iter__(self):
        return self._take()

    def _take(self):
        while True:
            if (self.steps is not None and self.given >= self.steps) or (
                    self.deadline is not None
                    and time.perf_counter() >= self.deadline):
                break
            with self.spans.span("feed/next_batch"):
                at, batch, group, end = next(self.stream)
            if end:
                if self.pass_end:
                    break
                if self.given == 0:         # a pass with nothing else
                    self.avoid = None
                continue
            if self.avoid is not None and at in self.avoid:
                continue
            if self.seen is not None:
                sig = tuple((k, v.shape, v.dtype.str)
                            for k, v in sorted(batch.arrays().items()))
                if self.warm and sig in self.seen:
                    continue
                self.seen.add(sig)
                self.trained.add(at)
            self.given += 1
            self.tokens += int(batch.token_mask.sum())
            if self.keep:
                self.kept.append((batch, group))
                self.keep -= 1
            if self.end is not None:
                self.end.append(batch)
            yield batch
        self.limit.total_steps = self.start + self.given


class Recorder:
    """fit's metrics writer: the logged lines."""

    def __init__(self):
        self.rows = []

    def write(self, row):
        self.rows.append(dict(row))


def _leaf_gap(prog, ref, keep=None):
    """The worst leaf's gap between the two norms, over the larger of
    that leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].norm()) for k in names}
    med = float(np.median(list(rn.values())))
    worst, at = 0.0, None
    for k in names:
        gap = abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def run(ctx) -> dict:
    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    params, config = cell["params"], ctx.config
    t_setup = time.perf_counter()
    corpus = ctx.generate(params["train_graphs"], seed)
    data = program.read(config["task"], corpus, ctx.workdir, "train")
    vocabs = program.vocabularies(data)
    cfg = program.sizes(config, vocabs)
    tcfg = program.train_config(config)
    instances = program.preprocess(data)
    dl = program.loader(instances, vocabs, cfg, tcfg.batch_size_tokens,
                        True, params["batchify_workers"],
                        params["worker_mode"])
    spans = Spans(ctx.trace)
    try:
        first = next(iter(dl))                   # as the train CLI does
        model = program.model(cfg, seed, device)
        from gtos_tpu_torch.train.trainer import Trainer

        rec = Recorder()
        trainer = Trainer(model, program.model_config(cfg), tcfg,
                          first.arrays(), metrics_writer=rec,
                          prefetch=params["prefetch"],
                          max_inflight=params["max_inflight"], device=device)
        limit = StepLimit(tcfg)
        trainer.train_cfg = limit
        feed = Feed(dl, limit, trainer, spans)
        trainer._prep = spans.wrap("feed/prep", trainer._prep)
        trainer.train_step = spans.wrap("train/step", trainer.train_step)
        if ctx.plant:
            ctx.plant(trainer)
        graphs = trainer._step.graphs
        # the check's start: steps 1-3 from the benchmark's weights
        feed.seen = set()
        start = _checked_steps(trainer, feed, rec, graphs, tcfg, True)
        # the rest of the pass, one batch of each signature not yet
        # trained: every graph of the plan is captured
        feed.take(pass_end=True, warm=True)
        trainer.fit(feed, log_every=10 ** 12)
        # three steps of the next pass, each a replay, as in the window,
        # of a graph captured on another batch of its signature
        feed.seen, feed.avoid = None, feed.trained
        replayed = _checked_steps(trainer, feed, rec, graphs, tcfg)
        feed.avoid = None
        ctx.sync()
        setup_s = time.perf_counter() - t_setup

        # ---- the window
        failed = 0
        captured = graphs.captures
        traced_steps, traced_batches = 0, []
        prof = None
        if ctx.trace:
            prof = Profile(device).__enter__()
            prof.start()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        steps = tokens = 0
        try:
            if ctx.trace:
                feed.end = traced_batches
                feed.take(deadline=min(deadline,
                                       t0 + params["trace_seconds"]))
                try:
                    trainer.fit(feed, log_every=10 ** 12)
                finally:
                    prof.stop()
                    prof.__exit__(None, None, None)
                    feed.end = None
                traced_steps = steps = feed.given
                tokens = feed.tokens
            feed.take(deadline=deadline)
            trainer.fit(feed, log_every=10 ** 12)
            ctx.sync()
        except FloatingPointError:
            failed = 1
        window = time.perf_counter() - t0
        steps += feed.given
        tokens += feed.tokens
        finite = all(bool(torch.isfinite(p).all())
                     for p in model.parameters())
        if not finite:
            failed = max(failed, 1)
        counters = dict(captures=graphs.captures,
                        captures_in_window=graphs.captures - captured,
                        replays=graphs.replays)
        memory = ctx.memory_peak()
        record = None
        if prof is not None:
            work_ = dict(
                steps=traced_steps,
                flops=sum(work.train_flops(b.arrays(), cfg)
                          for b in traced_batches),
                relattn_bound_s=sum(work.relattn_bound_s(b.arrays(), cfg,
                                                         True)
                                    for b in traced_batches),
                peak_flops=work.PEAK_OPS_PER_S[cfg["compute_dtype"]])
            record = prof.record(spans, work_)
        del trainer, model, feed, graphs
        gc.collect()
        ctx.free()
    finally:
        dl.close()

    # ---- the check: the reference follows the checked steps
    numbers = compare(ctx, cfg, tcfg, [start, replayed], corpus, vocabs,
                      ctx.control)
    return dict(setup_s=setup_s, window_s=window, attempted=steps,
                failed=failed, memory_peak=memory, counters=counters,
                e2e={"train_tokens_per_s": tokens / window},
                record=record, numbers=numbers)


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _checked_steps(trainer, feed, rec, graphs, tcfg, fresh=False) -> dict:
    """CHECK_STEPS steps through fit, as the window takes them; fresh:
    the first steps, from the benchmark's weights. Returns the state they
    start from (parameters, Adam's moments and count, the
    dropout generator's state; kept on the host), their batches, the
    program's readings (losses, the first clipped gradient as Adam took
    it, the steps' change, by leaf) and, after the first steps, how many
    of the steps ran other than as a replay of a captured graph (a first
    step of its signature runs uncaptured, utils/graphs.py)."""
    model, opt = trainer.model, trainer.opt
    names = [k for k, _ in model.named_parameters()]
    state = dict(params=_host(dict(model.named_parameters())),
                 mu=_host(dict(zip(names, opt.state["mu"]))),
                 nu=_host(dict(zip(names, opt.state["nu"]))),
                 count=int(opt.state["count"]),
                 rng=model.dropout_rng.get_state())
    replays, rows = graphs.replays, len(rec.rows)
    feed.kept, feed.keep = [], CHECK_STEPS
    feed.take(steps=1)
    trainer.fit(feed, log_every=1)
    b1 = tcfg.adam_b1
    g1 = {k: (m.detach().to("cpu") - b1 * state["mu"][k]) / (1 - b1)
          for k, m in zip(names, opt.state["mu"])}
    feed.take(steps=CHECK_STEPS - 1)
    trainer.fit(feed, log_every=1)
    losses = [r["loss"] for r in rec.rows[rows:] if r.get("kind") == "train"]
    change = {k: p.detach().to("cpu") - state["params"][k]
              for k, p in model.named_parameters()}
    unreplayed = (CHECK_STEPS - (graphs.replays - replays)
                  if graphs.enabled and not fresh else 0)
    return dict(state=state, kept=feed.kept, prog=(losses, g1, change),
                unreplayed=unreplayed, fresh=fresh)


def follow(ctx, cfg, tcfg, kept, precision: str, state=None):
    """The reference's steps on the check's batches: (losses, the first
    clipped gradient, the steps' change) by leaf. state: the program's
    state the steps start from (_checked_steps); None: the benchmark's
    weights, Adam's zero moments and the dropout generator the program
    starts from."""
    device = ctx.device
    if state is None:
        w = init_weights(param_spec(cfg), ctx.seed, device)
    else:
        w = {k: v.to(device) for k, v in state["params"].items()}
    P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = Reference(cfg, P, precision)
    opt = Adam(P, cfg["d_model"], tcfg.warmup_steps, tcfg.adam_b1,
               tcfg.adam_b2, tcfg.adam_eps, tcfg.grad_clip, tcfg.lr_scale)
    gen = torch.Generator(device=device)
    if state is None:
        gen.manual_seed(tcfg.seed)
    else:
        opt.count = state["count"]
        for k in P:
            opt.mu[k].copy_(state["mu"][k])
            opt.nu[k].copy_(state["nu"][k])
        gen.set_state(state["rng"])
    losses, g1 = [], None
    for batch, _ in kept:
        t = program.to_device(batch.arrays(), device)
        loss = ref.loss(t, gen)
        grads = torch.autograd.grad(loss, list(P.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(P.items(), grads)}
        losses.append(float(loss.detach()))
        clipped = opt.step(grads)
        if g1 is None:
            g1 = {k: v.detach() for k, v in clipped.items()}
        del t, loss, grads
    return losses, g1, {k: P[k].detach() - w[k] for k in P}


def compare(ctx, cfg, tcfg, checks, corpus, vocabs, control=False
            ) -> dict:
    """The check's numbers over the checked stretches (_checked_steps):
    the worst step's loss gap (relative), the worst stretch's change's
    worst leaf gap of norms, the batch check's faults and the steps that
    were not replays. The first gradient's worst leaf gap of norms is
    read too, and kept in the detail: neither the control nor a planted
    fault reads 3 or 10 times what sound runs read on it (PERF.md), so it
    is not compared. control: the float8 reference in the program's
    place."""
    tv, cv, rv, chv, _ = vocabs
    itos = (tv.itos, cv.itos, rv.itos, chv.itos)
    faults, detail = [], []
    loss_gap = change_gap = 0.0
    for check in checks:
        kept, state = check["kept"], check["state"]
        for batch, group in kept:
            faults += batch_check.all_faults(
                batch.arrays(), corpus, [i.orig_index for i in group], itos)
        if check["fresh"]:         # the reference makes its own start
            state = None
        losses, g1, d_ref = follow(ctx, cfg, tcfg, kept, "f32", state)
        prog = check["prog"]
        if control:
            prog = follow(ctx, cfg, tcfg, kept, "fp8", state)
        losses_prog, g_prog, d_prog = prog
        gn = {k: float(v.norm()) for k, v in g1.items()}
        med = float(np.median(list(gn.values())))
        moving = {k for k, v in gn.items() if v >= STILL_SHARE * med}
        grad_gap, grad_leaf = _leaf_gap(g_prog, g1)
        gap, change_leaf = _leaf_gap(d_prog, d_ref, moving)
        lg = max(abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(losses_prog, losses)) \
            if len(losses_prog) == len(losses) else math.inf
        loss_gap, change_gap = max(loss_gap, lg), max(change_gap, gap)
        detail.append(dict(from_step=check["state"]["count"],
                           unreplayed=check["unreplayed"],
                           losses=losses_prog,
                           ref_losses=losses, loss_gap=lg, change_gap=gap,
                           grad_gap=grad_gap, grad_leaf=grad_leaf,
                           change_leaf=change_leaf,
                           still_leaves=sorted(set(gn) - moving)))
    return dict(loss_gap=loss_gap, change_gap=change_gap,
                batch_faults=len(faults),
                unreplayed=sum(c["unreplayed"] for c in checks),
                detail=dict(stretches=detail, faults=faults[:3]))
