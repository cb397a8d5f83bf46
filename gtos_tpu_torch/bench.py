"""The port's bench: times its own cells on one NVIDIA GPU and prints one
JSON line last.

    python -m gtos_tpu_torch.bench [--cells CELL ...] [--repeats R]
        [--seed S] [--out DIR (default chiprun_out/bench)] [--checkout DIR]

Each cell builds its seeded inputs once, runs a warm-up, then R repeats of
that fixed input set in the same order, and reports every metric with its
unit, median, min, max, quartiles and sample count n. Outputs are checked
on the way: losses finite, served tokens identical from one repeat to the
next, and each kernel against its plain version (KERNEL_TOL) before it is
timed; an impossible timing (not positive, not finite, or below its bound)
raises (utils/benchlib.py). A separate traced run of each train and serve
cell (torch.profiler, spans from this file around its calls into each
layer) gives the device's busy time and idle share, the kernels per step
and each span's self time beside the untraced medians; nvidia-smi's SM
clock and power draw are sampled beside each repeat.

Cells (the configurations chip_smoke.py drives, at full width, bf16,
weights from the seed):

  north_star_local   the JAX package's bench.py batch (batchify of 32
                     synthetic AMR graphs of 10-31 nodes, N=32) at c2
                     widths: edges/s of B1 (serving) and of B1p + B2 (a
                     training pass) against the dense reference
                     (dense_relation_scores_reference, masked softmax,
                     aggregate; plain torch) -> vs_baseline
  c2_train_pallas_local  configs/c2_amr2.json: Trainer.train_step over 20
                     loader batches already on the card, then the same
                     batches through the DataLoader and Trainer.fit
                     (prefetch 2): ms/step and target tokens/s of each
  c2_train_pallas    the same under "pallas" (every bank takes B3', the
                     card's rule; B3's kernel row takes the tables that
                     build_tables makes of batch 0's layer-0 inputs)
  c2_serve           decode_batch (beam 8, 64 steps) of the fullest batch
                     of the node buckets 16/32/64 of 1024 requests
  c4_train, c4_serve configs/c4_nmt_ende.json on 400 synthetic dependency
                     trees of 10-50 tokens (requests: 1024 of another seed)
  c5_train, c5_serve configs/c5_scaled_synthetic.json under
                     "block_sparse", khop 4, one card, on 96 synthetic AMR
                     graphs of 100-500 nodes (6 train batches; the train
                     step captured as every route's is, its backward plan
                     built inside it, and the plan alone timed on each
                     batch: info.plan_device_ms)
  kernels            B1-B6 on layer 0's inputs of the cells above (captured
                     from one more forward, and backward, of each): event
                     ms, profiler device ms, bound, plain ms, and B6b's
                     torch.sparse.mm yardstick
  host               preprocess ms/graph (native against Python) and
                     batchify ms/batch (in order against 4 processes), c2
                     and c4

--device cpu (tests only) runs the cells at the widths given with
--d_model etc. and writes null in every timing field: a CPU run gives no
card number. --checkout DIR runs the same cells from another checkout's
package in subprocesses, in turns (that, this, this, that), and writes
both sides' JSON under --out. The JSON is this package's own; it is not
a benchmark file of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import inspect
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gtos_tpu_torch.utils import benchlib
from gtos_tpu_torch.utils.kernel_calls import (
    KERNEL_WRAPPERS, capture, kernels_wrapped, named, plain as plain_of,
    wrapper)
from gtos_tpu_torch.utils.profiling import annotate

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("north_star_local", "c2_train_pallas_local", "c2_train_pallas",
         "c2_serve", "c4_train", "c4_serve", "c5_train", "c5_serve",
         "kernels", "host")
CONFIG_FILES = {"c2": "c2_amr2.json", "c4": "c4_nmt_ende.json",
                "c5": "c5_scaled_synthetic.json"}
# the corpora: c2's AMR 2.0-scale synthetic graphs; c4's dependency trees
# of a translator's sentence lengths; c5's large graphs (node buckets
# 128/256/512, bank and edge-cell ladders widened as
# tests/test_ring_block_sparse.py widens them)
C2_GRAPHS = 2000
C4_GRAPHS, C4_LENGTHS = 400, (10, 50)
C5_GRAPHS, C5_NODES = 96, (100, 500)
C5_SPEC = dict(nodes=(128, 256, 512),
               bank=(1024, 2048, 4096, 8192, 16384, 32768, 65536),
               edge_cells=(1024, 4096, 16384, 32768, 65536))
SERVE_REQUESTS, SERVE_BUCKETS, BEAM, MAX_STEPS = 1024, 3, 8, 64
TRAIN_BATCHES = {"c2": 20, "c4": 20, "c5": 6}
NORTH_STAR = (32, 10, 31)        # graphs, nodes: the JAX bench.py batch
KERNEL_ITERS = 20                # cold calls a repeat, per kernel row
PROFILE_ITERS = 10
HOST_WORKERS = 4
TOP_KERNELS = 12
# the traced run (a separate run, its events processed on the host): the
# train cells' first batches through the loader, the serve cells' first
# batch
TRACE_BATCHES = 4
SMI_INTERVAL_MS = 200
WIDTHS = ("d_model", "d_ff", "heads", "enc_layers", "dec_layers")


class BenchFailure(RuntimeError):
    """An output the bench checks is wrong."""


# ---------------------------------------------------------------- results


def metric(unit, samples, measured=True):
    """A metric: its unit and benchlib.summarize's keys (null, n 0, where
    not measured)."""
    if not measured:
        return dict(unit=unit, median=None, min=None, max=None, q1=None,
                    q3=None, n=0)
    return dict(unit=unit, **benchlib.summarize(samples))


def _smi_sample():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=30)
    return [float(x) for x in out.stdout.split(",")]


@contextlib.contextmanager
def smi_sampled(into, device):
    """nvidia-smi's SM clock (MHz) and power draw (W) while the block
    runs: one query at its start and then every SMI_INTERVAL_MS, from a
    thread; appended to `into` as their min, median and max."""
    import threading

    if device.type != "cuda":
        yield
        return
    rows, done = [_smi_sample()], threading.Event()

    def poll():
        while not done.wait(SMI_INTERVAL_MS / 1e3):
            rows.append(_smi_sample())

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield
    finally:
        done.set()
        thread.join(timeout=60)
    clocks, power = np.array(rows).T
    into.append(dict(
        n=len(rows), sm_clock_mhz=[float(clocks.min()),
                                   float(np.median(clocks)),
                                   float(clocks.max())],
        power_draw_w=[float(power.min()), float(np.median(power)),
                      float(power.max())]))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- inputs


def raw_corpus(family="c2", seed=0, n=None):
    """(graphs, targets) of a family's synthetic corpus."""
    from gtos_tpu_torch.data.synthetic import (
        synthetic_amr2_corpus, synthetic_amr_corpus,
        synthetic_dependency_corpus)

    if family == "c4":
        return synthetic_dependency_corpus(n or C4_GRAPHS, seed=seed,
                                           min_len=C4_LENGTHS[0],
                                           max_len=C4_LENGTHS[1])
    if family == "c5":
        return synthetic_amr_corpus(n or C5_GRAPHS, seed=seed,
                                    min_nodes=C5_NODES[0],
                                    max_nodes=C5_NODES[1])
    return synthetic_amr2_corpus(n or C2_GRAPHS, seed=seed)


@functools.lru_cache(maxsize=None)
def corpus(family="c2", seed=0):
    """A family's corpus, preprocessed, with its vocabularies: the train
    data and the vocabularies of the family's models."""
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs

    graphs, targets = raw_corpus(family, seed)
    return preprocess(graphs, targets), build_vocabs(graphs, targets)


def configs(family="c2", impl=None, widths=None, seed=0):
    """The ModelConfig and TrainConfig of the family's config file with
    the corpus's vocabulary sizes (c4: no copy, node positions, as the
    train CLI sets them for the nmt task), under attention_impl `impl`
    (default the file's), with `widths` (d_model, ...) replacing the
    file's where given."""
    from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

    with open(ROOT / "configs" / CONFIG_FILES[family]) as f:
        conf = json.load(f)
    conf.update({k: v for k, v in (widths or {}).items() if v is not None})
    tv, cv, rv, chv, _ = corpus(family, seed)[1]
    pick = lambda cls: {f.name: conf[f.name]  # noqa: E731
                        for f in dataclasses.fields(cls) if f.name in conf}
    nmt = conf["task"] == "nmt"
    cfg = ModelConfig(**pick(ModelConfig), token_vocab=len(tv),
                      concept_vocab=len(cv), relation_vocab=len(rv),
                      char_vocab=len(chv), use_copy=not nmt,
                      use_node_positions=nmt)
    if impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=impl)
    return cfg, TrainConfig(**pick(TrainConfig))


def loader(family, impl, for_train, seed=0):
    """The DataLoader the train CLI builds for the family's corpus under
    `impl` (8192-token batches; c5 with C5_SPEC's ladders) or, for
    serving c2/c4, over SERVE_REQUESTS requests of seed + 1 in 4096-token
    batches."""
    from gtos_tpu_torch.data import BucketSpec, DataLoader
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.train.train import loader_flags

    cfg, tcfg = configs(family, impl, seed=seed)
    instances, vocabs = corpus(family, seed)
    flags = loader_flags(impl, cfg.sparse_khop if family == "c5" else 0)
    if family == "c5":
        return DataLoader(instances, *vocabs,
                          batch_size_tokens=tcfg.batch_size_tokens,
                          spec=BucketSpec(**C5_SPEC).for_model_max_oov(
                              cfg.max_oov),
                          for_train=for_train, seed=tcfg.seed, **flags)
    if for_train:
        return DataLoader(instances, *vocabs,
                          batch_size_tokens=tcfg.batch_size_tokens,
                          spec=BucketSpec().for_model_max_oov(cfg.max_oov),
                          for_train=True, seed=tcfg.seed, **flags)
    graphs, targets = raw_corpus(family, seed + 1, SERVE_REQUESTS)
    return DataLoader(preprocess(graphs, targets), *vocabs,
                      batch_size_tokens=4096, for_train=False, **flags)


def shape_of(batch) -> dict:
    B, N = batch.concept_mask.shape
    out = dict(B=int(B), N=int(N), T=int(batch.token_in.shape[1]),
               P=int(batch.rel_bank.shape[0]))
    if batch.bank_map is not None:
        out["P_loc"] = int(batch.bank_map.shape[1])
    return out


# ---------------------------------------------------------------- spans


def spanned(name, fn):
    """fn inside the span "bench/<name>"."""
    def inner(*args, **kw):
        with annotate(f"bench/{name}"):
            return fn(*args, **kw)
    return inner


@contextlib.contextmanager
def attrs_spanned(pairs):
    """Within the block each (object, method name, span) of `pairs` runs
    its method inside the span, set on the instance and removed after."""
    for obj, name, span in pairs:
        setattr(obj, name, spanned(span, getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, _ in pairs:
            delattr(obj, name)


@contextlib.contextmanager
def traced(device, warm=None):
    """torch.profiler over the block, every kernel wrapper in its span, and
    every thread's spans (the prefetch thread's host batching) where this
    torch's profiler can record other threads (`prof.all_threads`).
    Swapping the wrappers in drops the model's CUDA graphs
    (utils/graphs.py), so `warm()` runs first, untraced, to capture them
    again: the traced window replays them, as an untraced run does (and
    the spans inside a graph fire only at its capture)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    try:
        config = dict(experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    except TypeError:       # an older torch: this thread's spans alone
        config = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(kernels_wrapped(lambda kernel, real: spanned(
            f"kernel/{kernel}", real)))
        if warm is not None:
            warm()
            sync(device)
        prof = stack.enter_context(profile(activities=acts, **config))
        prof.all_threads = bool(config)
        pad = device.type == "cuda"     # the window's edge device events
        if pad:
            time.sleep(benchlib.PROFILE_PAD_S)
        yield prof
        if pad:
            torch.cuda.synchronize()
            time.sleep(benchlib.PROFILE_PAD_S)


def read_trace(prof, wall_s, steps, untraced_s, device):
    """The traced window's report (`steps` steps in `wall_s` seconds; the
    same work took `untraced_s` untraced): device busy ms (a step's: the
    kernels and copies, not the spans' own device-side records), idle share
    against the traced wall and against the untraced time, device kernels
    and copies a step, the busiest TOP_KERNELS, and per span its calls,
    host self ms (its time minus its child spans' on the same thread) and
    device window ms (the card's time from its first kernel's start to its
    last one's end, summed over calls; a kernel span's is that call's
    device time with any host gaps between its launches)."""
    from torch.autograd import DeviceType

    measured = device.type == "cuda"
    spans = {}
    events = prof.events()
    by_thread = {}
    for e in events:
        if e.name.startswith("bench/") and e.device_type == DeviceType.CPU:
            by_thread.setdefault(e.thread, []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        stack = []     # the open spans enclosing e, innermost last
        for e in evs:
            while stack and stack[-1].time_range.end <= e.time_range.start:
                stack.pop()
            rec = spans.setdefault(e.name, dict(calls=0, host=0.0,
                                                device=0.0))
            rec["calls"] += 1
            rec["host"] += e.time_range.elapsed_us() / 1e3
            if stack:
                spans[stack[-1].name]["host"] -= (
                    e.time_range.elapsed_us() / 1e3)
            stack.append(e)
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    for e in dev:
        if e.name in spans:
            spans[e.name]["device"] += e.time_range.elapsed_us() / 1e3
    out = dict(all_threads=prof.all_threads, spans={
        name: dict(calls=r["calls"],
                   host_self_ms=r["host"] if measured else None,
                   device_window_ms=r["device"] if measured else None)
        for name, r in sorted(spans.items())})
    if not measured:
        out.update(busy_ms_per_step=None, idle_share=None,
                   idle_share_vs_untraced=None, kernels_per_step=None,
                   host_launches_per_step=None, top_kernels=None,
                   traced_wall_ms=None)
        return out
    work = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("bench/")]
    busy = sum(e.self_device_time_total for e in work) / 1e3
    if busy <= 0:
        raise BenchFailure("the profiler recorded no device time")
    out.update(
        traced_wall_ms=wall_s * 1e3, busy_ms_per_step=busy / steps,
        idle_share=1 - busy / (wall_s * 1e3),
        idle_share_vs_untraced=1 - busy / (untraced_s * 1e3),
        kernels_per_step=sum(e.count for e in work) / steps,
        host_launches_per_step=sum(
            e.count for e in prof.key_averages()
            if e.key in benchlib.LAUNCH_APIS) / steps,
        top_kernels=[dict(ms=e.self_device_time_total / 1e3, count=e.count,
                          name=e.key[:90])
                     for e in sorted(work, key=lambda e:
                                     -e.self_device_time_total)[
                                         :TOP_KERNELS]])
    return out


def graph_info(graphs) -> dict:
    """A model's CUDA graphs (utils/graphs.py) after a cell: how many were
    captured and replayed, each capture's host ms, the pool's MiB (null
    where the steps ran uncaptured)."""
    if not graphs.enabled:
        return dict(captured=False)
    pool = graphs.pool_bytes()
    return dict(captured=True, graphs=graphs.captures,
                replays=graphs.replays,
                capture_ms=sorted(graphs.capture_ms().values()),
                pool_mib=None if pool is None else pool / 2 ** 20)


def epoch_signatures(ld, cfg, train: bool) -> int:
    """How many batch signatures (route, every array's shape and dtype;
    train: with the pair capacity, which only the train step's key holds)
    one epoch of the loader makes: the graphs a run over it captures."""
    from gtos_tpu_torch.models.generator import resolve_attention_impl
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import with_pair_cap
    from gtos_tpu_torch.utils.graphs import signature

    epoch, ld.epoch = getattr(ld, "epoch", None), 0
    sigs = {(resolve_attention_impl(cfg.attention_impl, a),
             signature(with_pair_cap(a) if train else a))
            for a in (b.arrays() for b in ld)}
    if epoch is not None:
        ld.epoch = epoch
    return len(sigs)


# ---------------------------------------------------------------- kernels


def plain_call(kernel, a):
    """A call of the plain version on the wrapper's named arguments `a`."""
    plain = plain_of(kernel)
    if kernel == "B6b":
        return functools.partial(plain, a["q"], a["k"], a["a_bank"],
                                 a["b_bank"], a["ge"], a["plan"])
    names = inspect.signature(plain).parameters
    return functools.partial(plain, **{n: a[n] for n in names if n in a})


# outputs held to KERNEL_TOL, then those held to PROBS_TOL
OUTPUTS = {"B1": (("out",), ()), "B1p": (("out",), ("probs",)),
           "B2": (("gq", "gk", "gv", "g_a_loc", "g_b_loc"), ()),
           "B3": (("out",), ()), "B3'": (("out",), ()),
           "B4": (("gq", "gk", "gv", "g_t2", "g_t3"), ()),
           "B5": (("out",), ()), "B5s": (("out",), ("m", "l")),
           "B6d": (("dq", "ge"), ()), "B6s": (("dk", "dv"), ()),
           "B6b": (("g_a", "g_b"), ())}


def _fwd7(a, planes=("tile_src", "tile_rel")):
    return (a["q"], a["k"], a["v"], a["a_bank"], a["b_bank"],
            a[planes[0]], a[planes[1]])


def kernel_bound(kernel, a, step):
    """(bound_ms, bound_by) of a kernel call (named arguments a; step: the
    named arguments of every kernel of the same captured step)."""
    q = a["q"]
    _, H, _, Dh = q.shape
    dt = benchlib.dtype_name(q)
    if kernel in ("B1", "B1p", "B2"):
        idx = a["rel_index_loc"].cpu().numpy()
        if kernel == "B2":
            return benchlib.local_attention_bwd_bound(
                idx, H, Dh, a["a_loc"].shape[1], dt)
        return benchlib.local_attention_bound(idx, H, Dh, dt,
                                              with_probs=kernel == "B1p")
    if kernel in ("B3", "B3'", "B4"):
        P = a["a_bank"].shape[0] if kernel == "B3'" else a["t2"].shape[-1]
        kind = {"B3": "tables", "B3'": "inline", "B4": "bwd"}[kernel]
        return benchlib.global_attention_bound(
            a["rel_index"].cpu().numpy(), H, Dh, P, dt, kind)
    if kernel == "B6s":
        planes = (a["tile_dst"], a["tile_rel_src"])
        return benchlib.block_bound(
            "B6s", _fwd7(a, ("tile_dst", "tile_rel_src")), planes)
    if kernel == "B6b":
        return benchlib.block_bound("B6b", _fwd7(step["B6d"]))
    return benchlib.block_bound(kernel, _fwd7(a))


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_kernel(kernel, label, got, ref):
    """The kernel's outputs against its plain version's: those of OUTPUTS
    to KERNEL_TOL and its rtol of their largest value (B4's tables of the
    larger of the two), the statistics to PROBS_TOL, B6b's bank rows also
    one by one (benchlib.bank_row_disagreement). Returns (largest
    absolute error, largest error relative to the largest value, B6b's
    largest bank-row reading or None)."""
    names, stats = OUTPUTS[kernel]
    got, ref = _tuple(got), _tuple(ref)
    if kernel == "B6d":     # the kernel's ge is [H, E_cap]: its E columns
        got = (got[0], got[1][:, :ref[1].shape[1]], *got[2:])
    n = len(names)
    dt = benchlib.dtype_name(ref[0])
    for x in got[:n + len(stats)]:
        if not torch.isfinite(x.float()).all():
            raise BenchFailure(f"{kernel} {label}: non-finite output")
    largest = benchlib.b4_largest(ref) if kernel == "B4" else None
    why = benchlib.disagreement(names, got[:n], ref[:n], dt, largest)
    rows = None
    if kernel == "B6b":
        by_row, rows = benchlib.bank_row_disagreement(names, got, ref)
        why = why or by_row
    for name, x, y in zip(stats, got[n:], ref[n:]):
        try:
            torch.testing.assert_close(x, y, **benchlib.PROBS_TOL)
        except AssertionError as e:
            why = why or f"{name} disagrees with its reference: {e}"
    if why is not None:
        raise BenchFailure(f"{kernel} {label}: {why}")
    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(got[:n + len(stats)], ref))
    return err, benchlib.rel_to_largest(got[:n], ref[:n], largest), rows


def kernel_row(kernel, source, step, run, smi):
    """One kernel on layer 0's inputs of a cell: checked against its plain
    version, then (on the card) its event ms, profiler device ms, plain
    ms and (B6b) library ms, beside its bound (run: the Bench)."""
    args, kw = step["calls"][kernel]
    real = wrapper(kernel)
    a = named(kernel, args, kw)
    call = functools.partial(real, *args, **kw)
    plain = plain_call(kernel, a)
    err, rel, _ = check_kernel(kernel, source, call(), plain())
    bound_ms, bound_by = kernel_bound(kernel, a, step["named"])
    q = a["q"]
    row = dict(kernel=kernel, wrapper=KERNEL_WRAPPERS[kernel][1],
               source=source, shape=dict(zip("BHNd", q.shape)),
               dtype=benchlib.dtype_name(q), max_abs_err=err,
               err_of_largest=rel, bound_ms=bound_ms, bound_by=bound_by)
    measured, device = run.measured, run.device
    lib = None
    if kernel == "B6b" and measured:
        lib, lib_type, lib_err, refused = benchlib.b6b_library(
            q, a["k"], a["a_bank"], a["ge"], a["plan"])
        row["library"] = dict(call="torch.sparse.mm", dtype=lib_type,
                              max_abs_err_of_sums=lib_err, refused=refused)
    iters = KERNEL_ITERS * run.repeats
    ms, device_ms, plain_ms, library_ms = [], None, [], []
    if measured:
        with smi_sampled(smi, device):
            got = benchlib.time_samples(call, iters=iters, cold=True,
                                        bound_s=bound_ms * 1e-3)
            ms = [s * 1e3 for s in got["samples"]]
            device_ms = benchlib.device_ms(call, PROFILE_ITERS,
                                           bound_ms=bound_ms)
            plain_ms = [s * 1e3 for s in benchlib.time_samples(
                plain, iters=iters, cold=True)["samples"]]
            if lib is not None:
                library_ms = [s * 1e3 for s in benchlib.time_samples(
                    lib, iters=iters, cold=True)["samples"]]
    row["ms"] = metric("ms", ms, measured)
    row["device_ms"] = (dict(unit="ms", **device_ms) if device_ms
                        else metric("ms", [], False))
    row["plain_ms"] = metric("ms", plain_ms, measured)
    row["library_ms"] = (metric("ms", library_ms, measured)
                         if kernel == "B6b" else None)
    return row


# ---------------------------------------------------------------- cells


class Bench:
    """The state of one run: the device, the widths, the seed and the
    repeats, and the kernel inputs the cells capture for the kernels
    cell. Each cell is a method returning its result."""

    def __init__(self, device, widths, seed, repeats):
        self.device, self.widths = device, widths
        self.seed, self.repeats = seed, repeats
        self.measured = device.type == "cuda"
        self.captured = {}     # source cell -> capture()

    def ms(self, samples_s):
        return metric("ms", [s * 1e3 for s in samples_s], self.measured)

    def rate(self, unit, count, samples_s):
        return metric(unit, [count / s for s in samples_s], self.measured)

    def model(self, cfg):
        from gtos_tpu_torch.models import Generator

        return Generator(cfg, device=self.device,
                         rng=torch.Generator().manual_seed(self.seed))

    # -------------------------------------------------- north star

    def north_star_local(self):
        """B1 and B1p + B2 on the JAX bench.py batch against the dense
        reference (plain torch) on the same values."""
        from gtos_tpu_torch.ops.attention import (
            dense_relation_scores_reference, masked_softmax)
        from gtos_tpu_torch.ops import local_relation_attention as lra

        cfg, _ = configs("c2", widths=self.widths, seed=self.seed)
        H, Dh = cfg.heads, cfg.d_model // cfg.heads
        dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                 else torch.float32)
        batch = benchlib.honest_batch(NORTH_STAR[0], self.seed,
                                      *NORTH_STAR[1:])
        B, N = batch.concept_mask.shape
        P, P_loc = batch.rel_bank.shape[0], batch.bank_map.shape[1]
        dev = self.device
        gen = torch.Generator().manual_seed(self.seed)
        q, k, v, a_bank, b_bank, _, _ = benchlib.attention_inputs(
            gen, B, H, N, Dh, P, dtype, dev)
        a_bank, b_bank = a_bank * 0.5, b_bank * 0.5
        idx = torch.from_numpy(batch.rel_index).to(dev)
        mask = torch.from_numpy(batch.concept_mask).to(dev)
        bank_map = torch.from_numpy(batch.bank_map).long().to(dev)
        idx_loc = torch.from_numpy(batch.rel_index_loc).to(dev)
        a_loc, b_loc = a_bank[bank_map], b_bank[bank_map]
        g = torch.randn(q.shape, generator=gen).to(dtype).float().to(dev)
        order, start = lra.slot_order(idx_loc, P_loc)
        runs = lra.bank_runs(start, N)
        loc = (q, k, v, a_loc, b_loc, idx_loc, mask)

        def serve():
            return lra.local_relation_attention(*loc)

        def train():
            _, probs = lra.local_relation_attention_with_probs(*loc)
            return lra.local_relation_attention_bwd(
                q, k, v, g, probs, a_loc, b_loc, idx_loc, order, start,
                runs=runs)

        def dense(q, k, v, a, b):
            e = dense_relation_scores_reference(q, k, a, b, idx)
            attn = masked_softmax(e, mask)
            return torch.matmul(attn.to(v.dtype), v)

        leaves = [x.detach().requires_grad_() for x in
                  (q, k, v, a_bank, b_bank)]

        def dense_train():
            out = dense(*leaves)
            return torch.autograd.grad(out, leaves, g.to(out.dtype))

        # the two sides compute one function: B1 against the dense
        # reference over the real query rows
        rows = mask[:, None, :, None].expand_as(q)
        got, ref = serve()[rows], dense(q, k, v, a_bank, b_bank)[rows]
        gap = (got.float() - ref.float()).abs().max().item()
        try:
            torch.testing.assert_close(
                got.float(), ref.float(),
                **benchlib.KERNEL_TOL[benchlib.dtype_name(q)])
        except AssertionError as e:
            raise BenchFailure(f"north_star_local: B1 and the dense "
                               f"reference disagree: {e}") from e
        idx_np = batch.rel_index_loc
        b1 = benchlib.local_attention_bound(idx_np, H, Dh,
                                            benchlib.dtype_name(q))
        b1p = benchlib.local_attention_bound(idx_np, H, Dh,
                                             benchlib.dtype_name(q),
                                             with_probs=True)
        b2 = benchlib.local_attention_bwd_bound(idx_np, H, Dh, P_loc,
                                                benchlib.dtype_name(q))
        real_nodes = batch.concept_mask.sum(1).astype(np.int64)
        edges, real_edges = B * N * N, int((real_nodes ** 2).sum())
        smi, samples = [], {}
        for name, fn, bnd in (("b1", serve, b1[0]),
                              ("b1p_b2", train, b1p[0] + b2[0]),
                              ("dense", lambda: dense(q, k, v, a_bank,
                                                      b_bank), None),
                              ("dense_train", dense_train, None)):
            if self.measured:
                with smi_sampled(smi, dev):
                    samples[name] = benchlib.time_samples(
                        fn, iters=KERNEL_ITERS * self.repeats, cold=True,
                        bound_s=None if bnd is None else bnd * 1e-3)[
                            "samples"]
            else:
                fn()
                samples[name] = []
        with traced(dev) as prof:   # where the baseline's pass goes
            t0 = time.perf_counter()
            dense_train()
            sync(dev)
            wall = time.perf_counter() - t0
        dense_trace = read_trace(prof, wall, 1, wall, dev)
        m = {}
        for name, unit_name in (("b1", "serve"), ("b1p_b2", "train"),
                                ("dense", "dense_serve"),
                                ("dense_train", "dense_train")):
            m[f"{name}_ms"] = self.ms(samples[name])
            m[f"{unit_name}_edges_per_s"] = self.rate(
                "edges/s", edges, samples[name])
        for side, base in (("serve", "dense_serve"), ("train",
                                                      "dense_train")):
            m[f"{side}_vs_baseline"] = dict(
                unit="ratio of medians",
                value=(m[f"{side}_edges_per_s"]["median"]
                       / m[f"{base}_edges_per_s"]["median"])
                if self.measured else None)
        return dict(metrics=m, smi=smi, info=dict(
            B=B, N=N, H=H, Dh=Dh, P=P, P_loc=P_loc,
            dtype=benchlib.dtype_name(q), edges_per_pass=edges,
            unpadded_edges_per_pass=real_edges,
            b1_bound_ms=b1[0], b1p_b2_bound_ms=b1p[0] + b2[0],
            b1_vs_dense_max_abs_gap=gap,
            dense_train_top_kernels=dense_trace["top_kernels"]))

    # -------------------------------------------------- training

    def train_batches(self, family, impl):
        """The cell's fixed batch list: the first TRAIN_BATCHES[family]
        batches of epoch 1 of the train loader. Returns (the loader, the
        batches)."""
        ld = loader(family, impl, True, self.seed)
        n = TRAIN_BATCHES[family]
        ld.epoch = 0
        batches = list(itertools.islice(ld, n))
        if len(batches) < n:
            raise BenchFailure(f"{family} {impl}: one epoch has "
                               f"{len(batches)} batches")
        return ld, batches

    def train_cell(self, name, family, impl):
        """Trainer.train_step over the fixed batches on the card, then the
        first batches through the DataLoader and Trainer.fit; a traced
        run of the latter."""
        from gtos_tpu_torch.models.generator import batch_to_device
        from gtos_tpu_torch.train.trainer import Trainer, check_metrics

        cfg, tcfg = configs(family, impl, self.widths, self.seed)
        ld, batches = self.train_batches(family, impl)
        n = len(batches)
        tcfg = dataclasses.replace(tcfg, checkpoint_every=10 ** 9)
        trainer = Trainer(self.model(cfg), cfg, tcfg, batches[0].arrays(),
                          device=self.device)
        self.captured[name] = self.capture_train(trainer.model, impl,
                                                 batches)
        on_card = [batch_to_device(b.arrays(), self.device)
                   for b in batches]
        tokens = sum(int(b.token_mask.sum()) for b in batches)

        def from_memory():
            out = [trainer.train_step(a) for a in on_card]
            losses = torch.stack([m["loss"] for m in out])
            sync(self.device)
            for m in out:       # read after the sync: the card is idle
                check_metrics(m)
            return losses

        class Feed:   # Trainer.fit's loader: the first n batches of epoch 1
            def __init__(self, n, spans):
                self.n, self.spans = n, spans

            def __iter__(self):
                ld.epoch = 0
                it = iter(ld)
                for _ in range(self.n):
                    with (annotate("bench/host/batchify") if self.spans
                          else contextlib.nullcontext()):
                        batch = next(it)
                    yield batch

        def from_loader(spans=False, n=n):
            trainer.train_cfg = dataclasses.replace(
                tcfg, total_steps=trainer.step + n)
            last = trainer.fit(Feed(n, spans), log_every=10 ** 9)
            sync(self.device)
            return torch.tensor([last["loss"]])

        def finite(losses, what):
            if not torch.isfinite(losses).all():
                raise BenchFailure(f"{name}: non-finite loss {what}: "
                                   f"{losses.tolist()}")

        from_memory()               # warm-up: allocator, cuBLAS
        from_loader()
        counts0 = {k: wrapper(k).launches for k in KERNEL_WRAPPERS}
        mem, feed, smi = [], [], []
        for r in range(self.repeats):
            with smi_sampled(smi, self.device):
                t0 = time.perf_counter()
                finite(from_memory(), f"in repeat {r}")
                mem.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                finite(from_loader(), f"through the loader, repeat {r}")
                feed.append(time.perf_counter() - t0)
        launches = {k: (wrapper(k).launches - counts0[k])
                    // self.repeats for k in KERNEL_WRAPPERS}
        model = trainer.model
        n_traced = min(TRACE_BATCHES, n)
        with traced(self.device, lambda: from_loader(n=n_traced)) as prof, \
                attrs_spanned([
                    (trainer, "train_step", "train_step"),
                    (model, "forward", "forward"),
                    (model, "encode", "encode"),
                    (trainer.opt, "update", "optimizer"),
                    (trainer, "_prep", "host/pack_copy")]):
            t0 = time.perf_counter()
            finite(from_loader(True, n_traced), "in the traced run")
            wall = time.perf_counter() - t0
        steps = len(batches)
        m = dict(
            ms_per_step=self.ms([s / steps for s in mem]),
            target_tokens_per_s=self.rate("tokens/s", tokens, mem),
            loader_ms_per_step=self.ms([s / n for s in feed]),
            loader_target_tokens_per_s=self.rate("tokens/s", tokens,
                                                 feed))
        trace = read_trace(prof, wall, n_traced, np.median(
            [s / n * n_traced for s in feed]) if feed else 0.0,
            self.device)
        trace["traced"] = (f"Trainer.fit through the loader, the first "
                           f"{n_traced} batches; per step: a step")
        info = dict(impl=impl, steps_from_memory=steps,
                    steps_through_loader=n,
                    batches=[shape_of(b) for b in batches],
                    launches_per_pass={k: v for k, v in launches.items()
                                       if v},
                    step_path=trainer.step_path(batches[0].arrays()),
                    graphs=graph_info(trainer._step.graphs),
                    epoch_signatures=epoch_signatures(ld, cfg, True))
        if impl == "block_sparse":
            info["plan_device_ms"] = self.plan_ms(on_card)
        del trainer, model, on_card
        return dict(metrics=m, traced=trace, smi=smi, info=info)

    def plan_ms(self, on_card):
        """The block-sparse backward plan's device ms on each batch of a
        cell (once a step: the encoder stack builds it once), as
        benchlib.device_ms reads it: one sample a batch, each its median
        over PROFILE_ITERS calls."""
        from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
            backward_plan, pair_cap)

        samples = []
        for a in on_card if self.measured else ():
            samples.append(benchlib.device_ms(lambda a=a: backward_plan(
                a["tile_src"], a["tile_rel"], a["tile_dst"],
                a["tile_rel_src"], a["concept"].shape[1],
                a["rel_bank"].shape[0], pair_cap(a)), PROFILE_ITERS)[
                    "median"])
        return metric("ms", samples, self.measured)

    def c2_train_pallas_local(self):
        return self.train_cell("c2_train_pallas_local", "c2",
                               "pallas_local")

    def c2_train_pallas(self):
        return self.train_cell("c2_train_pallas", "c2", "pallas")

    def c4_train(self):
        return self.train_cell("c4_train", "c4", "pallas_local")

    def c5_train(self):
        return self.train_cell("c5_train", "c5", "block_sparse")

    # -------------------------------------------------- serving

    def serve_cell(self, name, family, impl):
        """decode_batch of the fullest batch of each of the smallest
        SERVE_BUCKETS node buckets, the tokens the same every repeat; a
        traced run."""
        from gtos_tpu_torch.infer import decode
        from gtos_tpu_torch.infer.decode import decode_batch

        cfg, _ = configs(family, impl, self.widths, self.seed)
        model = self.model(cfg)
        tv = corpus(family, self.seed)[1][0]
        plan = self.serve_plan(family, impl)
        self.captured[name] = capture(model, plan[0], False, self.device)
        served = model.serving_copy()
        steps = [0]
        search = decode.beam_decode_arrays

        def counted(*a, **kw):      # a search's steps: its final t
            res = search(*a, **kw)
            steps[0] += int(res.steps)
            return res

        def serve_all(times=None, batch_steps=None):
            hyps = []
            for batch in plan:
                t0, s0 = time.perf_counter(), steps[0]
                hyps.append(decode_batch(model, batch, tv, beam_size=BEAM,
                                         max_steps=MAX_STEPS))
                sync(self.device)
                if times is not None:
                    times.append(time.perf_counter() - t0)
                if batch_steps is not None:
                    batch_steps.append(steps[0] - s0)
            return hyps

        decode.beam_decode_arrays = counted
        batch_steps = []            # warm-up, and the tokens to repeat
        try:
            ref = serve_all(batch_steps=batch_steps)
        finally:
            decode.beam_decode_arrays = search
        n_steps = steps[0]
        counts0 = {k: wrapper(k).launches for k in KERNEL_WRAPPERS}
        walls, smi = [], []
        for r in range(self.repeats):
            times = []
            with smi_sampled(smi, self.device):
                got = serve_all(times)
            if got != ref:
                raise BenchFailure(f"{name}: repeat {r} served other tokens "
                                   "than the warm-up")
            walls.append(times)
        launches = {k: (wrapper(k).launches - counts0[k]) // self.repeats
                    for k in KERNEL_WRAPPERS}
        with traced(self.device, lambda: decode_batch(
                model, plan[0], tv, beam_size=BEAM,
                max_steps=MAX_STEPS)) as prof, attrs_spanned([
                    (served, "encode", "encode"),
                    (served, "decode_step", "decode_step")]):
            t0 = time.perf_counter()
            with annotate("bench/serve_batch"):
                decode_batch(model, plan[0], tv, beam_size=BEAM,
                             max_steps=MAX_STEPS)
            sync(self.device)
            wall = time.perf_counter() - t0
        totals = [sum(t) for t in walls]
        requests = sum(len(h) for h in ref)
        m = dict(wall_ms_per_batch=self.ms([s / len(plan) for s in totals]),
                 decode_steps_per_s=self.rate("steps/s", n_steps, totals),
                 requests_per_s=self.rate("requests/s", requests, totals))
        for i, batch in enumerate(plan):
            m[f"wall_ms_N{batch.concept_mask.shape[1]}"] = self.ms(
                [t[i] for t in walls])
        trace = read_trace(prof, wall, batch_steps[0], np.median(
            [t[0] for t in walls]) if walls else 0.0, self.device)
        trace["traced"] = (f"the N={plan[0].concept_mask.shape[1]} batch, "
                           f"{batch_steps[0]} decode steps; per step: a "
                           "decode step")
        info = dict(impl=impl, batches=[dict(shape_of(b), requests=len(h))
                                        for b, h in zip(plan, ref)],
                    decode_steps=batch_steps,
                    launches_per_pass={k: v for k, v in launches.items()
                                       if v},
                    first_hypothesis=" ".join(ref[0][0][:8]),
                    graphs=graph_info(decode.search_graphs(model)),
                    epoch_signatures=epoch_signatures(
                        loader(family, impl, False, self.seed), cfg, False))
        del model, served
        return dict(metrics=m, traced=trace, smi=smi, info=info)

    def serve_plan(self, family, impl):
        """The fullest batch of each of the SERVE_BUCKETS smallest node
        buckets of the serving loader."""
        fullest = {}
        for batch, insts in loader(family, impl, False,
                                   self.seed).iter_with_instances():
            N = batch.concept_mask.shape[1]
            if N not in fullest or len(insts) > len(fullest[N][1]):
                fullest[N] = (batch, insts)
        return [fullest[N][0] for N in sorted(fullest)[:SERVE_BUCKETS]]

    def c2_serve(self):
        return self.serve_cell("c2_serve", "c2", "pallas_local")

    def c4_serve(self):
        return self.serve_cell("c4_serve", "c4", "pallas_local")

    def c5_serve(self):
        return self.serve_cell("c5_serve", "c5", "block_sparse")

    # -------------------------------------------------- kernels

    # the kernels' rows: (kernel, the cell whose layer 0 gives the inputs)
    KERNEL_SOURCES = (
        ("B1", "c2_serve"), ("B1", "c4_serve"),
        ("B1p", "c2_train_pallas_local"), ("B2", "c2_train_pallas_local"),
        ("B1p", "c4_train"), ("B2", "c4_train"),
        ("B3", "c2_train_pallas"), ("B3'", "c2_train_pallas"),
        ("B4", "c2_train_pallas"),
        ("B5", "c5_serve"), ("B5s", "c5_train"), ("B6d", "c5_train"),
        ("B6s", "c5_train"), ("B6b", "c5_train"))

    def kernels(self):
        """Each kernel on the inputs its source cell captured (a source
        cell that did not run is set up and captured here, untimed)."""
        for source in dict.fromkeys(s for _, s in self.KERNEL_SOURCES):
            if source not in self.captured:
                self.capture_only(source)
        rows, smi = [], []
        for kernel, source in self.KERNEL_SOURCES:
            if kernel not in self.captured[source]["calls"]:
                raise BenchFailure(f"{source} never called {kernel}")
            rows.append(kernel_row(kernel, source, self.captured[source],
                                   self, smi))
            print(f"[bench] kernel {kernel} ({source}): " + json.dumps(
                {k: rows[-1][k] for k in ("shape", "bound_ms", "bound_by",
                                          "max_abs_err", "ms")}),
                  flush=True)
        return dict(rows=rows, smi=smi)

    def capture_only(self, source):
        """A source cell's model and its first batch, captured, untimed."""
        family = source.split("_")[0]
        impl = {"c2_train_pallas": "pallas", "c5_train": "block_sparse",
                "c5_serve": "block_sparse"}.get(source, "pallas_local")
        cfg, tcfg = configs(family, impl, self.widths, self.seed)
        model = self.model(cfg)
        if "serve" in source:
            self.captured[source] = capture(
                model, self.serve_plan(family, impl)[0], False, self.device)
            return
        self.captured[source] = self.capture_train(
            model, impl, self.train_batches(family, impl)[1])

    def capture_train(self, model, impl, batches):
        """capture() of a train cell's first batch; under "pallas" also a
        B3 call, which the card's rule (ops/relation_attention.py
        _inline_fits) routes no bank to: on the tables that build_tables
        makes of that batch's layer-0 B3' inputs, so that B3's row keeps
        the c2 batch's shape."""
        from gtos_tpu_torch.ops.relation_attention import build_tables

        step = capture(model, batches[0], True, self.device)
        if impl == "pallas":
            (q, k, v, a, b, *rest), kw = step["calls"]["B3'"]
            call = ((q, k, v, *build_tables(q, k, a, b), *rest), kw)
            step["calls"]["B3"], step["named"]["B3"] = call, named("B3",
                                                                   *call)
        return step

    # -------------------------------------------------- host

    def host(self):
        """Preprocess ms/graph with the native extractor and with the
        Python BFS (the same PackedPaths), and one epoch of each train
        loader in order and with HOST_WORKERS processes (the same arrays),
        ms per batch; c2 and c4."""
        from gtos_tpu_torch.data import dataloader
        from gtos_tpu_torch.graph.paths import pack_relation_paths

        m, info, smi = {}, {}, []
        real_packer = dataloader._path_packer
        for family in ("c2", "c4"):
            graphs, targets = raw_corpus(family, self.seed)

            def prep(python):
                if python:
                    dataloader._path_packer = lambda: (
                        "python", pack_relation_paths)
                try:
                    out = dataloader.preprocess(graphs, targets)
                finally:
                    dataloader._path_packer = real_packer
                if dataloader.EXTRACTOR != ("python" if python
                                            else "native"):
                    raise BenchFailure(f"host {family}: preprocess ran the "
                                       f"{dataloader.EXTRACTOR} extractor")
                return out

            native, python = prep(False), prep(True)
            same = all(np.array_equal(a.pair_paths.pair_idx,
                                      b.pair_paths.pair_idx)
                       for a, b in zip(native, python))
            if not same:
                raise BenchFailure(f"host {family}: the native and Python "
                                   "extractors differ")
            times = {False: [], True: []}
            for _ in range(self.repeats):
                for python in (False, True):
                    t0 = time.perf_counter()
                    prep(python)
                    times[python].append(
                        (time.perf_counter() - t0) / len(graphs))
            m[f"{family}_preprocess_native_ms_per_graph"] = self.ms(
                times[False])
            m[f"{family}_preprocess_python_ms_per_graph"] = self.ms(
                times[True])
            impl = "pallas_local"
            epochs = {}
            for workers in (0, HOST_WORKERS):
                ld = loader(family, impl, True, self.seed)
                ld.workers = workers
                try:
                    ld.epoch = 0
                    digests = [_digest(b) for b in ld]   # warm-up
                    epochs.setdefault("ref", digests)
                    if digests != epochs["ref"]:
                        raise BenchFailure(
                            f"host {family}: {workers} workers give other "
                            "batches than in order")
                    per = []
                    with smi_sampled(smi, self.device):
                        for _ in range(self.repeats):
                            ld.epoch = 0
                            t0 = time.perf_counter()
                            n = sum(1 for _ in ld)
                            per.append((time.perf_counter() - t0) / n)
                finally:
                    ld.close()
                m[f"{family}_batchify_ms_per_batch_workers{workers}"] = (
                    self.ms(per))
            info[family] = dict(graphs=len(graphs),
                                batches_per_epoch=len(epochs["ref"]),
                                cpu_count=os.cpu_count())
        return dict(metrics=m, smi=smi, info=info)


def _digest(batch) -> str:
    h = hashlib.sha256()
    for k, v in sorted(batch.arrays().items()):
        h.update(f"{k} {v.dtype} {v.shape}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------- entry


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", nargs="+", choices=CELLS, default=list(CELLS))
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("chiprun_out", "bench"))
    p.add_argument("--checkout",
                   help="another checkout: run both, in turns")
    p.add_argument("--device", default=None,
                   help="'cpu' for the tests (no timings); default the card")
    for name in WIDTHS:
        p.add_argument(f"--{name}", type=int, default=None,
                       help="replaces the config files' value")
    args = p.parse_args(argv)
    if args.repeats < 1:
        p.error("--repeats must be at least 1")
    return args


def run(args):
    from gtos_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    widths = {k: getattr(args, k) for k in WIDTHS}
    bench = Bench(device, widths, args.seed, args.repeats)
    card = None
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = benchlib.card_line()
        extractor, built, seconds = benchlib.build_all()
        if isinstance(extractor, Exception):
            raise extractor
        print(f"[bench] {card}; built {len(built)} kernel sources and the "
              f"native extractor in {seconds:.1f} s", flush=True)
    t_start = time.perf_counter()
    cells = {}
    for name in [c for c in CELLS if c in args.cells]:
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = getattr(bench, name)()
        result["seconds"] = time.perf_counter() - t0
        result["max_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated()
            if device.type == "cuda" else None)
        cells[name] = result
        os.makedirs(args.out, exist_ok=True)    # the cells so far
        with open(os.path.join(args.out, "cells.partial.json"), "w") as f:
            json.dump(cells, f, indent=1, default=float)
        print(f"[bench] {name}: {result['seconds']:.1f} s; "
              + json.dumps(result.get("metrics", {}))[:600], flush=True)
    kind = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    return dict(
        bench="gtos_tpu_torch.bench", card=card,
        device=dict(platform="gpu" if device.type == "cuda" else "cpu",
                    kind=kind, count=torch.cuda.device_count()
                    if device.type == "cuda" else 0),
        seed=args.seed, repeats=args.repeats,
        widths={k: v for k, v in widths.items() if v is not None},
        seconds=time.perf_counter() - t_start, cells=cells)


def compare(args):
    """--checkout: the same cells on the other checkout and on this one,
    each in its own process, in turns (that, this, this, that); each
    turn's JSON under args.out. Returns the medians of each turn."""
    rest = ["--cells", *args.cells, "--repeats", str(args.repeats),
            "--seed", str(args.seed)] + [
        f"--{k}={getattr(args, k)}" for k in ("device", *WIDTHS)
        if getattr(args, k) is not None]
    turns = []
    for i, (side, root) in enumerate((("that", args.checkout),
                                      ("this", str(ROOT)), ("this",
                                                            str(ROOT)),
                                      ("that", args.checkout))):
        out = os.path.abspath(os.path.join(args.out, f"turn{i}_{side}"))
        os.makedirs(out, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(Path(root).resolve()), os.environ.get("PYTHONPATH", "")]))
        with open(os.path.join(out, "log.txt"), "w") as log:
            proc = subprocess.run(
                [sys.executable, "-m", "gtos_tpu_torch.bench", *rest,
                 "--out", out], cwd=root, env=env, stdout=log,
                stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            raise BenchFailure(f"turn {i} ({side}, {root}) exited "
                               f"{proc.returncode}: see {out}/log.txt")
        with open(os.path.join(out, "bench.json")) as f:
            result = json.load(f)
        turns.append(dict(side=side, checkout=str(Path(root).resolve()),
                          medians=medians(result)))
        print(f"[bench] turn {i} ({side}): {json.dumps(turns[-1])[:800]}",
              flush=True)
    return dict(bench="gtos_tpu_torch.bench --checkout", card=result["card"],
                turns=turns)


def medians(result) -> dict:
    """Each cell's metric medians, and each kernel row's ms median."""
    out = {}
    for cell, r in result["cells"].items():
        if "rows" in r:
            out[cell] = {f"{x['kernel']} {x['source']}": x["ms"]["median"]
                         for x in r["rows"]}
        else:
            out[cell] = {k: v.get("median", v.get("value"))
                         for k, v in r["metrics"].items()}
    return out


def main(argv=None):
    args = parse_args(argv)
    result = compare(args) if args.checkout else run(args)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bench.json"), "w") as f:
        json.dump(result, f, indent=1, default=float)
    print(json.dumps(result, default=float))
    return result


if __name__ == "__main__":
    main()
