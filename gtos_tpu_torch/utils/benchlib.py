"""Benchmark helpers: timing, seeded input builders, roofline bounds and
the kernel-vs-plain gate, on an NVIDIA H100.

Port of gtos_tpu/utils/benchlib.py (`time_fn`, `attention_inputs`), and the
one copy of the measurement code that `chip_smoke.py` and
`gtos_tpu_torch/bench.py` share: the cold-cache kernel timer `time_ms`,
the H100's peaks and each kernel's bound (the least time the card could
take for its work on given inputs), and the gate that holds a kernel to
its plain version.

Every reading is checked. A timing that is not positive and finite, or a
kernel timing below BOUND_SLACK times its own bound (the card cannot beat
its roofline), raises ImpossibleReading: such a number is a broken timer,
not a fast kernel. On "cuda" a call is timed with CUDA events; on "cpu"
with the host clock (only tests ask for that). Neither falls back to the
other.

The north star's unit is the JAX package's: an edge is one ordered node
pair scored and aggregated by attention, B * N^2 per layer pass.
"""

from __future__ import annotations

import contextlib
import math
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, 700 W
# a reading below this share of its bound is impossible (the bounds count
# each byte and operation once; timer resolution is well under 5% of any
# bound of the kernels here)
BOUND_SLACK = 0.95
# the card's spin before each cold call: ~0.5 ms at the H100's 1.98 GHz,
# longer than the host takes to issue a wrapper's launches (B2's three, B4's
# two), so the wrapper's Python time stays out of the number; gaps inside a
# call of several kernels (a host sync) stay in it
SPIN_CYCLES = 1_000_000
L2_FLUSH_BYTES = 128 << 20           # > the H100's 50 MB L2
# the flush's kernel (a uint8 fill, which no kernel wrapper launches), and
# the calls `device_ms` runs beyond the ones it keeps
FLUSH_KERNEL = "FillFunctor<unsigned char>"
PROFILE_LEAD = 20
# host time a profiler window stays open before and after its work: the
# device events at its edges are dropped otherwise, more of them the
# longer the process has run (seen on the H100 machine's torch 2.11)
PROFILE_PAD_S = 0.5
# kernel against plain version on the same inputs; B1p's probabilities and
# B5s's statistics are f32 from the same f32 scores in both versions
# the host calls that put work on the card's queue: a kernel launch, a
# CUDA graph's launch, an asynchronous copy or fill (torch.profiler's
# runtime events)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")
KERNEL_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
              "bfloat16": dict(atol=3e-2, rtol=2e-2)}
PROBS_TOL = dict(atol=1e-5, rtol=1e-4)
# B6b's outputs held row by row (bank_row_reading): a bank row of few
# pairs lies far below the largest row, where the whole output's scale
# hides a pair summed into the wrong row or not at all. The limit lies
# between the sound kernel's readings on an H100 and those of
# chip_smoke.py's planted work lists (PERF.md, PR 14)
BANK_ROW_TOL = 1e-4


class ImpossibleReading(RuntimeError):
    """A timing no card can give: not positive, not finite, or below its
    bound."""


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# ---------------------------------------------------------------- timing


def summarize(samples) -> Dict[str, float]:
    """median, min, max, q1, q3 (numpy's linear quantiles) and n."""
    x = np.asarray(samples, dtype=np.float64)
    q1, med, q3 = np.quantile(x, (0.25, 0.5, 0.75))
    return dict(median=float(med), min=float(x.min()), max=float(x.max()),
                q1=float(q1), q3=float(q3), n=int(x.size))


def check_reading(seconds, bound_s: Optional[float] = None,
                  what: str = "a timing"):
    """Raises ImpossibleReading unless `seconds` is positive, finite and,
    where a bound is given, at least BOUND_SLACK x bound_s."""
    if not (seconds > 0 and math.isfinite(seconds)):
        raise ImpossibleReading(f"{what}: non-positive or non-finite reading "
                                f"{seconds!r} s")
    if bound_s is not None and seconds < BOUND_SLACK * bound_s:
        raise ImpossibleReading(
            f"{what}: {seconds * 1e3:.6f} ms is below {BOUND_SLACK} x its "
            f"bound {bound_s * 1e3:.6f} ms: the timer is broken")


def time_samples(fn: Callable, *args, iters: int = 20, warmup: int = 3,
                 device="cuda", cold: bool = False,
                 bound_s: Optional[float] = None) -> Dict[str, object]:
    """Seconds per call of fn(*args): `warmup` calls, then `iters` timed
    ones. On "cuda" CUDA events around each call (cold: the 50 MB L2
    flushed and the card spun SPIN_CYCLES before each, so the call finds
    its inputs in device memory and its launches queued); on "cpu" the host
    clock around each call. Every sample is checked (`check_reading`, with
    bound_s). Returns summarize()'s keys and "samples"."""
    device = torch.device(device)
    if device.type == "cuda":
        samples = _cuda_samples(fn, args, iters, warmup, cold)
    elif device.type == "cpu":
        for _ in range(warmup):
            fn(*args)
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            samples.append(time.perf_counter() - t0)
    else:
        raise ValueError(f"no timer for device {device}")
    for s in samples:
        check_reading(s, bound_s, getattr(fn, "__name__", "a call"))
    return dict(summarize(samples), samples=samples)


def _cuda_samples(fn, args, iters, warmup, cold):
    flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    for _ in range(warmup):
        fn(*args)
    events = []
    for _ in range(iters):
        if cold:
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) * 1e-3 for s, e in events]


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3,
            device="cuda") -> float:
    """Median seconds per call of fn(*args) (the JAX package's contract)."""
    return time_samples(fn, *args, iters=iters, warmup=warmup,
                        device=device)["median"]


def time_ms(fn: Callable, iters: int = 30, warmup: int = 3,
            bound_ms: Optional[float] = None) -> float:
    """A kernel call's mean device ms over `iters` cold calls on the card
    (`time_samples` with cold=True), checked against bound_ms."""
    got = time_samples(fn, iters=iters, warmup=warmup, cold=True,
                       bound_s=None if bound_ms is None else bound_ms * 1e-3)
    return sum(got["samples"]) / len(got["samples"]) * 1e3


def device_ms(fn: Callable, iters: int = 10,
              bound_ms: Optional[float] = None) -> Dict[str, object]:
    """Device time of each of `iters` calls of fn on the card, each after
    the L2 flush, as torch.profiler records it: the kernels and copies on
    the card's timeline between one flush and the next. Beside
    `time_samples`' event window it shows the host gaps inside a call of
    several launches (their difference). The profiler can drop the device
    events at the edges of a window (PROFILE_PAD_S of host time opens and
    closes it), so the window holds PROFILE_LEAD more calls, and the calls
    kept are
    the first `iters` whose device events number the most common count.
    Returns summarize()'s keys in ms."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(PROFILE_LEAD + iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    calls = []          # per call after a flush: its events' durations
    for e in dev:
        if FLUSH_KERNEL in e.name:
            calls.append([])
        elif calls:
            calls[-1].append(e.time_range.elapsed_us() / 1e3)
    counts = collections.Counter(len(c) for c in calls)
    mode = max(counts, key=lambda n: (counts[n], n), default=0)
    whole = [c for c in calls if len(c) == mode][:iters]
    if mode == 0 or len(whole) < iters:
        seen = collections.Counter(e.name[:100] for e in dev)
        raise ImpossibleReading(
            f"the profiler's window of {PROFILE_LEAD + iters} calls holds "
            f"{len(whole)} whole ones ({dict(counts)} calls by device "
            f"events): {dict(seen)}")
    ms = [sum(c) for c in whole]
    for x in ms:
        check_reading(x * 1e-3, None if bound_ms is None else bound_ms * 1e-3,
                      "device time")
    return summarize(ms)


def build_all():
    """Every kernel source (one nvcc each, ops/build.py) and the native path
    extractor (g++), all started together. Returns (the extractor's
    (seconds, whether it compiled) or the exception its build raised,
    [(source, seconds, nvcc's output)], total seconds); a failed kernel
    build raises."""
    from concurrent.futures import ThreadPoolExecutor

    from gtos_tpu_torch import native
    from gtos_tpu_torch.ops import block_sparse_attention as bsa
    from gtos_tpu_torch.ops import block_sparse_attention_bwd as bsab
    from gtos_tpu_torch.ops import build
    from gtos_tpu_torch.ops import local_relation_attention as lra
    from gtos_tpu_torch.ops import relation_attention as ra

    sources = lra.SOURCES + ra.SOURCES + (bsa.FWD_SOURCE, bsab.BWD_SOURCE)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return time.perf_counter() - t0, out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        cpp = pool.submit(timed, native.build)
        results = [(s, *r) for s, r in zip(sources, pool.map(
            lambda s: timed(build.build, s), sources))]
    try:
        extractor = cpp.result()
    except (OSError, RuntimeError) as e:
        extractor = e
    return extractor, results, time.perf_counter() - t0


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's and PyTorch's deterministic algorithms inside the block (the
    earlier settings after it), for comparisons of whole train runs: the
    default ones sum some gradients (the char CNN's, the embeddings') in
    no fixed order, and Adam, whose eps is far below those gradients,
    turns a last-bit change of a gradient near 0 into a step of the
    learning rate. Ops without a deterministic version warn. cuBLAS is
    deterministic on its own only where CUBLAS_WORKSPACE_CONFIG was set
    before its first call (chip_smoke's main sets ":4096:8")."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


# ---------------------------------------------------------------- inputs


def attention_inputs(gen: torch.Generator, B, H, N, Dh, P,
                     dtype=torch.bfloat16, device="cuda"):
    """The JAX function's seven arrays, drawn from `gen` (a CPU generator)
    and moved to `device`: q, k, v [B, H, N, Dh] and a_bank, b_bank
    [P, H, Dh] standard normal in `dtype`, rel_index [B, N, N] int32 in
    [0, P), mask [B, N] all true."""
    def normal(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    q, k, v = normal(B, H, N, Dh), normal(B, H, N, Dh), normal(B, H, N, Dh)
    a_bank, b_bank = normal(P, H, Dh), normal(P, H, Dh)
    rel_index = torch.randint(0, P, (B, N, N), generator=gen,
                              dtype=torch.int32)
    mask = torch.ones(B, N, dtype=torch.bool)
    return tuple(x.to(device) for x in (q, k, v, a_bank, b_bank, rel_index,
                                        mask))


def honest_batch(n_graphs, seed, min_nodes, max_nodes):
    """A serving batch from the port's batchify on the synthetic AMR corpus
    (local banks), as the JAX package's bench.py builds its inputs."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus

    graphs, targets = synthetic_amr_corpus(
        n_graphs, seed=seed, min_nodes=min_nodes, max_nodes=max_nodes)
    vocabs = build_vocabs(graphs, targets)
    spec = BucketSpec(bank=(4096, 8192, 16384, 32768, 65536))
    return batchify(preprocess(graphs, targets), *vocabs,
                    batch_size_bucket=n_graphs, spec=spec, for_train=False,
                    build_local_banks=True)


# ---------------------------------------------------------------- bounds


def bound(nbytes, ops, dtype_name):
    """(bound_ms, bound_by): bytes over 3.35 TB/s against operations over
    the card's peak for the type, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bank_rows(rel_index_loc):
    """Bank rows these inputs reference: per graph, the distinct slots of
    rel_index_loc [B, N, N]."""
    return sum(len(np.unique(rel_index_loc[b]))
               for b in range(rel_index_loc.shape[0]))


def local_attention_bound(rel_index_loc, H, Dh, dtype_name,
                          with_probs=False):
    """(bound_ms, bound_by): the least time for B1's work (B1p's with
    with_probs) on these inputs on an H100 SXM. Bytes: q, k, v read and
    out written once, idx and mask read once, of a_loc/b_loc only the rows
    these inputs reference, and B1p's f32 probs [B, H, N, N] written once.
    Operations: per pair and head, Dh multiply-adds for the score and Dh
    for the output."""
    B, N, _ = rel_index_loc.shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (4 * B * H * N * Dh * elt + B * N * N * 4 + B * N
              + 2 * _bank_rows(rel_index_loc) * H * Dh * elt)
    if with_probs:
        nbytes += B * H * N * N * 4
    return bound(nbytes, B * H * N * N * 4 * Dh, dtype_name)


def local_attention_bwd_bound(rel_index_loc, H, Dh, P_loc, dtype_name):
    """(bound_ms, bound_by) of B2 on these inputs on an H100 SXM. Bytes:
    q, k, v read once, the f32 cotangent and probs read once, idx and the
    walk arrays (pair order, slot starts) read once, of a_loc/b_loc the
    referenced rows, gq/gk/gv written once and the dense bank gradients
    g_a_loc/g_b_loc [B, P_loc, H, Dh] written in full. Operations: per
    pair and head, Dh multiply-adds each for g.v, gq, gk, gv, g_a, g_b."""
    B, N, _ = rel_index_loc.shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (3 * B * H * N * Dh * elt + B * H * N * Dh * 4
              + B * H * N * N * 4 + 2 * B * N * N * 4 + B * (P_loc + 1) * 4
              + 2 * _bank_rows(rel_index_loc) * H * Dh * elt
              + 3 * B * H * N * Dh * elt + 2 * B * P_loc * H * Dh * elt)
    return bound(nbytes, B * H * N * N * 12 * Dh, dtype_name)


def _pair_entries(idx):
    """Table entries these pairs reference, per head: the distinct
    (graph, i, r) of t2 and (graph, j, r) of t3, r = idx[b, i, j]."""
    B, N, _ = idx.shape
    width = int(idx.max()) + 1
    node = np.arange(N)
    rows = sum(len(np.unique(idx[b] + node[:, None] * width))
               for b in range(B))
    cols = sum(len(np.unique(idx[b] + node[None, :] * width))
               for b in range(B))
    return rows + cols


def _table_sectors(idx, H, P, elt):
    """The distinct 32-byte sectors of t2 and t3 [B, H, N, P] (elt bytes an
    entry) that these pairs read: t2[b, h, i, r] and t3[b, h, j, r],
    r = idx[b, i, j]."""
    B, N, _ = idx.shape
    node = np.arange(N, dtype=np.int64)
    rows = ((np.arange(B, dtype=np.int64)[:, None] * H + np.arange(H))
            * N)[:, :, None, None]                     # (b, h)'s first row
    r = idx.astype(np.int64)[:, None]
    return sum(len(np.unique(((rows + own) * P + r) * elt // 32))
               for own in (node[:, None], node[None, :]))


def global_attention_bound(idx, H, Dh, P, dtype_name, kind, sectors=False):
    """(bound_ms, bound_by) on an H100 SXM of B3 ("tables"), B3'
    ("inline") or B4 ("bwd") on these inputs. Bytes: q, k, v (and B4's
    cotangent) read once, the output written once (B4: gq, gk, gv in f32
    and the dense table gradients [B, N, H, P] in full), idx and mask read
    once (B4: and its two walk orders), and of the tables the entries the
    pairs reference (B3, B4) or of the banks the rows they reference and
    their t4 (B3'). Operations per pair and head: q.k and p.v (B3); q.k,
    q.b, k.a and p.v (B3'); q.k, g.v, gv, gq and gk (B4), each Dh
    multiply-adds. With sectors (B3, B4: the sector floor), each distinct
    32-byte sector of t2/t3 that the pairs touch counts once in place of
    each referenced entry at its element size: the card reads at least a
    sector per scattered load."""
    B, N, _ = idx.shape
    elt = 2 if dtype_name == "bfloat16" else 4
    base = B * N * N * 4 + B * N
    if kind == "inline":
        rows = len(np.unique(idx))
        nbytes = (4 * B * H * N * Dh * elt + base
                  + rows * H * (2 * Dh * elt + 4))
        return bound(nbytes, B * H * N * N * 8 * Dh, dtype_name)
    tables = (_table_sectors(idx, H, P, elt) * 32 if sectors
              else _pair_entries(idx) * H * elt)
    if kind == "tables":
        nbytes = 4 * B * H * N * Dh * elt + base + tables
        return bound(nbytes, B * H * N * N * 4 * Dh, dtype_name)
    nbytes = (4 * B * H * N * Dh * elt + base + 2 * B * N * N * 4
              + tables + 3 * B * H * N * Dh * 4 + 2 * B * N * H * P * elt)
    return bound(nbytes, B * H * N * N * 10 * Dh, dtype_name)


def block_bound(kind, args, src_planes=None):
    """(bound_ms, bound_by) on an H100 SXM of B5, B5s, B6d, B6s or B6b on
    these inputs (args: B5's q, k, v, a_bank, b_bank, tile_src, tile_rel).
    Counted once each: the inputs read and the outputs written (B5: q, k,
    v, out; B5s: and m, l; B6d: q, k, v, gp, the statistics and delta, dq,
    ge and pair_s [H, E, 2] f32, dst2src; B6s: q, gp, pair_s, dk, dv; B6b:
    ge, the three sorted pair arrays, q, k and the dense g_a, g_b [P, H,
    Dh]); the tile planes walked (B6s: the src-major ones, src_planes) and
    B6's row bases; of the banks only the rows the kept pairs reference
    (B6s: of a only), with their t4 (B5, B5s, B6d). Operations per kept
    pair and head, in Dh multiply-adds (2 operations each): q.k, q.b, k.a,
    p.v (B5); q.k, q.b, k.a, g.v, dq (B6d); dk (two) and dv (B6s); g_a,
    g_b (B6b)."""
    from gtos_tpu_torch.ops.block_sparse_attention import tile_pairs

    q, P, ts, tr = args[0], args[3].shape[0], args[5], args[6]
    B, H, N, Dh = q.shape
    name = dtype_name(q)
    elt = 2 if name == "bfloat16" else 4
    r = tile_pairs(ts, tr, N, P)[3]
    E, R = r.numel(), len(r.unique())
    node, stats = B * H * N * Dh * elt, B * H * N * 4
    planes = (ts.numel() + tr.numel()) * 4
    banks = R * H * (2 * Dh * elt + 4)
    if kind == "B5":
        nbytes, macs = 4 * node + planes + banks, 4
    elif kind == "B5s":
        nbytes, macs = 4 * node + 2 * stats + planes + banks, 4
    elif kind == "B6d":
        nbytes = (5 * node + 3 * stats + planes + tr.numel() // 128 * 4
                  + banks + H * E * 12 + E * 4)
        macs = 5
    elif kind == "B6s":
        ts_, trs = src_planes
        nbytes = (4 * node + R * H * Dh * elt + H * E * 8
                  + (ts_.numel() + trs.numel() + trs.numel() // 128) * 4)
        macs = 3
    else:
        nbytes = (H * E * 4 + 3 * E * 4 + 2 * node + R * H * 2 * Dh * elt
                  + 2 * P * H * Dh * elt)
        macs = 2
    return bound(nbytes, 2 * macs * E * H * Dh, name)


# ---------------------------------------------------------------- the gate


def rel_to_largest(got, ref, largest=None) -> float:
    """The largest error of the outputs `got` against the plain ones `ref`,
    each relative to the plain output's own largest magnitude (or to
    largest[n], where that is given and not None): the check that holds a
    small output (a training step's gradients lie far below KERNEL_TOL's
    atol) to KERNEL_TOL's rtol."""
    rels = []
    for n, (x, y) in enumerate(zip(got, ref)):
        top = None if largest is None else largest[n]
        if top is None:
            top = y.float().abs().max().item()
        rels.append((x.float() - y.float()).abs().max().item()
                    / max(top, 1e-30))
    return max(rels)


def b4_largest(refs):
    """`rel_to_largest`'s scale for B4's outputs (gq, gk, gv, g_t2, g_t3):
    gq, gk and gv their own largest values; g_t2 and g_t3 the larger of
    their two. Each row of ge sums to 0, so a table row whose pairs all
    share one bank row holds rounding noise only (every g_t2 row at P=1),
    and its own largest value is no scale for its error."""
    top = max(refs[3].float().abs().max().item(),
              refs[4].float().abs().max().item())
    return (None, None, None, top, top)


def disagreement(names, got, refs, dtype_name, largest=None):
    """Why a kernel's outputs `got` disagree with the reference ones, or
    None: each within KERNEL_TOL and, as a training step's gradients can
    lie far below its atol, each within its rtol of the reference's own
    largest value (`rel_to_largest`, with `largest`)."""
    for n, (name, x, ref) in enumerate(zip(names, got, refs)):
        try:
            torch.testing.assert_close(x.float(), ref.float(),
                                       **KERNEL_TOL[dtype_name])
        except AssertionError as e:
            return f"{name} disagrees with its reference: {e}"
        rel = rel_to_largest((x,), (ref,),
                             None if largest is None else (largest[n],))
        if rel > KERNEL_TOL[dtype_name]["rtol"]:
            return (f"{name}'s error is {rel:.3e} of its largest value, "
                    f"above {KERNEL_TOL[dtype_name]['rtol']}")
    return None


def bank_row_reading(got, ref):
    """(reading, row) of an output [P, ...] against its plain version, row
    by row: the largest |got - ref| in excess of one unit in the last
    place of the output's type at that element, relative to its row's
    largest plain value (inf for a row written where the plain row is 0).
    Both versions round f32 sums of the same terms once to the output's
    type, so a sound kernel's excess is the gap of its f32 sums, and a
    pair left out or summed twice shows at the scale of its own row."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    ulp = torch.ldexp(torch.full_like(g, torch.finfo(got.dtype).eps),
                      e - 1)
    rows = lambda x: x.reshape(len(x), -1).amax(1)  # noqa: E731
    excess = rows(((g - r).abs() - ulp).clamp_min(0))
    top = rows(r.abs())
    rel = torch.where(top > 0, excess / top.clamp_min(1e-30),
                      torch.where(excess > 0, math.inf, 0.0))
    row = int(rel.argmax())
    return float(rel[row]), row


def bank_row_disagreement(names, got, refs):
    """Why B6b's outputs `got` disagree with the plain ones row by row
    (bank_row_reading above BANK_ROW_TOL), or None; and the largest
    reading."""
    worst = 0.0
    for name, x, y in zip(names, got, refs):
        reading, row = bank_row_reading(x, y)
        worst = max(worst, reading)
        if not reading <= BANK_ROW_TOL:
            return (f"{name}'s bank row {row} is off by {reading:.3e} of "
                    f"its largest value beyond one rounding, above "
                    f"{BANK_ROW_TOL}"), worst
    return None, worst


def b6b_library(q, k, a, ge, plan):
    """B6b's yardstick: one torch.sparse.mm that computes its per-row sums.
    A COO [P*H, 2*B*H*N] matrix holds two entries ge' per (pair, head), at
    q_i's row in the first half of the columns and at k_j's in the second;
    times the block-diagonal [[q, 0], [0, k]] [2*B*H*N, 2*Dh], its row
    (r, h) is (sum ge' q_i, sum ge' k_j). The elementwise dt4 term is not
    in it. Built here, outside any timing, in the input type, or in f32
    where the card's sparse product refuses it. Returns (fn, its type's
    name, the largest error of its sums against the plain sums, the
    refusals met)."""
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import real_pairs

    B, H, N, Dh = q.shape
    P = a.shape[0]
    bi, i, j, r = real_pairs(plan)
    ge = ge[:, :len(r)]             # the kernel's is [H, E_cap]
    h = torch.arange(H, device=q.device)
    rows = (r[:, None] * H + h).flatten()
    cq = ((bi[:, None] * H + h) * N + i[:, None]).flatten()
    ck = ((bi[:, None] * H + h) * N + j[:, None]).flatten() + B * H * N
    idx = torch.stack([torch.cat([rows, rows]), torch.cat([cq, ck])])
    refused: List[str] = []
    for dtype in dict.fromkeys((q.dtype, torch.float32)):
        w = ge.T.to(q.dtype).to(dtype).flatten()
        mat = torch.sparse_coo_tensor(idx, torch.cat([w, w]),
                                      (P * H, 2 * B * H * N),
                                      check_invariants=True).coalesce()
        dense = torch.zeros(2 * B * H * N, 2 * Dh, dtype=dtype,
                            device=q.device)
        dense[:B * H * N, :Dh] = q.reshape(-1, Dh)
        dense[B * H * N:, Dh:] = k.reshape(-1, Dh)
        fn = lambda: torch.sparse.mm(mat, dense)  # noqa: E731
        try:
            got = fn().float().view(P, H, 2 * Dh)
        except RuntimeError as e:
            refused.append(f"{dtype_name(dense)}: "
                           f"{str(e).splitlines()[0][:120]}")
            continue
        geq = ge.T.to(q.dtype).float()
        sq = torch.zeros(P, H, Dh, device=q.device).index_add_(
            0, r, geq[..., None] * q[bi, :, i].float())
        sk = torch.zeros(P, H, Dh, device=q.device).index_add_(
            0, r, geq[..., None] * k[bi, :, j].float())
        err = max((got[..., :Dh] - sq).abs().max().item(),
                  (got[..., Dh:] - sk).abs().max().item())
        return fn, dtype_name(dense), err, refused
    raise RuntimeError("torch.sparse.mm refuses B6b's yardstick in every "
                       f"type: {refused}")
