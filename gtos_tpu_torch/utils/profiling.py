"""Tracing and step timing — port of gtos_tpu/utils/profiling.py.

  * trace(): context manager around torch.profiler that writes a Chrome /
    Perfetto trace (`trace.json`) into a directory, every thread's host
    events included;
  * StepTimer: host-clock throughput counters of the training loop
    (tokens/s and node pairs/s; the loop's lagged loss reads keep the
    host at most a few steps ahead of the card);
  * annotate(): the program's named spans (torch.profiler.record_function),
    on only while a torch profiler runs.

The program's spans are named "gtos/<layer>/<what>" and carry no step or
batch id: the prefetch queue is first in, first out, so the k-th
"gtos/trainer/prep" on the prefetch thread belongs to the k-th
"gtos/train/step" on the main thread, and a served batch's spans nest
inside its "gtos/decode/batch". They sit on the profiler's clock, beside
the kernels they launch, so an idle stretch of the card can be put down to
the span the host was inside. The batchify pool's worker processes are
never traced: their cost shows as "gtos/loader/pool_wait" on the thread
that waits for them. The module imports torch only where a profiler runs,
so the data layer, whose spans come from here, stays free of it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (every thread of the host, and the card when there
    is one) and write `logdir/trace.json`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        config = dict(experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    except (ImportError, TypeError):    # an older torch: this thread alone
        config = {}
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, **config) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named span: a context manager that a running torch profiler
    records as a CPU event, with the device work launched inside it as its
    children. With no profiler running it is a shared no-op, so a span
    costs one attribute check, where entering an idle record_function
    costs microseconds."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _OFF
    from torch.profiler import record_function
    return record_function(name)


class StepTimer:
    """Rolling throughput counters for the training loop."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.tokens = 0
        self.edges = 0
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.tokens = self.edges = self.steps = 0

    def step(self, n_tokens: int = 0, n_edges: int = 0):
        if self.t0 is None:
            self.start()
        self.tokens += n_tokens
        self.edges += n_edges
        self.steps += 1

    def rates(self) -> dict:
        dt = max(time.perf_counter() - (self.t0 or time.perf_counter()), 1e-9)
        return {"steps_per_s": self.steps / dt,
                "tokens_per_s": self.tokens / dt,
                "edges_per_s": self.edges / dt}
