"""Tracing and step timing — port of gtos_tpu/utils/profiling.py.

  * trace(): context manager around torch.profiler that writes a Chrome /
    Perfetto trace (`trace.json`) into a directory;
  * StepTimer: host-clock throughput counters of the training loop
    (tokens/s and node pairs/s; the loop's lagged loss reads keep the
    host at most a few steps ahead of the card);
  * annotate(): named trace spans (torch.profiler.record_function).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host, and the card when there is one) and write
    `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named span inside a captured trace: a context manager (and
    decorator) that torch.profiler records as a CPU event, with the device
    work launched inside it as its children."""
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
