"""The traced run's record: the harness's spans, the profiler's device
events and the host's launch calls over the traced window.

Spans are set by the benchmark's own files around its calls into the
program's layers (the feed's next batch, the trainer's pack and copy and
its step, the serving loader's next batch, the search of a batch): each is (name, thread, start, end) on the host's
clock, kept in memory. Nothing is wrapped or swapped in the program: its
CUDA graphs replay in the traced window as in an untraced one, and a
kernel inside a graph is found by its CUDA symbol name in the profiler's
device events. The device's busy time is the union of its kernel, copy
and fill intervals, so work on two streams at once counts once.

The record (a plain dict; layer_metrics/ reads it) holds:
  window_s       the traced window's length
  spans          {name: [[thread, start_s, end_s], ...]}, window-relative
  device         [[name, start_s, end_s], ...], window-relative, clipped
  host_launches  the launch calls (kernels, graphs, copies, fills)
  work           the harness's counts of the window's work (steps,
                 requests, model operations, kernel bounds, ...)
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Dict, List, Optional

# the host calls that put work on the card's queue (the port's
# benchlib.LAUNCH_APIS)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")
WINDOW_SPAN = "perfbench/window"
TOP = 10
# the deepest nesting of the harness's spans on one thread
NESTING = 4


class Spans:
    """The harness's span log (on while `on`)."""

    def __init__(self, on: bool):
        self.on = on
        self.log: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.log.append((name, threading.current_thread().name, t0,
                             time.perf_counter()))

    def wrap(self, name: str, fn):
        def inner(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return inner


class Profile:
    """torch.profiler over the traced window (every thread where this
    torch can record them); `start()` and `stop()` mark the window."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.t0 = self.t1 = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        try:
            from torch._C._profiler import _ExperimentalConfig
            kw = dict(experimental_config=_ExperimentalConfig(
                profile_all_threads=True))
        except (ImportError, TypeError):
            kw = {}
        self.prof = profile(activities=acts, **kw)
        self.prof.__enter__()
        self._span = None
        return self

    def start(self):
        from torch.profiler import record_function

        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._span.__exit__(None, None, None)

    def __exit__(self, *exc):
        if self.cuda:      # the window's last device records
            time.sleep(0.5)
        t0 = time.perf_counter()
        self.prof.__exit__(*exc)
        self.cost = dict(stop_s=time.perf_counter() - t0)
        return False

    def record(self, spans: Spans, work: dict) -> dict:
        """The record of the window (module docstring)."""
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        self.cost["events_s"] = time.perf_counter() - t0
        start_ns = None
        for e in events:
            if e.name() == WINDOW_SPAN:
                start_ns = e.start_ns()
                end_ns = e.end_ns()
        if start_ns is None:
            raise RuntimeError("the profiler lost the window's span")
        window = (end_ns - start_ns) / 1e9
        device, launches = [], 0
        for e in events:
            name = e.name()
            dev = str(e.device_type()) != "DeviceType.CPU"
            if not dev:
                if name in LAUNCH_APIS and start_ns <= e.start_ns() <= end_ns:
                    launches += 1
                continue
            if e.is_user_annotation() or name.startswith("perfbench/"):
                continue        # a span's device-side range, not work
            a = max(e.start_ns(), start_ns)
            b = min(e.end_ns(), end_ns)
            if b > a:
                device.append([name, (a - start_ns) / 1e9,
                               (b - start_ns) / 1e9])
        out: Dict[str, list] = {}
        for name, thread, t0, t1 in spans.log:
            a, b = max(t0, self.t0), min(t1, self.t1)
            if b > a:
                out.setdefault(name, []).append(
                    [thread, a - self.t0, b - self.t0])
        self.cost.update(read_s=time.perf_counter() - t0, n=len(events))
        return dict(window_s=window, spans=out, device=device,
                    host_launches=launches, work=work, cost=self.cost)


# ---------------------------------------------------------------- reading


def busy_intervals(device) -> List[List[float]]:
    """The union of the device intervals, sorted."""
    merged: List[List[float]] = []
    for _, a, b in sorted(device, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(record) -> float:
    return sum(b - a for a, b in busy_intervals(record["device"]))


def breakdown(record, main: str = "MainThread") -> dict:
    """The device operations that took most time, and the idle time of
    the window by what the host was doing: each gap between the busy
    intervals named by the innermost harness span open on the main thread
    at its middle ("outside any span" else), summed by name."""
    by_name: Dict[str, float] = {}
    for name, a, b in record["device"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = busy_intervals(record["device"])
    edges = [0.0] + [x for ab in busy for x in ab] + [record["window_s"]]
    spans = sorted((a, b, name) for name, rows in record["spans"].items()
                   for thread, a, b in rows if thread == main)
    starts = [s[0] for s in spans]
    named: Dict[str, float] = {}
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid)
        inside = [s for s in spans[max(0, k - NESTING):k] if s[1] >= mid]
        label = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                 else "outside any span")
        named[label] = named.get(label, 0.0) + (b - a)
    longest = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(device_ops=[[k, v] for k, v in ops],
                idle_gaps=[[k, v] for k, v in longest])


def span_seconds(record, *names: str) -> float:
    return sum(b - a for n in names for _, a, b in record["spans"].get(n,
                                                                        ()))


def device_seconds(record, *patterns: str) -> Optional[float]:
    """Device seconds of the events whose name holds one of `patterns`
    (None where there is none)."""
    t = [b - a for name, a, b in record["device"]
         if any(p in name for p in patterns)]
    return sum(t) if t else None
