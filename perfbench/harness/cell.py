"""One run of one cell: the files that define it, found by name, the
traffic driver that runs it, and the result the run prints.

    perfbench/workloads/<cell>.json   config, driver, chips, params,
                                      limits of the check
    perfbench/configs/<config>.json   the model, its source and sizes
    perfbench/traffic/<driver>.py     the driver: run(ctx) -> dict
    perfbench/layer_metrics/<m>.py    read(record) -> number or None

BENCHMARK.json at the checkout's root names each metric's unit and which
cells report it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Callable, Optional

import torch

HERE = Path(__file__).resolve().parents[1]        # perfbench/
ROOT = HERE.parent                                # the checkout
# modules that may not be loaded in a run (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "gtos_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    cell = load_json(HERE / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_file"] = load_json(HERE / "configs" /
                                    f"{cell['config']}.json")
    return cell


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def metrics_of(bench: dict, name: str, section: str):
    """The `section` entries of BENCHMARK.json that cell `name` reports:
    those that list it, or, without a list, every cell that reports the
    end-to-end metric they move (end_to_end: every cell)."""
    out = []
    mine = {m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])}
    for m in bench[section]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in mine:
            out.append(m)
    return out


def reader(metric: str) -> Callable:
    """The per-layer metric's reader, perfbench/layer_metrics/<metric>.py
    `read`."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_layer_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a traffic driver gets: the cell and its configuration, the
    seed, the window's seconds, whether the run is traced, the device, a
    scratch directory, and the check's mode (control: the float8
    reference in the program's place; plant: a fault planted in the
    program's objects, for the check's own tests)."""

    def __init__(self, cell, seed, seconds, trace, device, workdir,
                 plant=None, control=False):
        from perfbench.traffic import corpora

        self.cell, self.config = cell, cell["config_file"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.workdir = device, workdir
        self.plant, self.control = plant, control
        self._gen = corpora.generate

    def generate(self, n: int, seed: int):
        return self._gen(self.config["corpus"], n, seed)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def memory_peak(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated())

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             overrides: Optional[dict] = None, plant=None,
             control: bool = False) -> dict:
    """Run cell `name` once. overrides: replaces keys of the cell's
    "params" and of its configuration's "model" (tests: tiny sizes on
    the CPU). Returns the driver's dict."""
    cell = workload(name)
    overrides = overrides or {}
    cell["params"] = dict(cell["params"], **overrides.get("params", {}))
    conf = cell["config_file"]
    conf["model"] = dict(conf["model"], **overrides.get("model", {}))
    traffic = importlib.import_module(f"perfbench.traffic.{cell['driver']}")
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    undo = []
    try:
        def planting(obj):
            undo.append(plant(obj))

        ctx = Context(cell, seed, seconds, trace, device, workdir,
                      planting if plant else None, control)
        return traffic.run(ctx)
    finally:
        for u in undo:
            if u is not None:
                u()
        shutil.rmtree(workdir, ignore_errors=True)


def passes(numbers: dict, limits: dict) -> bool:
    """Whether the check's numbers are within the cell's limits, and the
    counts of faults nought."""
    for k, v in numbers.items():
        if k == "detail":
            continue
        lim = limits.get(k, 0)
        if not (isinstance(v, (int, float)) and math.isfinite(v)
                and v <= lim):
            return False
    return True


def result(name: str, out: dict, trace: bool, device, chips: int,
           bench: dict) -> dict:
    """The line the run prints (the contract's keys), and the check."""
    cell = workload(name)
    limits = cell["limits"]
    numbers = out["numbers"]
    metrics = {}
    if not trace:
        for m in metrics_of(bench, name, "end_to_end"):
            v = out["setup_s"] if m["name"] == "setup_s" \
                else out["e2e"][m["name"]]
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for m in metrics_of(bench, name, "per_layer"):
            v = reader(m["name"])(out["record"])
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    correct = out["failed"] == 0 and passes(numbers, limits)
    cuda = device.type == "cuda"
    if not cuda:        # a CPU run gives no card number
        metrics = {k: dict(v, value=None) for k, v in metrics.items()}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=chips if cuda else 0,
               memory_peak_bytes=out["memory_peak"])
    line = dict(correct=correct, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=dev)
    if trace:
        from perfbench.harness.trace import breakdown, busy_s
        rec = out["record"]
        dev.update(busy_s=busy_s(rec) if cuda else None,
                   window_s=rec["window_s"] if cuda else None)
        line["breakdown"] = breakdown(rec)
    line["checks"] = {k: dict(value=v, limit=limits.get(k, 0))
                      for k, v in numbers.items() if k != "detail"}
    return line


def stop_children(timeout: float = 60.0):
    """Wait for every process this one started (the loader's batchify
    workers) to end, and stop the forkserver that started them and the
    resource tracker it started."""
    import multiprocessing
    from multiprocessing import forkserver

    from multiprocessing import resource_tracker

    for child in multiprocessing.active_children():
        child.join(timeout)
    for server, pid in ((getattr(forkserver, "_forkserver", None),
                         "_forkserver_pid"),
                        (getattr(resource_tracker, "_resource_tracker",
                                 None), "_pid")):
        if server is not None and getattr(server, pid, None):
            server._stop()


@contextlib.contextmanager
def caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels into gtos_tpu_torch/_build there)."""
    base = ROOT / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    yield
