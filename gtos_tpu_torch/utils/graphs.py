"""CUDA graphs per signature: the port's counterpart of the JAX package's
one compiled program per batch signature (`jax.jit` of the train and eval
steps, gtos_tpu/train/trainer.py; of the whole search,
gtos_tpu/infer/decode.py).

A `Graphs` cache belongs to one model and holds that model's captured
steps by signature; every graph of the cache allocates from one memory
pool, so the buckets of a run share their activations' memory. Shapes are
static per signature (the DataLoader pads each batch to its bucket, the
decoder's self-KV buffers are sized to the search horizon), and each step
function reads its inputs from tensors refilled in place before the call
(`inputs`) and writes its state in place, so one graph serves every call
of its signature. `run(key, fn)`:

  * the first call of a signature runs `fn` uncaptured on the cache's side
    stream. That run is the call's own work and the warm-up PyTorch asks
    for before a capture (cuBLAS handles and workspaces, the autograd
    engine's threads) at once: nothing runs twice, so no parameter, moment
    or generator state needs restoring. Then `fn` is captured, which runs
    nothing on the card;
  * every later call replays the graph on the current stream and returns
    the tensors `fn` returned during the capture, rewritten by the replay
    (a caller that keeps them past the next call copies them).

A capture or a replay that fails raises; nothing falls back to running
uncaptured. Generators that `fn` draws from (the dropout generator) are
registered with its graph, so each replay draws what an uncaptured run
would have drawn and advances the generator as that run would.

The kernel wrappers count launches on the host as they launch. A replay
launches what the capture recorded without calling them, so each graph
keeps the launches its capture recorded, takes them back off the counts
(a capture runs nothing) and adds them again at each replay. The wrappers
can be swapped for stand-ins at call time (utils/kernel_calls.py: planted
kernels, the bench's spans); a swap empties every cache, so a graph never
replays a wrapper that no longer stands.

Spans (utils/profiling.py): "gtos/graphs/inputs" (the refill of the static
inputs), "gtos/graphs/replay" (a replay's launch), and at a signature's
first call "gtos/graphs/first" (the uncaptured run) then
"gtos/graphs/capture".
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, Optional

import torch

from gtos_tpu_torch.utils import kernel_calls
from gtos_tpu_torch.utils.profiling import annotate


def use_graphs(device: torch.device, compiled: Optional[bool]) -> bool:
    """Whether steps on `device` are captured: on the card unless
    compiled=False; never on the CPU (compiled=True there raises)."""
    on_card = torch.device(device).type == "cuda"
    if compiled is None:
        return on_card
    if compiled and not on_card:
        raise ValueError("CUDA graphs need the card; on the CPU the steps "
                         "run uncaptured (compiled=False or None)")
    return bool(compiled)


def signature(arrays) -> tuple:
    """Every array's name, shape and dtype: the part of a signature that
    the inputs fix."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in
                 sorted(arrays.items()))


class _Graph:
    def __init__(self, graph, out, launches, capture_s):
        self.graph, self.out = graph, out
        self.launches, self.capture_s = launches, capture_s


def _counts():
    return {k: kernel_calls.wrapper(k).launches
            for k in kernel_calls.KERNEL_WRAPPERS}


def _add_counts(delta, sign):
    for k, n in delta.items():
        kernel_calls.wrapper(k).launches += sign * n


class Graphs:
    """The CUDA graphs of one model, by signature, in one memory pool
    (module docstring). With enabled=False (the CPU, or compiled=False)
    `run` calls the step function directly."""

    def __init__(self, device, enabled: bool):
        self.device = torch.device(device)
        self.enabled = enabled
        self.graphs: Dict[Hashable, _Graph] = {}
        self._inputs: Dict[Hashable, Dict[str, torch.Tensor]] = {}
        self.replays = self.captures = 0
        self._swaps = kernel_calls.swaps()
        self._pool = self._stream = None

    def clear(self):
        """Drop every graph (their pool memory goes with the last one)."""
        self.graphs.clear()
        self._pool = None

    def inputs(self, key: Hashable, arrays: Dict[str, torch.Tensor]):
        """The tensors the graph of `key` reads its inputs from, refilled
        in place with `arrays` (made at the first call, outside the pool);
        `arrays` themselves where the steps run uncaptured."""
        if not self.enabled:
            return arrays
        static = self._inputs.get(key)
        if static is None:
            static = self._inputs[key] = {k: torch.empty_like(v)
                                          for k, v in arrays.items()}
        with annotate("gtos/graphs/inputs"):
            for k, v in arrays.items():
                static[k].copy_(v, non_blocking=True)
        return static

    def run(self, key: Hashable, fn: Callable, generators=()):
        """fn's result for this call (module docstring); generators: those
        fn draws from."""
        if not self.enabled:
            return fn()
        if self._swaps != kernel_calls.swaps():
            self.clear()
            self._swaps = kernel_calls.swaps()
        g = self.graphs.get(key)
        if g is not None:
            with annotate("gtos/graphs/replay"):
                g.graph.replay()
            _add_counts(g.launches, 1)
            self.replays += 1
            return g.out
        return self._first(key, fn, generators)

    def _first(self, key, fn, generators):
        """The signature's first call: fn uncaptured (the call's work and
        the warm-up), then its capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side, here = self._stream, torch.cuda.current_stream(self.device)
        side.wait_stream(here)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.stream(side):
            with annotate("gtos/graphs/first"):
                out = fn()
            before = _counts()
            t0 = time.perf_counter()
            # no collection inside the capture: a dropped graph that a
            # reference cycle kept alive, destroyed there, invalidates it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with annotate("gtos/graphs/capture"):
                    graph.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        static = fn()
                    except BaseException:
                        try:    # end the broken capture; the error is fn's
                            graph.capture_end()
                        except RuntimeError:
                            pass
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            capture_s = time.perf_counter() - t0
        here.wait_stream(side)
        after = _counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        _add_counts(launches, -1)       # the capture launched nothing
        self.graphs[key] = _Graph(graph, static, launches, capture_s)
        self.captures += 1
        return out

    def capture_ms(self) -> Dict[Hashable, float]:
        """Host ms each signature's capture took (recording and
        instantiating the graph)."""
        return {k: g.capture_s * 1e3 for k, g in self.graphs.items()}

    def pool_bytes(self) -> Optional[int]:
        """Bytes the card holds for this cache's pool (its segments in the
        allocator's snapshot); None before the first capture."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


def for_model(model, compiled: Optional[bool] = None) -> Graphs:
    """The graph cache of `model`, kept on it (`model.graphs`: one pool
    for its train, eval and search graphs, gone with the model), or a
    disabled one where its steps run uncaptured (`use_graphs`)."""
    if not use_graphs(model.device, compiled):
        return Graphs(model.device, False)
    if model.graphs is None:
        model.graphs = Graphs(model.device, True)
    return model.graphs
