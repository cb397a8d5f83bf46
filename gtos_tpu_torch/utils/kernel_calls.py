"""The kernel wrappers as the model finds them, and what the model hands
them: one way to stand a function in for a wrapper and to record a
step's kernel calls, for the bench (gtos_tpu_torch/bench.py) and for
chip_smoke.py's gates and planted kernels.

The model looks each wrapper up by name at call time, in its ops module
(B1 and B5 also by graph_transformer's own imported name), so a stand-in
set on those names is what the model calls. Each real wrapper counts its
launches on whatever its module's name holds (`wrapper.launches`): the
stand-in carries the count while it stands in and hands it back after.
Every swap, in and out, is counted (`swaps`): a CUDA graph captured
before a swap would replay the wrappers it recorded, so the graph caches
(utils/graphs.py) drop their graphs when the count moves.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect

import torch

# kernel -> (ops module, wrapper)
KERNEL_WRAPPERS = {
    "B1": ("local_relation_attention", "local_relation_attention"),
    "B1p": ("local_relation_attention",
            "local_relation_attention_with_probs"),
    "B2": ("local_relation_attention", "local_relation_attention_bwd"),
    "B3": ("relation_attention", "fused_relation_attention"),
    "B3'": ("relation_attention", "fused_relation_attention_inline"),
    "B4": ("relation_attention", "fused_relation_attention_bwd"),
    "B5": ("block_sparse_attention", "block_sparse_attention"),
    "B5s": ("block_sparse_attention", "block_sparse_attention_with_stats"),
    "B6d": ("block_sparse_attention_bwd", "block_sparse_attention_bwd_dst"),
    "B6s": ("block_sparse_attention_bwd", "block_sparse_attention_bwd_src"),
    "B6b": ("block_sparse_attention_bwd", "block_sparse_bank_grads"),
}
# the backward kernels: the stack runs them last layer first, so layer 0's
# is a step's last call
BACKWARD = ("B2", "B4", "B6d", "B6s", "B6b")
_SWAPS = [0]


def swaps() -> int:
    """How many times the wrappers have been swapped in or out."""
    return _SWAPS[0]


def ops_module(name):
    return importlib.import_module(f"gtos_tpu_torch.ops.{name}")


def wrapper(kernel):
    """The kernel's wrapper as its module holds it now."""
    mod, attr = KERNEL_WRAPPERS[kernel]
    return getattr(ops_module(mod), attr)


def plain(kernel):
    """The kernel's plain version (the wrapper's name + _reference)."""
    mod, attr = KERNEL_WRAPPERS[kernel]
    return getattr(ops_module(mod), attr + "_reference")


@contextlib.contextmanager
def kernels_wrapped(make):
    """Within the block each kernel's wrapper is make(kernel, real)
    wherever the model finds it (make may return real itself)."""
    from gtos_tpu_torch.models import graph_transformer as gt

    swapped = []
    for kernel, (mod_name, attr) in KERNEL_WRAPPERS.items():
        mod = ops_module(mod_name)
        real = getattr(mod, attr)
        fn = make(kernel, real)
        if fn is real:
            continue
        fn.launches = real.launches
        homes = [m for m in (mod, gt) if getattr(m, attr, None) is real]
        for m in homes:
            setattr(m, attr, fn)
        swapped.append((homes, attr, real, fn))
    _SWAPS[0] += 1
    try:
        yield
    finally:
        for homes, attr, real, fn in swapped:
            for m in homes:
                setattr(m, attr, real)
            real.launches = fn.launches
        _SWAPS[0] += 1


def replaced(kernel, fn):
    """Within the block the model calls fn in place of the kernel's
    wrapper (a planted kernel)."""
    return kernels_wrapped(lambda k, real: fn if k == kernel else real)


def named(kernel, args, kw):
    """A call's arguments by the wrapper's parameter names."""
    return dict(inspect.signature(wrapper(kernel)).bind(*args,
                                                        **kw).arguments)


def capture(model, batch, train, device):
    """Every kernel call of one more encode (serving: the serving copy, as
    decode_batch runs it) or forward and backward (training) of `batch`
    (a GraphBatch): {"calls": {kernel: layer 0's (args, kwargs), tensors
    detached}, "named": {kernel: the same by parameter name}}."""
    from gtos_tpu_torch.models.generator import (
        batch_edges, batch_to_device)

    calls = {}

    def make(kernel, real):
        def record(*args, **kw):
            calls.setdefault(kernel, []).append(
                (tuple(a.detach() if torch.is_tensor(a) else a
                       for a in args), kw))
            return real(*args, **kw)
        return record

    t = batch_to_device(batch.arrays(), device, train)
    with kernels_wrapped(make):
        if train:
            model.train()
            loss, _ = model(t)
            torch.autograd.grad(loss, [p for p in model.parameters()],
                                allow_unused=True)
        else:
            served = model.serving_copy()
            with torch.inference_mode():
                served.encode(t["concept"], t["concept_char"],
                              t["concept_mask"], t["rel_bank"],
                              t["rel_length"], t["rel_index"],
                              edges=batch_edges(t))
    first = {k: (v[-1] if k in BACKWARD else v[0]) for k, v in calls.items()}
    return dict(calls=first, named={k: named(k, *c)
                                    for k, c in first.items()})
