"""The training feed's copy of a batch to one card, staged.

A batch (GraphBatch.arrays() with its pair capacity, the dict that
models/generator.py batch_to_device copies array by array) is laid out in
one flat byte buffer (`layout`), packed into pinned host memory (`pack`)
and copied to the card in one asynchronous copy on a stream of its own
(`StagedCopy`). The device arrays are views of the flat device buffer
(`unpack`) with batch_to_device's keys, dtypes and shapes, so a step's
signature (utils/graphs.py) is the one batch_to_device's arrays give.

The copy is queued and never waited for on the host: the returned
`StagedBatch` carries the event recorded after the copy, and the step
makes its stream wait on it (`StagedBatch.wait`) before it reads the
arrays. So the prefetch thread that stages the next batch does not queue
behind the steps on the card, and the step's launch does not wait for
that thread's copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# every array starts at a multiple of this many bytes: cudaMalloc's own
# alignment, so a view starts where an allocation of its own would
ALIGN = 256

# (key, byte offset, bytes, numpy dtype, shape) of each array in the flat
# buffer
Layout = List[Tuple[str, int, int, np.dtype, tuple]]


def layout(arrays: Dict[str, np.ndarray]) -> Tuple[Layout, int]:
    """Where each array lies in one flat buffer, in `arrays`' order, and
    the buffer's size in bytes. Shapes are np.ascontiguousarray's, as
    batch_to_device copies them (a 0-d array becomes one of shape (1,))."""
    out, at = [], 0
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.ndim == 0:
            v = np.ascontiguousarray(v)
        out.append((k, at, v.nbytes, v.dtype, v.shape))
        at += -(-v.nbytes // ALIGN) * ALIGN
    return out, at


def pack(arrays: Dict[str, np.ndarray], plan: Layout, buf: torch.Tensor):
    """Copy each array into its place in `buf`, a CPU uint8 tensor of at
    least the layout's size (non-contiguous arrays are copied as
    np.ascontiguousarray would lay them out)."""
    host = buf.numpy()
    for k, at, size, dtype, shape in plan:
        dst = host[at:at + size].view(dtype).reshape(shape)
        np.copyto(dst, np.reshape(arrays[k], shape), casting="no")


def unpack(flat: torch.Tensor, plan: Layout) -> Dict[str, torch.Tensor]:
    """The arrays of `plan` as views of `flat` (a uint8 tensor packed by
    `pack`, on any device), with torch.from_numpy's dtypes."""
    out = {}
    for k, at, size, dtype, shape in plan:
        dt = torch.from_numpy(np.empty(0, dtype)).dtype
        out[k] = flat[at:at + size].view(dt).view(shape)
    return out


class StagedBatch(dict):
    """A batch's device arrays, views of `flat`, which a copy on another
    stream fills; `ready` is recorded after that copy."""

    def __init__(self, arrays, flat: torch.Tensor, ready: torch.cuda.Event):
        super().__init__(arrays)
        self.flat, self.ready = flat, ready

    def wait(self, stream: torch.cuda.Stream):
        """Make `stream` wait for the copy before the work queued next,
        and keep the flat buffer from reuse until `stream` has read it."""
        stream.wait_event(self.ready)
        self.flat.record_stream(stream)


class StagedCopy:
    """Stages batches to the card `device` (module docstring) on a copy
    stream of its own, made at the first batch. `batches` counts the
    batches it has staged."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = None
        self.batches = 0

    def __call__(self, arrays: Dict[str, np.ndarray]) -> StagedBatch:
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        plan, size = layout(arrays)
        host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        pack(arrays, plan, host)
        with torch.cuda.stream(self.stream):
            flat = torch.empty(size, dtype=torch.uint8, device=self.device)
            flat.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self.batches += 1
        return StagedBatch(unpack(flat, plan), flat, ready)
