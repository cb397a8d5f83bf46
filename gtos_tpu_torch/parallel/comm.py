"""Collectives with the gradients the mesh needs (torch.distributed).

torch has no differentiable send/recv, and torch.distributed.nn's
all_gather sums its gradient over the group, which at the CP attention's
boundary would give S times the gradient. These small autograd functions
are the JAX package's transposes:

  shift          ppermute to rank+1 of the group: the gradient goes to
                 rank-1 (ppermute's transpose); posted without waiting, so
                 the ring overlaps it with a step's compute;
  take_block     a rank's node block of a whole tensor; the gradient is the
                 blocks of every rank, gathered (never summed: the rest of
                 the model is the same on every rank of the group);
  gather_blocks  the whole tensor from every rank's block; the gradient is
                 this rank's block of it;
  sum_grads      an identity whose gradient is summed over the group (a
                 tensor every rank uses a different part of: the relation
                 banks under CP, a column layer's input under TP);
  all_reduce     summed over the group; the gradient passes unchanged (a
                 row layer's output under TP);
  gather_stack   all_gather into [S, ...]; the gradient of a rank's slice is
                 summed over the group (the a2a schedule's queries);
  all_to_all     slice d of dim 0 to rank d; its own transpose.

A schedule's loop (the rings, a2a) runs the ranks of `xchg.ranks` and
exchanges through `xchg`: a GroupExchange, where this process is one rank
of a process group, or an Emulated one, where one process runs all S
ranks and the exchanges move entries of Python lists. Both take and
return one entry per rank they run, so the distributed entries and the
emulations drive the same loop.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def post_exchange(tensors: Sequence[torch.Tensor], group, step: int = 1):
    """Send each tensor to the rank `step` ahead in the group and receive
    the same shapes from the rank `step` behind, without waiting: returns
    (received buffers, works). Read the buffers only after wait(works)."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to, group))
        ops.append(dist.P2POp(dist.irecv, r, frm, group))
    return recv, dist.batch_isend_irecv(ops)


def wait(works):
    for w in works:
        w.wait()


def exchange(tensors, group, step: int = 1) -> List[torch.Tensor]:
    recv, works = post_exchange(tensors, group, step)
    wait(works)
    return recv


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, works, *xs):
        ctx.group = group
        recv, w = post_exchange(xs, group, 1)
        works.extend(w)
        return tuple(recv)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None, *exchange(gs, ctx.group, -1))


def shift(tensors: Sequence[torch.Tensor], group):
    """Differentiable ring step: (received tensors from rank-1, works to
    wait on before reading them)."""
    works: list = []
    return _Shift.apply(group, works, *tensors), works


def _block(x, group, dim):
    me, n = dist.get_rank(group), dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, me * size, size)


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)].contiguous(), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def take_block(x, group, dim: int):
    return _TakeBlock.apply(x, group, dim)


def gather_blocks(x, group, dim: int):
    return _GatherBlocks.apply(x, group, dim)


def sum_grads(x, group):
    return _SumGrads.apply(x, group)


def all_reduce(x, group):
    return _AllReduce.apply(x, group)


def gather_stack(x, group):
    return _GatherStack.apply(x, group)


def all_to_all(x, group):
    return _AllToAll.apply(x, group)


class GroupExchange:
    """The exchanges of this process's rank of `group` (module docstring):
    the ring's shift differentiable, posted before a step's compute."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.ranks = [dist.get_rank(group)]

    def post(self, xs):
        """Start sending xs[0] (a tuple of tensors) to rank+1."""
        return shift(xs[0], self.group)

    def wait(self, posted):
        """The tuple received from rank-1, once it has arrived."""
        recv, works = posted
        wait(works)
        return [tuple(recv)]

    def gather_stack(self, xs):
        return gather_stack(xs[0], self.group)

    def all_to_all(self, xs):
        return [all_to_all(xs[0], self.group)]


class Emulated:
    """The exchanges of S ranks run in one process: the ring's shift is a
    rotation of the list (rank s receives rank s-1's entry), all_gather a
    stack, all_to_all a transpose of the [rank][slice] entries."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = list(range(size))

    def post(self, xs):
        return list(xs[-1:]) + list(xs[:-1])

    def wait(self, posted):
        return posted

    def gather_stack(self, xs):
        return torch.stack(list(xs))

    def all_to_all(self, xs):
        return [torch.stack([x[d] for x in xs]) for d in range(self.size)]
