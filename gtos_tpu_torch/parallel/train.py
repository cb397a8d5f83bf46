"""The sharded train and eval steps: DP over the mesh's 'data' axis (with
TP and CP inside the model).

Port of gtos_tpu/parallel/train.py. There GSPMD inserts the gradient
reduction; here each rank computes its term of the global loss on its
rows (the sums divided by the all-reduced token count,
models/generator.py), and the gradients are SUMMED over the data group in
one coalesced all-reduce: the mean of per-rank means (DDP's default) is
another function whenever ranks hold different numbers of target
tokens. Over the model and graph groups nothing is reduced: the model's
boundaries (parallel/comm.py) leave the whole parameters' gradients equal
on every rank of them and the shards' their own. Under TP the clip's
norm sums the shards' squares over the model group.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def all_reduce_grads(grads, group):
    """Sum each gradient over the group, in one all-reduce (in place)."""
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)
    return grads


def sharded_grads(model, params, arrays, mesh):
    """(loss term, global metrics, gradients summed over the data group) of
    this rank's part of a batch, in train mode."""
    model.train()
    loss, metrics = model(arrays, data_group=mesh.group("data"))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss, metrics, all_reduce_grads(grads, mesh.group("data"))


def make_sharded_train_step(model, opt, mesh) -> Callable:
    """train_step(arrays) -> metrics (device scalars, the global loss, acc,
    n_tok and grad_norm): one optimizer step of `opt` (train/optim.py,
    over the model's parameters, sharded before it was built under TP) on
    this rank's part of a batch (parallel/mesh.py shard_arrays)."""
    params = opt.params
    if mesh.size("model") > 1:
        from gtos_tpu_torch.parallel.tensor_parallel import global_norm
        group = mesh.group("model")
        opt.norm_fn = lambda grads: global_norm(grads, params, group)

    def train_step(arrays: Dict[str, torch.Tensor]) -> dict:
        _, metrics, grads = sharded_grads(model, params, arrays, mesh)
        opt.step(grads)
        return {k: v.detach() for k, v in
                dict(metrics, grad_norm=opt.norm_fn(grads)).items()}

    return train_step


def make_sharded_eval_step(model, mesh) -> Callable:
    """eval_step(arrays) -> the global metrics of a batch whose rows are
    split over the data group (the same shard_arrays as training)."""
    data = mesh.group("data")

    @torch.no_grad()
    def eval_step(arrays: Dict[str, torch.Tensor]) -> dict:
        model.eval()
        return model(arrays, data_group=data)[1]

    return eval_step
