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

The steps are train/trainer.py's, given the data group: the JAX package
jits the sharded steps into one program per signature, and the port
captures them per signature on the card as it does on one device, the
collectives inside the graph (trainer.py's docstring). Under a
context-parallel mesh they run uncaptured (trainer.EAGER_MESH).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def all_reduce_grads(grads, group):
    """The gradients summed over the group in one all-reduce: views of
    one flat buffer, in the order and shapes of `grads`."""
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    return list(_unflatten_dense_tensors(flat, grads))


def make_sharded_train_step(model, opt, mesh,
                            compiled: Optional[bool] = None) -> Callable:
    """train_step(arrays) -> metrics (device scalars: the global loss, acc
    and n_tok, grad_norm, layout_ok): one optimizer step of `opt`
    (train/optim.py, over the model's parameters, sharded before it was
    built under TP) on this rank's part of a batch (parallel/mesh.py
    shard_arrays), captured per signature on the card unless compiled is
    False or the mesh is context-parallel."""
    from gtos_tpu_torch.train.trainer import _TrainStep, mesh_compiled

    compiled = mesh_compiled(mesh, compiled)
    if mesh.size("model") > 1:
        from gtos_tpu_torch.parallel.tensor_parallel import global_norm
        params, group = opt.params, mesh.group("model")
        opt.norm_fn = lambda grads: global_norm(grads, params, group)
    return _TrainStep(model, opt, compiled, mesh.group("data"))


def make_sharded_eval_step(model, mesh, compiled: Optional[bool] = None
                           ) -> Callable:
    """eval_step(arrays) -> the global metrics of a batch whose rows are
    split over the data group (the same shard_arrays as training),
    captured as the train step."""
    from gtos_tpu_torch.train.trainer import make_eval_step, mesh_compiled

    return make_eval_step(model, mesh_compiled(mesh, compiled),
                          mesh.group("data"))
