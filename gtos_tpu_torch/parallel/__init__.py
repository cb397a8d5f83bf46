"""The multi-device tier over torch.distributed (port of
gtos_tpu/parallel/): the (data, model, graph) mesh and each rank's part of
a batch (mesh.py), the collectives with the gradients it needs (comm.py),
the sharded train and eval steps (train.py), tensor parallelism
(tensor_parallel.py), the three context-parallel schedules
(ring_attention.py, a2a_attention.py, ring_block_sparse.py) and the
scaling report (scaling.py). Modules are imported by name: importing the
package loads none of them.

The JAX package's package-level names (gtos_tpu/parallel/__init__.py) are
given lazily (PEP 562), except its sharding helpers, which lay JAX arrays
out over a device mesh: `batch_sharding`, `replicate`, `param_spec`,
`shard_state` and `state_shardings` (and mesh.py's `arrays_shardings`).
The port has no sharded array to lay out: `shard_arrays` hands each rank
its part of a batch, `tensor_parallel.shard_model` splits the parameters
in place, and the optimizer's moments follow them."""

import importlib

_NAMES = {"make_mesh": "mesh", "shard_arrays": "mesh",
          "make_sharded_train_step": "train",
          "ring_sparse_relation_attention": "ring_attention",
          "a2a_sparse_relation_attention": "a2a_attention",
          "ring_block_sparse_relation_attention": "ring_block_sparse"}
__all__ = list(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                   name)
