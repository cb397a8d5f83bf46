"""The multi-device tier over torch.distributed (port of
gtos_tpu/parallel/): the (data, model, graph) mesh and each rank's part of
a batch (mesh.py), the collectives with the gradients it needs (comm.py),
the sharded train and eval steps (train.py), tensor parallelism
(tensor_parallel.py), the three context-parallel schedules
(ring_attention.py, a2a_attention.py, ring_block_sparse.py) and the
scaling report (scaling.py). Modules are imported by name: importing the
package loads none of them."""
