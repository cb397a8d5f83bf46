"""The device mesh over torch.distributed, and each rank's part of a batch.

Port of gtos_tpu/parallel/mesh.py. A JAX device is a rank here: one
process on one card (or on the CPU). The mesh has the JAX package's three
axes,

  data  — batch rows (DP); the gradients are summed over it;
  model — tensor parallelism of the attention and FFN projections (TP,
          parallel/tensor_parallel.py);
  graph — node blocks of the context-parallel attention (CP, the ring and
          a2a schedules),

with the ranks laid out (data, model, graph) row-major, as
`np.array(devices).reshape(dp, mp, graph)` lays out the JAX devices, and
one process group per line of each axis. The backend is NCCL between
cards and gloo on the CPU.

Every rank builds the same whole batch (batchify is deterministic; under
DP with host_shard only its own rows are filled) and `shard_arrays` takes
its part: rows by data rank; the edge cells and per-cell tile layouts by
node block on the graph axis (the dst block, or the src block for the
edge cells under the a2a schedule); the rest whole. Activations outside
the CP attention are the same on every graph rank and every model rank
of one data rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model", "graph")

# GraphBatch arrays whose leading dim is the batch (the JAX package's list,
# with rel_index_loc: a rank's encoder reads its own rows of it); the
# relation bank and the rest are batch-global and stay whole
_BATCH_LEADING = (
    "concept", "concept_char", "concept_mask", "rel_index", "token_in",
    "token_out", "token_mask", "cp_seq", "copy_mask", "tile_src", "tile_rel",
    "tile_dst", "tile_rel_src", "rel_sort", "rel_bnd", "rel_sortT",
    "rel_bndT", "bank_map", "rel_index_loc",
)
# edge cells [B, S_dst, S_src, Ec]: rows by data rank, the dst block (or
# under "a2a" the src block) by graph rank
_EDGE_CELLS = ("edge_src", "edge_dst", "edge_rel", "edge_mask")
# per-cell tile layouts [B, S_dst, S_src, ...]: the dst block by graph rank
_CTILE = ("ctile_src", "ctile_rel", "ctile_dst", "ctile_rel_src")


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (data, model, graph) mesh: the axis sizes,
    its coordinates, and the process group of its line along each axis.
    `device` is where this rank computes."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device
    backend: str

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __deepcopy__(self, memo):
        return self   # process groups are shared, never copied


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(rank: int, world: int, init_method: str, device=None,
                     timeout_s: float = 600.0):
    """init_process_group for one rank: NCCL on a card (device "cuda" or
    "cuda:i"), gloo on the CPU; `init_method` a "tcp://host:port" or
    "file://path" rendezvous. On a card the rank's device is set first.

    The mesh steps capture their NCCL collectives in CUDA graphs
    (train/trainer.py), which sets nothing here: PyTorch's notes ask for
    NCCL >= 2.9.6 (PyTorch ships a later one), an eager run before the
    capture (a signature's first call runs uncaptured, utils/graphs.py,
    and creates the communicators) and, for their DDP recipe, no
    asynchronous error handling; ProcessGroupNCCL keeps captured work off
    its watchdog's queue, and a one-rank NCCL mesh on an H100 (PyTorch
    2.11, NCCL 2.28) captures and replays the steps bit for bit with its
    defaults (tests/test_torch_cuda.py, chip_smoke.py)."""
    import datetime

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend_for(device), init_method=init_method, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def rank_coords(rank: int, dp: int, mp: int, graph: int) -> Tuple[int, ...]:
    """(data, model, graph) coordinates of a global rank, row-major."""
    return (rank // (mp * graph), (rank // graph) % mp, rank % graph)


def make_mesh(dp: Optional[int] = None, mp: int = 1, graph: int = 1,
              device=None) -> Mesh:
    """The mesh over the initialized process group: world = dp*mp*graph
    (dp=None: world // (mp*graph)). Every rank must call it (it creates
    one group per axis line, in the same order on every rank)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.mesh.init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // (mp * graph)
    if dp * mp * graph != world:
        raise ValueError(f"mesh {dp}x{mp}x{graph} != {world} ranks")
    sizes = dict(data=dp, model=mp, graph=graph)
    grid = np.arange(world).reshape(dp, mp, graph)
    groups = {}
    for ax, axis in enumerate(AXES):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    if dist.get_backend() == "gloo":
        # gloo connects a new group's pairs as it makes the group, and one
        # side of a pair can finish first: a rank that went on and exited
        # would close pairs that its peers are still connecting
        dist.barrier()
    coords = dict(zip(AXES, rank_coords(rank, dp, mp, graph)))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(sizes, coords, groups, torch.device(device),
                dist.get_backend())


def _rows(x, mesh: Mesh):
    n = mesh.size("data")
    if n == 1:
        return x
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows not divisible by dp={n}; set "
                         "the DataLoader's batch_multiple to a multiple of "
                         "it")
    d = mesh.index("data")
    return x[d * (B // n):(d + 1) * (B // n)]


def shard_array(mesh: Mesh, name: str, value: np.ndarray,
                cp_schedule: str = "ring") -> np.ndarray:
    """This rank's part of one named batch array (module docstring)."""
    S, g = mesh.size("graph"), mesh.index("graph")
    if name in _EDGE_CELLS:
        value = _rows(value, mesh)
        if S > 1:
            value = (value[:, :, g:g + 1] if cp_schedule == "a2a"
                     else value[:, g:g + 1])
        return value
    if name in _CTILE:
        value = _rows(value, mesh)
        return value[:, g:g + 1] if S > 1 else value
    if name in _BATCH_LEADING:
        return _rows(value, mesh)
    return value


def shard_arrays(mesh: Mesh, arrays: Dict[str, np.ndarray],
                 cp_schedule: str = "ring") -> Dict[str, torch.Tensor]:
    """GraphBatch.arrays() -> this rank's tensors on mesh.device. The
    localize sort order (loc_perm, loc_bnd) is a flat order over every
    row's bank_map, so under DP it is rebuilt from this rank's rows."""
    from gtos_tpu_torch.data.batching import build_localize_aux
    from gtos_tpu_torch.models.generator import batch_to_device

    out = {k: shard_array(mesh, k, np.asarray(v), cp_schedule)
           for k, v in arrays.items()}
    if "loc_perm" in out and mesh.size("data") > 1:
        out["loc_perm"], out["loc_bnd"] = build_localize_aux(
            out["bank_map"], arrays["rel_bank"].shape[0])
    return batch_to_device(out, mesh.device)
