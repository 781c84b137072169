"""The grid of ranks and the batch helpers (counterpart of
``sml_tpu/parallel/mesh.py``).

JAX runs one process per host with a mesh over its devices; the port runs one
process per device.  The ranks form a (data, seq) grid: rank = data_index *
seq + seq_index, with one process group per data row (the ``seq`` ranks that
share a batch and split its attentions' token rows) and one per seq column
(the ``data`` ranks that each hold a slice of the global batch).  Without a
process group the grid is one rank and no collective runs.

* ``shard_batch`` cuts a rank's rows out of a global batch (the eval loaders
  stay global on every rank, ``shard_batch(per_host_full=True)``);
* ``gather_outputs`` puts the data group's rows back together (the
  counterpart of ``fetch_global``; in training through
  ``gather_with_local_grad``, so the loss sees the global batch);
* ``replicate_state`` gives every rank the first rank's parameters, running
  averages and optimizer state (``replicate_tree``), bit for bit;
* ``sum_grads`` sums the parameters' gradients over the data group, the
  all-reduce that JAX's jit of the global-batch loss inserts.

The train loader yields each rank's local batch already (``num_shards`` /
``shard_id``), so a device-loop chunk is stacked from local batches, which is
what ``shard_stacked_batches`` puts on the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist

from sml_tpu_torch.parallel import collectives as C

# the process groups of each grid shape, made once per process group (as
# torch.distributed keeps its groups); dropped by ``reset_grid``
_GROUPS: Dict[tuple, tuple] = {}


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, seq) grid and its two process groups
    (None without a process group)."""
    world: int = 1
    rank: int = 0
    seq: int = 1
    data_group: Any = None
    seq_group: Any = None

    @property
    def data(self) -> int:
        return self.world // self.seq

    @property
    def data_index(self) -> int:
        return self.rank // self.seq

    @property
    def seq_index(self) -> int:
        return self.rank % self.seq

    @property
    def active(self) -> bool:
        """A process group exists (even of one rank): the collectives run."""
        return self.data_group is not None

    @property
    def primary(self) -> bool:
        return self.rank == 0


def make_grid(seq_devices: int = 0) -> Grid:
    """The grid of the initialized process group with ``seq_devices`` ranks per
    batch (0 / 1: every rank a data rank); one rank without a process group.
    The first call for a grid shape makes its groups, a collective call: every
    rank makes its grids in the same order (its model, then its steps)."""
    seq = max(int(seq_devices or 0), 1)
    if not dist.is_initialized():
        if seq > 1:
            raise ValueError(f"seq_devices={seq} needs {seq} ranks or a multiple: launch "
                             "the processes with --num_processes / --process_id / "
                             "--coordinator_address (or torchrun)")
        return Grid()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % seq:
        raise ValueError(f"seq_devices={seq} must divide the {world} ranks")
    key = (world, seq)
    if key not in _GROUPS:
        # new_group is collective over the whole world: every rank makes every group
        rows = [dist.new_group([d * seq + s for s in range(seq)])
                for d in range(world // seq)]
        cols = [dist.new_group([d * seq + s for d in range(world // seq)])
                for s in range(seq)]
        _GROUPS[key] = (rows, cols)
    rows, cols = _GROUPS[key]
    return Grid(world, rank, seq, data_group=cols[rank % seq], seq_group=rows[rank // seq])


def reset_grid() -> None:
    """Forget the groups (after the process group is destroyed)."""
    _GROUPS.clear()


def shard_batch(batch: Dict[str, Any], grid: Grid) -> Dict[str, Any]:
    """This data rank's contiguous rows of a global batch held by every rank
    (numpy arrays or tensors); a batch the data ranks do not divide raises."""
    if grid.data == 1:
        return batch

    def cut(x):
        if x.shape[0] % grid.data:
            raise ValueError(f"global batch dim {x.shape[0]} is not divisible by the "
                             f"{grid.data} data ranks; pick a batch_size they divide")
        per = x.shape[0] // grid.data
        return x[grid.data_index * per:(grid.data_index + 1) * per]

    return {k: cut(v) for k, v in batch.items()}


def gather_outputs(out: Dict[str, torch.Tensor], grid: Grid,
                   differentiable: bool = False) -> Dict[str, torch.Tensor]:
    """Every batch-leading tensor of ``out`` gathered over the data group in rank
    order (the global batch's rows in the loader's order); with
    ``differentiable`` the backward hands each rank its own rows' gradient."""
    if not grid.active:
        return out
    gather = C.gather_with_local_grad if differentiable else C.all_gather
    return {k: gather(v, grid.data_group) if torch.is_tensor(v) and v.dim() else v
            for k, v in out.items()}


def sum_grads(model: torch.nn.Module, grid: Grid) -> None:
    """Sum every parameter's gradient over the data group, in place, in one
    ``all_reduce`` (the parameters are f32)."""
    if not grid.active:
        return
    params = [p for p in model.parameters() if p.grad is not None]
    flat = C.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), grid.data_group)
    start = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[start:start + n].view_as(p.grad))
        start += n


def _optimizer_tensors(optimizer: torch.optim.Optimizer):
    return [v for state in optimizer.state.values() for v in state.values()
            if torch.is_tensor(v)]


def _state_tensors(state):
    return list(state.model.state_dict().values()) + _optimizer_tensors(state.optimizer)


def _device(state) -> torch.device:
    return next(state.model.parameters()).device


def replicate_state(state, grid: Grid) -> None:
    """The first rank's parameters, running averages and optimizer state on
    every rank, bit for bit (``replicate_tree``)."""
    if grid.active:
        C.replicate_from_first(_state_tensors(state), _device(state))


def replicas_equal(state, grid: Grid) -> bool:
    """Whether every rank holds the same parameters, running averages and
    optimizer state, bit for bit."""
    return not grid.active or C.replicas_equal(_state_tensors(state), _device(state))
