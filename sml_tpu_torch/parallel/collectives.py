"""Collectives of the port (counterpart of ``sml_tpu/parallel/collectives.py``),
each built from ``all_gather`` and ``all_reduce`` (SUM or MAX) alone: these two
exist on every backend, NCCL and gloo, on CPU and on CUDA tensors (gloo runs
both on CUDA tensors, bf16 included, so nothing is staged through host memory
here).  A broadcast is an ``all_gather`` of which every rank keeps the first
rank's slot; a halo exchange an ``all_gather`` of the few edge rows, of which
each rank keeps its neighbours'; a barrier an ``all_reduce`` of one number.

The ``torch.autograd.Function``s fix the backward of each boundary between
what a rank holds alone (a shard) and what every rank of a group holds alike
(replicated), so that every rank ends a backward with the gradient of the one
loss they all compute:

* ``gather_with_local_grad``: shards gathered for a replicated consumer (the
  loss over the global batch; a sharded attention's output): the backward
  keeps the rank's own slice of the gradient, as the JAX function does
  (the reference's GatherLayer);
* ``gather_sum_grad``: shards gathered for a sharded consumer (landmarks,
  sampled keys and values, halo rows): each rank's gradient is a part, so the
  backward sums it over the group, then keeps its own slice (the transpose
  of ``lax.all_gather`` under ``shard_map``);
* ``all_reduce_sum``: partial sums for a sharded consumer; the backward sums
  the gradient too (``lax.psum`` and its transpose);
* ``shard_slice``: a replicated tensor cut into this rank's shard; the
  backward gathers the shards' gradients;
* ``replicated``: replicated tensors read inside a sharded body (weights,
  the full path stream): the identity, whose backward sums the gradients of
  all of them in one ``all_reduce`` (the transpose of ``P()`` in-specs).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of ``x``'s shape, concatenated along ``dim`` in rank
    order; no gradient."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The group's elementwise sum (``op`` "sum") or max ("max") of ``x``, out of
    place; no gradient.  A min is minus the max of minus."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    return y


def barrier(device: torch.device, group=None) -> None:
    """Returns once every rank of ``group`` has called it."""
    all_reduce(torch.zeros(1, device=device), group)


def _own(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n).contiguous()


class _GatherLocalGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.group, ctx.dim), None, None


class _GatherSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own(all_reduce(grad, ctx.group), ctx.group, ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ShardSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group, ctx.dim), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([(torch.zeros(shape, dtype=torch.float32, device=dev) if g is None
                           else g.float()).reshape(-1)
                          for g, (shape, _, dev) in zip(grads, ctx.meta)])
        flat = all_reduce(flat, ctx.group)
        out, start = [], 0
        for shape, dtype, _ in ctx.meta:
            n = shape.numel()
            out.append(flat[start:start + n].reshape(shape).to(dtype))
            start += n
        return (None, *out)


def gather_with_local_grad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather`` along ``dim`` whose backward hands each rank the gradient of
    its own slice (``sml_tpu/parallel/collectives.py:gather_with_local_grad``)."""
    return _GatherLocalGrad.apply(x, group, dim)


def gather_sum_grad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather`` along ``dim`` whose backward sums the gradient over the
    group and keeps this rank's slice."""
    return _GatherSumGrad.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the group; the backward sums the gradient too."""
    return _AllReduceSum.apply(x, group)


def shard_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous share of ``x`` along ``dim`` (which the group's size
    divides); the backward gathers the shares' gradients."""
    return _ShardSlice.apply(x, group, dim)


def replicated(group, *xs: torch.Tensor) -> List[torch.Tensor]:
    """``xs`` as they are, for reading inside a sharded body; the backward sums
    their gradients over the group in one ``all_reduce`` (in f32)."""
    return list(_Replicated.apply(group, *xs))


def halo(x: torch.Tensor, group, dim: int, before: int, after: int) -> torch.Tensor:
    """``x`` with ``before`` rows of the previous rank's shard in front and
    ``after`` rows of the next rank's behind, along ``dim``; zeros past the
    first and the last rank (the sequence's edges).  One ``all_gather`` of
    every rank's edge rows; its backward sums over the group."""
    n, size, rank = x.shape[dim], group_size(group), group_rank(group)
    edges = torch.cat([x.narrow(dim, 0, after), x.narrow(dim, n - before, before)], dim)
    blocks = gather_sum_grad(edges, group, dim).split(after + before, dim)
    shape = list(x.shape)
    shape[dim] = before
    left = (blocks[rank - 1].narrow(dim, after, before) if rank > 0
            else x.new_zeros(shape))
    shape[dim] = after
    right = (blocks[rank + 1].narrow(dim, 0, after) if rank < size - 1
             else x.new_zeros(shape))
    return torch.cat([left, x, right], dim)


def replicate_from_first(tensors: Sequence[torch.Tensor], device: torch.device,
                         group=None) -> None:
    """Overwrite ``tensors`` in place with the first rank's, bit for bit (a
    broadcast: one ``all_gather`` on ``device`` per dtype, each rank keeping
    slot 0)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
        first = all_gather(flat, group)[:flat.numel()]
        start = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(first[start:start + t.numel()].view_as(t))
                start += t.numel()


def replicas_equal(tensors: Sequence[torch.Tensor], device: torch.device,
                   group=None) -> bool:
    """Whether every rank holds the same bits in ``tensors`` (their bytes, one
    ``all_gather`` on ``device``)."""
    words = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8).to(device)
                       for t in tensors])
    every = all_gather(words[None], group)
    return bool((every == every[:1]).all())


def fold_seed(seed: int, index: int) -> int:
    """A seed of stream ``index`` from ``seed``: the seed itself at index 0 (a
    lone process keeps its streams), another 62-bit seed for every other index
    (``jax.random.fold_in``'s role)."""
    if not index:
        return seed
    return (seed * 6364136223846793005 + index * 1442695040888963407 + 1) % (2 ** 62)
