"""Iterative Moore-Penrose pseudo-inverse (Newton-Schulz) of the Nystrom landmark
kernel (counterpart of ``sml_tpu/ops/linear_algebra.py``).

The iteration runs in float32 whatever the input dtype (bf16 products compound
their error across the polynomial), and the initial guess is scaled by
``max(col_sums) * max(row_sums)`` taken over the whole batch of matrices, not
per matrix, as the JAX package and its reference do.  Under several data
ranks the batch is the global one: the two maxima are taken over the data
group (``_GlobalMax``), as jit takes them over the global batch.
"""

from __future__ import annotations

import torch


class _GlobalMax(torch.autograd.Function):
    """``t.max()`` over every rank of ``group``; the gradient, summed over the
    group, split evenly among the elements of every rank that equal the
    maximum, as ``max``'s own gradient splits it among ties."""

    @staticmethod
    def forward(ctx, t, group):
        from sml_tpu_torch.parallel.collectives import all_reduce

        top = all_reduce(t.max(), group, "max")
        ties = t == top
        ctx.group = group
        ctx.save_for_backward(ties, all_reduce(ties.sum().to(t.dtype), group))
        return top

    @staticmethod
    def backward(ctx, grad):
        from sml_tpu_torch.parallel.collectives import all_reduce

        ties, count = ctx.saved_tensors
        return all_reduce(grad, ctx.group) * ties / count, None


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6, group=None) -> torch.Tensor:
    """Approximate pinv of a batch of square matrices ``x`` (..., m, m), in
    ``x``'s dtype; with ``group``, the batch spans that group's ranks."""
    orig_dtype = x.dtype
    x = x.float()
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    if group is None:
        z = x.transpose(-1, -2) / (col.max() * row.max())
    else:
        z = x.transpose(-1, -2) / (_GlobalMax.apply(col, group) * _GlobalMax.apply(row, group))
    eye = torch.eye(x.shape[-1], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13.0 * eye - (xz @ (15.0 * eye - (xz @ (7.0 * eye - xz)))))
    return z.to(orig_dtype)
