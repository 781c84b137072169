"""Iterative Moore-Penrose pseudo-inverse (Newton-Schulz) of the Nystrom landmark
kernel (counterpart of ``sml_tpu/ops/linear_algebra.py``).

The iteration runs in float32 whatever the input dtype (bf16 products compound
their error across the polynomial), and the initial guess is scaled by
``max(col_sums) * max(row_sums)`` taken over the whole batch of matrices, not
per matrix, as the JAX package and its reference do.
"""

from __future__ import annotations

import torch


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Approximate pinv of a batch of square matrices ``x`` (..., m, m), in
    ``x``'s dtype."""
    orig_dtype = x.dtype
    x = x.float()
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    z = x.transpose(-1, -2) / (col.max() * row.max())
    eye = torch.eye(x.shape[-1], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13.0 * eye - (xz @ (15.0 * eye - (xz @ (7.0 * eye - xz)))))
    return z.to(orig_dtype)
