"""Bilinear and linear grid sampling on channels-last tensors (counterpart of
``sml_tpu/ops/grid_sample.py``: ``grid_sample_2d`` and ``grid_sample_1d``).

``mode='bilinear'``, ``padding_mode='zeros'``, ``align_corners=False``: the
semantics the JAX gather form reproduces from torch, here taken from
``F.grid_sample`` itself (the JAX package leaves this op to XLA, not to a
kernel).  ``grid[..., 0]`` is x (width), ``grid[..., 1]`` is y (height), both
normalized to [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(inp: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``inp`` (N, H, W, C) at ``grid`` (N, Hg, Wg, 2) -> (N, Hg, Wg, C)."""
    out = F.grid_sample(inp.permute(0, 3, 1, 2), grid.to(inp.dtype),
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous()


def grid_sample_1d(inp: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Linear sample ``inp`` (N, L, C) at normalized coordinates ``grid`` (N, P)
    -> (N, P, C) in ``inp``'s dtype; ``align_corners=False``, zeros padding,
    the two taps weighted in f32.

    This samples along the sequence, as the JAX package's ``grid_sample_1d``
    does by a deliberate fix: the reference lifted the 1-D sample into a 2-D
    ``F.grid_sample`` with the coordinate in the x slot of a width-1 image, so
    it returned the sequence's midpoint scaled by the offset."""
    n, length, c = inp.shape
    x = ((grid.float() + 1.0) * length - 1.0) / 2.0             # (N, P)
    x0 = torch.floor(x)
    w1 = x - x0
    ix0 = x0.long()

    def tap(ix):
        valid = (ix >= 0) & (ix < length)
        out = torch.gather(inp, 1, ix.clamp(0, length - 1)[..., None].expand(-1, -1, c))
        return out.float() * valid[..., None]

    return (tap(ix0) * (1.0 - w1)[..., None] + tap(ix0 + 1) * w1[..., None]).to(inp.dtype)
