"""Bilinear grid sampling on channels-last tensors (counterpart of
``sml_tpu/ops/grid_sample.py:grid_sample_2d``).

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
