"""Pyramid positional encoding (PPEG) of TransMIL (counterpart of
``sml_tpu/ops/conv.py``).

The token sequence minus the cls token is laid out as an H x W map and run
through three parallel depthwise convolutions (7, 5, 3); their sum plus the
identity replaces the tokens, and the cls token passes through untouched.
Channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from sml_tpu_torch.ops.common import Conv


class PPEG(nn.Module):
    """Pyramid positional encoding over (B, 1 + H*W, C) token sequences."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        for name, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
            self.add_module(name, Conv(dim, dim, k, padding=k // 2, groups=dim,
                                       dtype=dtype))

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        cls_token, img = x[:, :1], x[:, 1:].reshape(b, h, w, c)
        out = self.proj(img) + img + self.proj1(img) + self.proj2(img)
        return torch.cat([cls_token.to(out.dtype), out.reshape(b, h * w, c)], dim=1)
