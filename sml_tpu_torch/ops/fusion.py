"""Per-token concat fusion (counterpart of ``sml_tpu/ops/fusion.py:FusionNet``).

The second stream is one omic vector per sample, broadcast to every token, so
the concat product splits exactly: ``[x1, x2] @ W == x1 @ W[:d1] + (x2 @ W[d1:]
+ b)``, the second term one row per sample instead of N identical token rows.
The parameter is the single ``fusion_layer`` kernel of the flax tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sml_tpu_torch.ops.common import Dense


class FusionNet(nn.Module):
    def __init__(self, gene_dim: int, image_dim: int, feature_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gene_dim = gene_dim
        self.fusion_layer = Dense(gene_dim + image_dim, feature_dim, dtype=dtype)

    def forward(self, gene_features: torch.Tensor,
                image_features: torch.Tensor) -> torch.Tensor:
        """gene_features (B, N, d1) tokens; image_features (B, d2) per sample."""
        layer = self.fusion_layer
        cdt = layer.compute_dtype
        w = layer.weight.to(cdt)                                  # (out, d1 + d2)
        d1 = self.gene_dim
        tok = F.linear(gene_features.to(cdt), w[:, :d1])
        per_sample = F.linear(image_features.to(cdt), w[:, d1:], layer.bias.to(cdt))
        return tok + per_sample[:, None, :]
