"""Attention pooling heads (counterpart of ``sml_tpu/ops/pooling.py``): the
gated scorer ``AttnNetGated`` of MCAT, tanh(a x) * sigmoid(b x) -> c, and the
mean-pooler ``Pooler``, masked mean over tokens -> Dense -> tanh."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sml_tpu_torch.ops.common import Dense, Dropout


class AttnNetGated(nn.Module):
    """Returns ``(scores, x)``: scores (..., 1) raw (the caller takes the
    softmax); a and b each take their own dropout draw (rate 0.25, MCAT's)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention_a = Dense(dim, dim, dtype=dtype)
        self.attention_b = Dense(dim, dim, dtype=dtype)
        self.attention_c = Dense(dim, 1, dtype=dtype)
        self.drop = Dropout(0.25)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.drop(torch.tanh(self.attention_a(x)), generator)
        b = self.drop(torch.sigmoid(self.attention_b(x)), generator)
        return self.attention_c(a * b), x


class Pooler(nn.Module):
    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden_states (B, N, C); mask (B, N) restricts the mean to valid tokens."""
        if mask is None:
            avg = hidden_states.mean(dim=1)
        else:
            m = mask.to(hidden_states.dtype)[..., None]
            avg = (hidden_states * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        return torch.tanh(self.dense(avg))
