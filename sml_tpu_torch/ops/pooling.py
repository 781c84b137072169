"""Mean-pooler head (counterpart of ``sml_tpu/ops/pooling.py:Pooler``): masked mean
over tokens -> Dense -> tanh."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sml_tpu_torch.ops.common import Dense


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
