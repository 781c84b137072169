"""Self-normalizing primitives: AlphaDropout with torch-exact constants (counterpart
of ``sml_tpu/ops/snn.py``).

Dropped units take -lambda*alpha (the SELU saturation value) and the result is
affinely rescaled to keep zero mean / unit variance.  Eval is the identity; the
training form draws from an explicit ``torch.Generator`` for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# -lambda * alpha of SELU: the value saturated (dropped) units take.
_ALPHA_PRIME = -1.7580993408473766


def alpha_dropout(x: torch.Tensor, rate: float, training: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Functional AlphaDropout; identity at eval or when rate == 0."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    a = (keep_prob + _ALPHA_PRIME ** 2 * keep_prob * (1.0 - keep_prob)) ** -0.5
    b = -a * _ALPHA_PRIME * (1.0 - keep_prob)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    dropped = torch.where(u < keep_prob, x, torch.full_like(x, _ALPHA_PRIME))
    return a * dropped + b


class AlphaDropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return alpha_dropout(x, self.rate, self.training, generator)
