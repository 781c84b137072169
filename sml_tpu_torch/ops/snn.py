"""Self-normalizing primitives (counterpart of ``sml_tpu/ops/snn.py``):
AlphaDropout with torch-exact constants, and the SNN blocks of the MCAT and
CMTA signature networks.

Dropped units take -lambda*alpha (the SELU saturation value) and the result is
affinely rescaled to keep zero mean / unit variance.  Eval is the identity; the
training form draws from an explicit ``torch.Generator`` for the training slice.
``SNNBlock`` is Dense -> ELU -> AlphaDropout; ``SNNStack`` chains them, its
blocks named ``SNNBlock_{i}`` and each block's layer ``Dense_0``, as flax
auto-names them, so the weight bridge maps them unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sml_tpu_torch.ops.common import Dense

# -lambda * alpha of SELU: the value saturated (dropped) units take.
_ALPHA_PRIME = -1.7580993408473766
# the AlphaDropout rate of every SNN block (MCAT's and CMTA's signature nets)
SNN_DROPOUT = 0.25


def alpha_dropout(x: torch.Tensor, rate: float, training: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Functional AlphaDropout; identity at eval or when rate == 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode AlphaDropout needs an explicit generator")
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


class SNNBlock(nn.Module):
    """Linear -> ELU -> AlphaDropout."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, dtype=dtype)
        self.AlphaDropout_0 = AlphaDropout(SNN_DROPOUT)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.AlphaDropout_0(F.elu(self.Dense_0(x)), generator)


class SNNStack(nn.Module):
    """SNN blocks of widths ``hidden`` over ``in_features`` inputs."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_features, *hidden]
        for i in range(len(hidden)):
            self.add_module(f"SNNBlock_{i}", SNNBlock(widths[i], widths[i + 1], dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.children():
            x = block(x, generator)
        return x
