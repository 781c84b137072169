"""MaxNet: self-normalizing genomic encoder (counterpart of ``sml_tpu/models/maxnet.py``).

4x [Dense -> ELU -> AlphaDropout] with widths (64, 48, 32, omic_dim), ReLU on
the encoded features, and a linear classifier head.  ``init_max`` draws the
kernels from ``max_kernel_init`` (N(0, 1/fan_in), truncated), else from
``torch_kernel_init``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from sml_tpu_torch.ops.common import Dense
from sml_tpu_torch.ops.snn import AlphaDropout

_HIDDEN = (64, 48, 32)


class MaxNet(nn.Module):
    def __init__(self, input_dim: int = 59, omic_dim: int = 32,
                 dropout_rate: float = 0.25, label_dim: int = 1,
                 init_max: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        init = "max" if init_max else "torch"
        widths = [input_dim, *_HIDDEN, omic_dim]
        for i in range(4):
            self.add_module(f"encoder{i + 1}",
                            Dense(widths[i], widths[i + 1], dtype=dtype, kernel_init=init))
        self.dropout = AlphaDropout(dropout_rate)
        self.classifier = Dense(omic_dim, label_dim, dtype=dtype, kernel_init=init)

    def forward(self, x_omic: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = x_omic
        for i in range(4):
            h = self.dropout(F.elu(getattr(self, f"encoder{i + 1}")(h)))
        features = torch.relu(h)
        return {"features": features, "logits": self.classifier(features)}
