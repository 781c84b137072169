"""Post-norm transformer encoder with torch ``nn.TransformerEncoderLayer``
semantics (counterpart of ``sml_tpu/ops/transformer.py``): x + dropout(self
attention) -> LayerNorm, then x + dropout(linear2(dropout(relu(linear1 x))))
-> LayerNorm; batch-first (B, L, E), layers named ``layer{i}``.  The FFN is
512 wide and every dropout rate 0.25, MCAT's.  The flax LayerNorms keep f32
parameters, so they compute and return f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sml_tpu_torch.ops.attention import RawMultiheadAttention
from sml_tpu_torch.ops.common import Dense, Dropout

FFN_DIM = 512
DROPOUT = 0.25


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = RawMultiheadAttention(d_model, nhead, dropout=DROPOUT, dtype=dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Dense(d_model, FFN_DIM, dtype=dtype)
        self.linear2 = Dense(FFN_DIM, d_model, dtype=dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = Dropout(DROPOUT)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn_out, _ = self.self_attn(x, x, x, generator=generator)
        x = self.norm1((x + self.drop(attn_out, generator)).float())
        y = self.drop(torch.relu(self.linear1(x)), generator)
        y = self.linear2(y)
        return self.norm2((x + self.drop(y, generator)).float())


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(d_model, nhead, dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.children():
            x = layer(x, generator)
        return x
