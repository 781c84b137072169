"""MIL models over pre-extracted patch-feature bags (counterpart of
``sml_tpu/models/mil.py``: ``ABMIL``, ``GatedABMIL``, ``TransLayer``,
``TransMIL``).

ABMIL: a two-layer tanh attention scorer over the patches (masked patches
take -inf before the softmax), the softmax-weighted bag sum, then the
classifier (logits) and the multimodal projection (features).  GatedABMIL
scores with tanh(V x) * sigmoid(U x); no mode of either package uses it.

TransMIL:
fc1 (input -> 512) + ReLU, square-pad the bag by wrapping its first tokens,
prepend the cls token, two pre-norm Nystrom TransLayers (8 heads of 64, 256
landmarks, 6 pinv iterations) with the PPEG positional convolutions between
them, then LayerNorm of the cls token -> fc2 (logits) and the multimodal
projection (features).  Submodules carry the flax tree's names, so the weight
bridge maps leaf by leaf.  Neither ABMIL form runs a kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from sml_tpu_torch.ops.common import Dense, DropoutRNG
from sml_tpu_torch.ops.conv import PPEG
from sml_tpu_torch.ops.nystrom import NystromAttention


class ABMIL(nn.Module):
    def __init__(self, label_dim: int = 4, path_dim: int = 128,
                 input_path_dim: int = 1024, attn_hidden: int = 128,
                 n_attn_heads: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention_0 = Dense(input_path_dim, attn_hidden, dtype=dtype)
        self.attention_1 = Dense(attn_hidden, n_attn_heads, dtype=dtype)
        self.classifier = Dense(n_attn_heads * input_path_dim, label_dim, dtype=dtype)
        self.multimodal_projection = Dense(n_attn_heads * input_path_dim, path_dim,
                                           dtype=dtype)

    def forward(self, x_path: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """x_path (B, N, L); mask (B, N) marks real patches.  ``rng`` is
        unused (ABMIL has no dropout)."""
        b = x_path.shape[0]
        a = self.attention_1(torch.tanh(self.attention_0(x_path))).transpose(1, 2)
        if mask is not None:             # padded patches get zero attention
            a = a.masked_fill(~mask.bool()[:, None, :], float("-inf"))
        a = torch.softmax(a, dim=-1)                               # (B, K, N)
        m = (a @ x_path.to(a.dtype)).reshape(b, -1)                # (B, K*L)
        return {"features": self.multimodal_projection(m), "logits": self.classifier(m),
                "attention": a}


class GatedABMIL(nn.Module):
    def __init__(self, label_dim: int = 2, input_path_dim: int = 1024,
                 attn_hidden: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention_V = Dense(input_path_dim, attn_hidden, dtype=dtype)
        self.attention_U = Dense(input_path_dim, attn_hidden, dtype=dtype)
        self.attention_weights = Dense(attn_hidden, 1, dtype=dtype)
        self.classifier = Dense(input_path_dim, label_dim, dtype=dtype)

    def forward(self, x_path: torch.Tensor) -> Dict[str, torch.Tensor]:
        a = self.attention_weights(torch.tanh(self.attention_V(x_path))
                                   * torch.sigmoid(self.attention_U(x_path)))
        a = torch.softmax(a.transpose(1, 2), dim=-1)               # (B, 1, N)
        m = (a @ x_path.to(a.dtype)).reshape(x_path.shape[0], -1)
        logits = self.classifier(m)
        return {"logits": logits, "probs": torch.sigmoid(logits), "attention": a}


class TransLayer(nn.Module):
    """x + NystromAttention(LayerNorm(x)); the attention's output dropout is
    0.1, as in the JAX module."""

    def __init__(self, dim: int = 512, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = NystromAttention(dim, dim_head=dim // 8, heads=8,
                                     num_landmarks=dim // 2, pinv_iterations=6,
                                     residual=True, dropout=dropout, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, interval_mask: bool = True
                ) -> torch.Tensor:
        # flax LayerNorm with f32 params: statistics and output in f32
        return x + self.attn(self.norm(x.float()), mask=mask, rng=rng,
                             interval_mask=interval_mask)


class TransMIL(nn.Module):
    def __init__(self, label_dim: int = 4, path_dim: int = 128,
                 input_path_dim: int = 1024, hidden_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fc1 = Dense(input_path_dim, hidden_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden_dim))
        self.layer1 = TransLayer(hidden_dim, dtype=dtype)
        self.pos_layer = PPEG(hidden_dim, dtype=dtype)
        self.layer2 = TransLayer(hidden_dim, dtype=dtype)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.fc2 = Dense(hidden_dim, label_dim, dtype=dtype)
        self.multimodal_projection = Dense(hidden_dim, path_dim, dtype=dtype)

    def init_raw_params(self, generator: torch.Generator) -> None:
        """``cls_token``: flax's normal(1.0)."""
        with torch.no_grad():
            self.cls_token.normal_(0.0, 1.0, generator=generator)

    def forward(self, x_path: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """x_path (B, N, input_path_dim); mask (B, N) bool marks real patches."""
        b, n, _ = x_path.shape
        h = torch.relu(self.fc1(x_path))
        side = int(math.ceil(math.sqrt(n)))
        add_length = side * side - n
        if add_length:
            h = torch.cat([h, h[:, :add_length]], dim=1)
            if mask is not None:
                mask = torch.cat([mask, mask[:, :add_length]], dim=1)
        h = torch.cat([self.cls_token.expand(b, 1, -1).to(h.dtype), h], dim=1)
        if mask is not None:                   # the cls token always attends
            mask = torch.cat([mask.new_ones(b, 1), mask.bool()], dim=1)

        # the wrap-pad repeats valid tokens, so a padded mask is no interval:
        # its chains keep the XLA formulation (square buckets stay fused)
        masked_ok = add_length == 0
        h = self.layer1(h, mask=mask, rng=rng, interval_mask=masked_ok)
        h = self.pos_layer(h, side, side)
        h = self.layer2(h, mask=mask, rng=rng, interval_mask=masked_ok)
        h = self.norm(h.float())[:, 0]
        return {"features": self.multimodal_projection(h), "logits": self.fc2(h)}
