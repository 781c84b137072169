"""Exact multi-head attention that also returns the raw (pre-softmax) logits
(counterpart of ``sml_tpu/ops/attention.py:RawMultiheadAttention``).

Batch-first: query (B, Lq, E), key / value (B, Lk, E); the logits come back as
(B, H, Lq, Lk) and include the 1/sqrt(head_dim) scaling of the queries.  The
products are plain ``einsum``s, as in the JAX module (no kernel: MCAT's and
CMTA's co-attention has 4 queries or 4 keys).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sml_tpu_torch.ops.common import Dense, Dropout


class RawMultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim, dtype=dtype))
        self.drop = Dropout(dropout)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out (B, Lq, E), raw logits (B, H, Lq, Lk)); ``key_padding_mask``
        (B, Lk) is True where a key is masked out."""
        b, lq, e = query.shape
        lk, h = key.shape[1], self.num_heads
        head_dim = e // h

        def heads(t, length):
            return t.reshape(b, length, h, head_dim).transpose(1, 2)

        q = heads(self.q_proj(query) * head_dim ** -0.5, lq)
        k = heads(self.k_proj(key), lk)
        v = heads(self.v_proj(value), lk)
        raw = torch.einsum("bhid,bhjd->bhij", q, k)
        logits = raw
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        attn = self.drop(torch.softmax(logits, dim=-1), generator)
        out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2).reshape(b, lq, e)
        return self.out_proj(out), raw
