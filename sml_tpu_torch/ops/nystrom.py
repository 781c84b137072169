"""Mask-aware Nystrom self-attention of TransMIL's TransLayers (counterpart of
``sml_tpu/ops/nystrom.py:NystromAttention``, single device).

m landmark queries and keys are segment means of q and k (masked means with a
mask), the landmark kernel softmax(q_l k_l^T) goes through the f32
Newton-Schulz pseudo-inverse, and the two N-sized softmax chains attn1 =
softmax(q k_l^T) and attn3 = softmax(q_l k^T) make the output; a 33-tap
depthwise convolution over the values, one filter per head, adds a residual.

Where the JAX module's fused route applies (``_fused_chains_supported``'s
shape rules: ``n_pad % 8``, ``m % 8``, ``n_pad >= 4 m``, ``dh * itemsize >=
128``; and no mask, or an interval mask: ``pallas_masked``), the two chains
go through the bias-less attention kernels (``ops/kernels/deform_attn.py``)
as ``attn1 @ (pinv @ (attn3 @ v))``: the (b, h, n, m) probabilities never
reach device memory in either direction.  A mask becomes two per-bag spans
(``landmark_spans``).  Otherwise the module takes the XLA formulation
``(attn1 @ pinv) @ (attn3 @ v)``.  ``return_attn`` also returns the (b, h,
n_pad, n_pad) attention ``attn1 @ pinv @ attn3``, which needs the
probabilities formed, so it takes the XLA formulation whatever the shape, on
the card too: the JAX module's own routing (``not return_attn`` in its gate),
not a fallback.  The JAX gate's VMEM-fit test belongs to
the TPU and is left out.  The gate admits dh = 64 (TransMIL, f32 and bf16)
and dh = 32 in f32 only (CMTA's 256-wide layers); the CUDA kernels take both,
dh = 32 in its f32 form without bias, span or dropout, and raise on any other
dh.

The masked softmaxes of the landmark kernel and of the XLA chains fill in
f32: in bf16, -f32max rounds to -inf and a fully masked landmark row is NaN
(as in the JAX module at bf16); in f32 the two agree exactly.

``seq`` (a ``parallel.mesh.Grid`` with more than one seq rank, set by the
model factory) splits the token rows over the seq group
(``parallel/seq_parallel.py``); ``return_attn`` is refused there, as the JAX
module asserts.  ``data_group`` (more than one data rank) takes the pinv's
scale over the global batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sml_tpu_torch.ops.common import Dense, DropoutRNG, dropout
from sml_tpu_torch.ops.kernels.deform_attn import NEG_MAX, deform_attention_trainable
from sml_tpu_torch.ops.linear_algebra import moore_penrose_pinv


def fused_chains_supported(n_pad: int, m: int, dh: int, dtype: torch.dtype) -> bool:
    """The shape rules of the JAX gate ``_fused_chains_supported``: both chains
    fused for (n_pad tokens, m landmarks, head dim dh) in ``dtype``."""
    itemsize = torch.finfo(dtype).bits // 8
    return not (n_pad % 8 or m % 8) and n_pad >= 4 * m and dh * itemsize >= 128


def landmark_spans(mask: torch.Tensor, seg: int, heads: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(span3, span1), each (b * heads, 4) int32, of an interval token mask
    (b, n_pad): token interval [tok_start, tok_end) and landmark interval
    [tok_start // seg, ceil(tok_end / seg)) (a segment holds a valid token
    iff it meets the token interval).  span3 = landmark rows x token columns
    (chain 3), span1 = token rows x landmark columns (chain 1); the head index
    is minor in bg."""
    tok_start = mask.to(torch.int32).argmax(dim=1)
    tok_end = tok_start + mask.sum(dim=1, dtype=torch.int32)
    lm_start = tok_start // seg
    lm_end = -(-tok_end // seg)
    span3 = torch.stack([lm_start, lm_end, tok_start, tok_end], dim=1)
    span1 = torch.stack([tok_start, tok_end, lm_start, lm_end], dim=1)
    return (span3.to(torch.int32).repeat_interleave(heads, dim=0).contiguous(),
            span1.to(torch.int32).repeat_interleave(heads, dim=0).contiguous())


def _softmax(sim: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis; with ``valid``, invalid entries take -f32max
    in f32 first (see the module note)."""
    if valid is None:
        return torch.softmax(sim, dim=-1)
    return torch.softmax(torch.where(valid, sim.float(), NEG_MAX), dim=-1).to(sim.dtype)


class NystromAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 num_landmarks: int = 256, pinv_iterations: int = 6,
                 residual: bool = True, residual_conv_kernel: int = 33,
                 eps: float = 1e-8, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.seq = self.data_group = None
        inner = heads * dim_head
        self.dim_head, self.heads, self.num_landmarks = dim_head, heads, num_landmarks
        self.pinv_iterations, self.eps, self.dropout = pinv_iterations, eps, dropout
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.res_conv_kernel = (nn.Parameter(torch.empty(residual_conv_kernel, heads))
                                if residual else None)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def init_raw_params(self, generator: torch.Generator) -> None:
        """``res_conv_kernel``: JAX's variance_scaling(1/3, fan_in, uniform) with
        fan_in = the 33 taps."""
        if self.res_conv_kernel is not None:
            bound = 1.0 / math.sqrt(self.res_conv_kernel.shape[0])
            with torch.no_grad():
                self.res_conv_kernel.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, interval_mask: bool = True,
                return_attn: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x (b, n, dim); mask (b, n) bool or None; ``rng`` feeds the output
        dropout in training mode.  ``interval_mask`` (the JAX module's
        ``pallas_masked``) says the mask is an interval per bag, so the fused
        route may take it; other masks keep the XLA formulation.  With
        ``return_attn``: (out, attn), attn (b, h, n_pad, n_pad)."""
        b, n, _ = x.shape
        h, m, dh = self.heads, self.num_landmarks, self.dim_head
        padding = (m - n % m) % m                  # at the front, like the reference
        if padding:
            x = F.pad(x, (0, 0, padding, 0))
            if mask is not None:
                mask = torch.cat([mask.new_zeros(b, padding), mask], dim=1)
        n_pad = n + padding
        seg = n_pad // m
        if self.seq is not None:
            if return_attn:
                raise ValueError("return_attn is not supported under sequence parallelism")
            from sml_tpu_torch.parallel.seq_parallel import seq_parallel_nystrom

            out = seq_parallel_nystrom(self, x, mask, interval_mask)
            out = dropout(out, self.dropout, self.training, rng.device if rng else None)
            return out[:, -n:]

        q, k, v_flat = self.to_qkv(x).chunk(3, dim=-1)
        if mask is not None:
            v_flat = v_flat * mask[:, :, None].to(v_flat.dtype)

        def split_heads(t):
            return t.reshape(b, n_pad, h, dh).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v_flat)
        if mask is not None:
            m_ = mask[:, None, :, None].to(q.dtype)
            q, k = q * m_, k * m_
        q = q * (dh ** -0.5)

        q_l = q.reshape(b, h, m, seg, dh).sum(dim=3)
        k_l = k.reshape(b, h, m, seg, dh).sum(dim=3)
        if mask is not None:
            lm_sum = mask.reshape(b, m, seg).sum(dim=-1)                   # (b, m)
            divisor = lm_sum[:, None, :, None].to(q.dtype) + self.eps
            ml = (lm_sum > 0)[:, None, :, None]                            # (b, 1, m, 1)
            mlT = ml.transpose(-1, -2)
        else:
            divisor = seg
        q_l, k_l = q_l / divisor, k_l / divisor

        sim2 = torch.einsum("bhid,bhjd->bhij", q_l, k_l)
        attn2 = _softmax(sim2, None if mask is None else ml & mlT)
        attn2_inv = moore_penrose_pinv(attn2, self.pinv_iterations, self.data_group)

        if (not return_attn and (mask is None or interval_mask)
                and fused_chains_supported(n_pad, m, dh, q.dtype)):
            bg = b * h
            span3 = span1 = None
            if mask is not None:
                span3, span1 = landmark_spans(mask, seg, h)
            x3 = deform_attention_trainable(                  # softmax(q_l k^T) v
                q_l.reshape(bg, m, dh).contiguous(), k.reshape(bg, n_pad, dh).contiguous(),
                v.reshape(bg, n_pad, dh).contiguous(), span=span3)
            z = attn2_inv @ x3.reshape(b, h, m, dh).to(attn2_inv.dtype)
            out = deform_attention_trainable(                 # softmax(q k_l^T) z
                q.reshape(bg, n_pad, dh).contiguous(), k_l.reshape(bg, m, dh).contiguous(),
                z.reshape(bg, m, dh).to(q.dtype).contiguous(), span=span1)
            out = out.reshape(b, h, n_pad, dh)
        else:
            sim1 = torch.einsum("bhid,bhjd->bhij", q, k_l)                 # (b, h, n, m)
            sim3 = torch.einsum("bhid,bhjd->bhij", q_l, k)                 # (b, h, m, n)
            valid1 = valid3 = None
            if mask is not None:
                valid1 = mask[:, None, :, None] & mlT
                valid3 = ml & mask[:, None, None, :]
            attn1, attn3 = _softmax(sim1, valid1), _softmax(sim3, valid3)
            attn12 = attn1 @ attn2_inv
            out = attn12 @ (attn3 @ v)
        out = out.transpose(1, 2).reshape(b, n_pad, h * dh)

        if self.res_conv_kernel is not None:
            # one 33-tap filter per head, replicated over its dh channels, as one
            # depthwise convolution over the merged-head values
            taps = self.res_conv_kernel.shape[0]
            weight = self.res_conv_kernel.repeat_interleave(dh, dim=1).T[:, None, :]
            res = F.conv1d(v_flat.to(out.dtype).transpose(1, 2), weight.to(out.dtype),
                           padding=taps // 2, groups=h * dh)
            out = out + res.transpose(1, 2)
        out = self.to_out(out)
        out = dropout(out, self.dropout, self.training, rng.device if rng else None)
        if return_attn:
            return out[:, -n:], attn12 @ attn3
        return out[:, -n:]
