"""Sequence-parallel 2-D deformable cross-attention over a seq group
(counterpart of ``sml_tpu/parallel/seq_deform.py``).

Every rank of the group holds both streams of the same batch; each computes
the attention of its contiguous block of query-grid rows (h / seq rows, whole
kv rows of the stride-4 offset grid), and the output and the vgrid are
gathered back, so the layers around the attention run replicated:

* the offset convolution (kernel 6, stride 4, padding 1) takes one query row
  of halo from each neighbour, after which each rank holds exactly its own
  kv rows' offsets;
* each rank samples its kv rows from the full path stream (which it holds:
  a replicated read), projects them, and the keys, values and sampled grid
  are gathered (J = N / 16 points);
* the position bias of the local query rows only, through the CPB kernels
  (#1 / #2: the MLP is separable in y, so ``CPB2D.factors`` takes the local
  rows' coordinates), and the attention of the local row block through #3 /
  #4 with the bias and, in training, Philox dropout whose seed is folded with
  the seq index (valid dropout, not the one-rank stream);
* ``to_out`` is row-local.

Weights and the path stream are read through ``replicated``, the query
stream sliced through ``shard_slice``, the output and the vgrid gathered
through ``gather_with_local_grad``: every rank ends the backward with the
full gradients.  The parameters are the module's own, so checkpoints are
those of the single-device module.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.ops.deformable import (_flat_heads, _group, _masked, _unflat_heads,
                                          _ungroup, make_grid_2d, normalize_grid_2d,
                                          normalized_axis)
from sml_tpu_torch.ops.grid_sample import grid_sample_2d
from sml_tpu_torch.ops.kernels.cpb_bias import cpb_bias_trainable
from sml_tpu_torch.ops.kernels.deform_attn import deform_attention_trainable
from sml_tpu_torch.parallel import collectives as C


def _conv(module, weight, bias, x: torch.Tensor, padding=None) -> torch.Tensor:
    """``module`` (an ``ops.common.Conv``) on channels-last ``x`` with the given
    weight and bias (and ``padding`` in place of its own)."""
    cdt = module.compute_dtype
    y = F.conv2d(x.to(cdt).permute(0, 3, 1, 2), weight.to(cdt),
                 None if bias is None else bias.to(cdt), module.stride,
                 module.padding if padding is None else padding, 1, module.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def seq_parallel_deform_2d(attn, x1: torch.Tensor, x2: torch.Tensor,
                           mask: Optional[torch.Tensor], rng: Optional[DropoutRNG]):
    """(out (B, N, dim), vgrid (B, g, Hd, Wd, 2)) of ``attn`` (an
    ``ops.deformable.DeformCrossAttention2D`` whose ``seq`` grid holds the
    group) on x1, x2 (B, N, C) and mask (B, N), alike on every rank."""
    grid = attn.seq
    group, size, idx = grid.seq_group, grid.seq, grid.seq_index
    b, n, c = x1.shape
    h = w = math.isqrt(n)
    df, pad = attn.offset_conv.stride[0], attn.offset_conv.padding[0]
    if h % size or (h // size) % df:
        raise ValueError(f"the {h}x{w} query grid must split into whole kv rows per "
                         f"shard: side must be a multiple of {df}*{size}")
    h_l = h // size
    n_l = h_l * w
    g, heads, dh = attn.groups, attn.heads, attn.dim_head
    inner = heads * dh
    x1, x2 = _masked(x1, x2, mask)
    cpb = attn.rel_pos_bias
    (w_q, w_off, b_off, w_proj, w_k, w_v, w_out, b_out, *rest) = C.replicated(
        group, attn.to_q.weight, attn.offset_conv.weight, attn.offset_conv.bias,
        attn.offset_proj.weight, attn.to_k.weight, attn.to_v.weight, attn.to_out.weight,
        attn.to_out.bias, *cpb.raw(), x2)
    cpb_raw, x2 = rest[:-1], rest[-1]

    x1_l = C.shard_slice(x1, group, 1)
    q = _conv(attn.to_q, w_q, None, x1_l.reshape(b, h_l, w, c))  # (B, h_l, W, inner)
    gq = C.halo(_group(q, g), group, 1, pad, pad)                # the offset conv's halo
    off = _conv(attn.offset_conv, w_off, b_off, gq, padding=(0, pad))
    off = _conv(attn.offset_proj, w_proj, None, F.gelu(off, approximate="none"))
    offsets = torch.tanh(off) * attn.offset_scale                # (B*g, hd_l, Wd, 2)

    hd_l, wd = offsets.shape[1], offsets.shape[2]
    hd = hd_l * size
    rows = make_grid_2d(hd, wd, offsets.dtype, offsets.device)[idx * hd_l:(idx + 1) * hd_l]
    vgrid_l = rows[None] + offsets
    vgrid_scaled_l = normalize_grid_2d(vgrid_l, hd, wd)          # the global grid's scale
    kv_l = _ungroup(grid_sample_2d(_group(x2.reshape(b, h, w, c), g), vgrid_scaled_l), g)
    kv = C.gather_sum_grad(torch.cat([_conv(attn.to_k, w_k, None, kv_l),
                                      _conv(attn.to_v, w_v, None, kv_l)], dim=-1),
                           group, dim=1)                         # (B, Hd, Wd, 2 inner)
    k, v = kv[..., :inner], kv[..., inner:]
    j = hd * wd
    grid_kv = C.gather_sum_grad(vgrid_scaled_l, group, dim=1).reshape(b * g, j, 2)
    q = q * (dh ** -0.5)

    x_axis = normalized_axis(w, x1.device)
    y_local = normalized_axis(h, x1.device)[idx * h_l:(idx + 1) * h_l]
    bias = cpb_bias_trainable(*cpb.factors(x_axis, y_local, grid_kv, cpb_raw))
    keep_prob, seed = 1.0, 0
    if attn.training and attn.dropout > 0.0:
        if rng is None:
            raise ValueError("training-mode attention dropout needs a DropoutRNG")
        keep_prob, seed = 1.0 - attn.dropout, C.fold_seed(rng.philox_seed(), idx)
    out = deform_attention_trainable(_flat_heads(q, heads, dh), _flat_heads(k, heads, dh),
                                     _flat_heads(v, heads, dh), bias.reshape(b * g, n_l, j),
                                     keep_prob, seed)             # (B*heads, n_l, dh)
    out = _conv(attn.to_out, w_out, b_out, _unflat_heads(out, heads).reshape(b, h_l, w, inner))
    out = C.gather_with_local_grad(out.reshape(b, n_l, attn.dim), group, dim=1)
    vgrid = C.gather_with_local_grad(vgrid_l.reshape(b, g, hd_l, wd, 2), group, dim=2)
    return out, vgrid
