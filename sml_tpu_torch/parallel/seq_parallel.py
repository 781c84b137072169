"""Sequence-parallel masked Nystrom attention over a seq group (counterpart of
``sml_tpu/parallel/seq_parallel.py``).

Every rank of the group holds the whole (front-padded) token sequence of the
same batch; each computes the attention for its contiguous share of the
token rows and the output is gathered back, so the layers around the
attention run replicated.  Landmark segments are aligned to the shards
(n_pad / seq rows each, m / seq landmarks each):

* local landmark sums, then the (b, h, m, dh) landmarks and their validity
  gathered (a few KB);
* the landmark kernel and its Newton-Schulz pinv on every rank alike;
* chain 3, softmax(q_l k^T) over the whole token axis: a MAX all-reduce of
  the row maxima (not differentiated) and a SUM all-reduce of the exponent
  sums, then ``attn3 @ v`` summed over the group;
* chain 1, softmax(q k_l^T) @ (pinv @ attn3 v), local to each rank: through
  the bias-less attention kernels (#3 / #4; with a mask the span form, its
  rows cut to this rank's token interval) wherever the single-device module
  would fuse its chains, else in plain products; chain 3 stays plain, as a
  self-contained kernel cannot take its normaliser over ranks;
* the 33-tap residual convolution over the values with a halo of 16 tokens
  from each neighbour.

Weights are read through ``replicated`` (their gradients summed over the
group), the input sliced through ``shard_slice`` and the output gathered
through ``gather_with_local_grad``, so every rank ends the backward with the
full gradients.  The parameters are the module's own: checkpoints are those of
the single-device module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sml_tpu_torch.ops.kernels.deform_attn import NEG_MAX, deform_attention_trainable
from sml_tpu_torch.ops.linear_algebra import moore_penrose_pinv
from sml_tpu_torch.parallel import collectives as C


def _local_span(mask_l: torch.Tensor, off: int, n_l: int, seg: int, heads: int,
                group) -> torch.Tensor:
    """(b * heads, 4) int32 span of chain 1 on this rank: the bag's global token
    interval (an interval mask, as in ``ops/nystrom.py:landmark_spans``) cut to
    this rank's rows, and its landmark interval."""
    valid = mask_l.any(dim=1)
    first = off + mask_l.to(torch.int32).argmax(dim=1)
    end = first + mask_l.sum(dim=1, dtype=torch.int32)
    big = float(2 ** 30)
    bounds = torch.stack([torch.where(valid, -first.float(), -big),
                          torch.where(valid, end.float(), -1.0)], dim=1)
    bounds = C.all_reduce(bounds, group, "max")             # -min(start), max(end)
    tok_end = bounds[:, 1].clamp_min(0).to(torch.int32)
    tok_start = torch.where(tok_end > 0, (-bounds[:, 0]).to(torch.int32), 0)
    span = torch.stack([(tok_start - off).clamp(0, n_l), (tok_end - off).clamp(0, n_l),
                        tok_start // seg, -(-tok_end // seg)], dim=1)
    return span.to(torch.int32).repeat_interleave(heads, dim=0).contiguous()


def seq_parallel_nystrom(attn, x: torch.Tensor, mask: Optional[torch.Tensor],
                         interval_mask: bool = True) -> torch.Tensor:
    """The output of ``attn`` (an ``ops.nystrom.NystromAttention`` whose ``seq``
    grid holds the group) before its dropout: x (b, n_pad, dim) and mask (b,
    n_pad) are the front-padded inputs, alike on every rank; so is the
    returned (b, n_pad, dim)."""
    from sml_tpu_torch.ops.nystrom import _softmax, fused_chains_supported

    grid = attn.seq
    group, size, idx = grid.seq_group, grid.seq, grid.seq_index
    b, n_pad, _ = x.shape
    h, m, dh = attn.heads, attn.num_landmarks, attn.dim_head
    if m % size:
        raise ValueError(f"the {m} landmarks must divide across the {size} seq ranks")
    n_l, seg, m_l = n_pad // size, n_pad // m, m // size
    cdt = attn.to_qkv.compute_dtype
    weights = [attn.to_qkv.weight, attn.to_out.weight, attn.to_out.bias]
    if attn.res_conv_kernel is not None:
        weights.append(attn.res_conv_kernel)
    w_qkv, w_out, b_out, *res_kernel = C.replicated(group, *weights)

    x_l = C.shard_slice(x, group, 1)
    mask_l = None if mask is None else mask[:, idx * n_l:(idx + 1) * n_l]
    q, k, v_flat = F.linear(x_l.to(cdt), w_qkv.to(cdt)).chunk(3, dim=-1)
    if mask_l is not None:
        v_flat = v_flat * mask_l[:, :, None].to(v_flat.dtype)

    def split_heads(t):
        return t.reshape(b, n_l, h, dh).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v_flat)
    if mask_l is not None:
        m_ = mask_l[:, None, :, None].to(q.dtype)
        q, k = q * m_, k * m_
    q = q * (dh ** -0.5)

    q_l = q.reshape(b, h, m_l, seg, dh).sum(dim=3)
    k_l = k.reshape(b, h, m_l, seg, dh).sum(dim=3)
    ml = mlT = None
    if mask_l is not None:
        lm_sum = mask_l.reshape(b, m_l, seg).sum(dim=-1)
        divisor = lm_sum[:, None, :, None].to(q.dtype) + attn.eps
        lm_valid = C.all_gather(lm_sum.to(torch.int32), group, dim=1) > 0   # (b, m)
        ml = lm_valid[:, None, :, None]
        mlT = ml.transpose(-1, -2)
    else:
        divisor = seg
    landmarks = C.gather_sum_grad(torch.cat([q_l / divisor, k_l / divisor], dim=-1),
                                  group, dim=2)                        # (b, h, m, 2 dh)
    q_l, k_l = landmarks[..., :dh], landmarks[..., dh:]

    sim2 = torch.einsum("bhid,bhjd->bhij", q_l, k_l)
    attn2 = _softmax(sim2, None if ml is None else ml & mlT)
    attn2_inv = moore_penrose_pinv(attn2, attn.pinv_iterations, attn.data_group)

    # chain 3: the softmax normalises over every rank's tokens
    sim3 = torch.einsum("bhid,bhjd->bhij", q_l, k).float()             # (b, h, m, n_l)
    if mask_l is not None:
        sim3 = torch.where(ml & mask_l[:, None, None, :], sim3, NEG_MAX)
    row_max = C.all_reduce(sim3.detach().amax(dim=-1, keepdim=True), group, "max")
    e3 = torch.exp(sim3 - row_max)
    attn3 = (e3 / C.all_reduce_sum(e3.sum(dim=-1, keepdim=True), group)).to(q.dtype)
    a3v = C.all_reduce_sum(attn3 @ v, group)                           # (b, h, m, dh)

    if ((mask is None or interval_mask)
            and fused_chains_supported(n_pad, m, dh, q.dtype)):
        span1 = (None if mask_l is None
                 else _local_span(mask_l, idx * n_l, n_l, seg, h, group))
        z = attn2_inv @ a3v.to(attn2_inv.dtype)
        out = deform_attention_trainable(
            q.reshape(b * h, n_l, dh).contiguous(), k_l.reshape(b * h, m, dh).contiguous(),
            z.reshape(b * h, m, dh).to(q.dtype).contiguous(), span=span1)
        out = out.reshape(b, h, n_l, dh)
    else:
        sim1 = torch.einsum("bhid,bhjd->bhij", q, k_l)                 # (b, h, n_l, m)
        valid1 = None if mask_l is None else mask_l[:, None, :, None] & mlT
        out = (_softmax(sim1, valid1) @ attn2_inv) @ a3v
    out = out.transpose(1, 2).reshape(b, n_l, h * dh)

    if res_kernel:
        taps = res_kernel[0].shape[0]
        if n_l < taps // 2:
            raise ValueError(f"a shard's {n_l} tokens must cover the conv halo {taps // 2} "
                             "(fewer seq ranks or longer sequences)")
        v_halo = C.halo(v_flat, group, 1, taps // 2, taps // 2)
        weight = res_kernel[0].repeat_interleave(dh, dim=1).T[:, None, :]
        res = F.conv1d(v_halo.to(out.dtype).transpose(1, 2), weight.to(out.dtype),
                       groups=h * dh)
        out = out + res.transpose(1, 2)
    out = F.linear(out.to(cdt), w_out.to(cdt), b_out.to(cdt))
    return C.gather_with_local_grad(out, group, dim=1)
