"""Genomic-guided deformable cross-attention, 2-D and 1-D, with a continuous
relative position bias (counterpart of ``sml_tpu/ops/deformable.py``:
``CPB2D``, ``DeformCrossAttention2D``, ``CPB1D`` and ``DeformCrossAttention1D``).

Queries come from the fused stream x1; keys and values are bilinearly sampled
from the path stream x2 at learned offset locations on a downsampled grid.
The bias MLP runs in the CPB kernels (``ops/kernels/cpb_bias.py``) and the
bias + softmax (+ dropout) + @v chain in the attention kernels
(``ops/kernels/deform_attn.py``), each through its ``torch.autograd.Function``
(forward kernel, recompute backward kernel): on CUDA tensors they launch their
CUDA kernels at every bag size, in eval and in training.  In training mode
with ``dropout > 0`` the attention probabilities are dropped inside the
kernels by Philox on a seed drawn per call from the caller's ``DropoutRNG``.
Tensors are channels-last, as in the JAX package.

Semantics kept from the JAX module:
* the query axes are normalized by ``w - 1`` / ``h - 1`` of the query grid, the
  sampled kv grid by ``wd - 1`` / ``hd - 1`` of the offset grid;
* channels split into contiguous groups (``_group`` / ``_ungroup``);
* the offset conv is depthwise (kernel 6, stride 4, padding 1), GELU is exact
  and the offsets are ``tanh(.) * offset_scale``;
* q is scaled by ``dim_head ** -0.5`` before the CPB and the attention;
* the returned ``vgrid`` is the unnormalized (B, g, Hd, Wd, 2) grid;
* a token ``mask`` zeroes both streams at the masked tokens first, so they
  act as the zeros padding outside the image (the kernels see no span).

The 1-D module differs from the 2-D one as the JAX module does: 4 offset
groups for 8 heads (2 bias heads per group, head = group * 2 + o), ungrouped
q / k / v projections, a biased ``to_out``, and its bias from ``CPB1D``, an
f32 MLP (1 -> dim -> dim -> 2) over sign-log 1-D displacements in plain
PyTorch products (in the JAX package it is XLA, not a Pallas kernel), handed
to the attention kernel in f32 beside the compute-dtype q, k and v.  Its
query and sampled-point coordinates are f32: the JAX module builds them in
the compute dtype, and in bf16 the coordinates of 2501 queries take 345
distinct values (``tests/test_torch_deform1d.py``).  ``CPB1D`` runs over
query chunks, as the JAX ``_chunked_mlp`` does, and like it saves each
chunk's activations for the backward: at 2501 queries x 625 points one
hidden activation of one branch is 6.4 GB in f32, and a train step keeps two
per branch.  The JAX fused route pads the sampled points to
a multiple of 8 (a TPU tiling rule) and masks the padding with a span; the
port passes J = Nd points and no span.

``seq`` (a ``parallel.mesh.Grid`` with more than one seq rank, set by the
model factory) splits the 2-D module's query rows over the seq group
(``parallel/seq_deform.py``), with the module's own parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional

from sml_tpu_torch.ops.common import Conv, Conv1, DropoutRNG, torch_kernel_init_
from sml_tpu_torch.ops.grid_sample import grid_sample_1d, grid_sample_2d
from sml_tpu_torch.ops.kernels.cpb_bias import cpb_bias_trainable
from sml_tpu_torch.ops.kernels.deform_attn import deform_attention_trainable


def make_grid_2d(h: int, w: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(h, w, 2) grid with [..., 0] = x (column) and [..., 1] = y (row) indices."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def normalize_grid_2d(grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalize (..., 2) xy coords from [0, size-1] to [-1, 1] per axis."""
    gx = 2.0 * grid[..., 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * grid[..., 1] / max(h - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def normalized_axis(n: int, device) -> torch.Tensor:
    """(n,) f32 coordinates 0 .. n-1 normalized to [-1, 1]."""
    return 2.0 * torch.arange(n, dtype=torch.float32, device=device) / max(n - 1, 1) - 1.0


def _signlog(p: torch.Tensor) -> torch.Tensor:
    return torch.sign(p) * torch.log(p.abs() + 1.0)


def _group(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, ..., g*d) -> (B*g, ..., d): split channels into g contiguous groups."""
    b, spatial, d = t.shape[0], t.shape[1:-1], t.shape[-1] // g
    t = t.reshape((b,) + spatial + (g, d)).movedim(-2, 1)
    return t.reshape((b * g,) + spatial + (d,))


def _ungroup(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B*g, ..., d) -> (B, ..., g*d)."""
    b, spatial, d = t.shape[0] // g, t.shape[1:-1], t.shape[-1]
    t = t.reshape((b, g) + spatial + (d,)).movedim(1, -2)
    return t.reshape((b,) + spatial + (g * d,))


def _flat_heads(t: torch.Tensor, heads: int, dh: int) -> torch.Tensor:
    """(B, ..., heads*dh) -> (B*heads, L, dh), L the tokens of the spatial axes."""
    b = t.shape[0]
    return t.reshape(b, -1, heads, dh).transpose(1, 2).reshape(b * heads, -1, dh).contiguous()


def _unflat_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B*heads, L, dh) -> (B, L, heads*dh)."""
    bh, length, dh = t.shape
    return t.reshape(bh // heads, heads, length, dh).transpose(1, 2).reshape(
        bh // heads, length, heads * dh)


def _masked(x1: torch.Tensor, x2: torch.Tensor, mask: Optional[torch.Tensor]):
    """Both streams zeroed at the tokens ``mask`` (B, N) marks invalid."""
    if mask is None:
        return x1, x2
    m = mask[..., None].to(x1.dtype)
    return x1 * m, x2 * m.to(x2.dtype)


class CPB2D(nn.Module):
    """Continuous position bias over signed-log 2-D displacements: a
    2 -> dim -> dim -> heads/groups MLP at every (query, sampled point) pair.
    Raw parameters named as in the flax tree (w0 (2, dim) ... b2)."""

    def __init__(self, dim: int, heads: int, offset_groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        o = heads // offset_groups
        self.dim, self.compute_dtype = dim, dtype
        self.w0 = nn.Parameter(torch.empty(2, dim))
        self.w1 = nn.Parameter(torch.empty(dim, dim))
        self.w2 = nn.Parameter(torch.empty(dim, o))
        self.b0 = nn.Parameter(torch.zeros(dim))
        self.b1 = nn.Parameter(torch.zeros(dim))
        self.b2 = nn.Parameter(torch.zeros(o))

    def init_raw_params(self, generator: torch.Generator) -> None:
        for w in (self.w0, self.w1, self.w2):
            torch_kernel_init_(w, w.shape[0], generator)
        for b in (self.b0, self.b1, self.b2):
            nn.init.zeros_(b)

    def raw(self):
        """(w0, w1, w2, b0, b1, b2)."""
        return self.w0, self.w1, self.w2, self.b0, self.b1, self.b2

    def factors(self, x_coords: torch.Tensor, y_coords: torch.Tensor,
                grid_kv: torch.Tensor, raw=None):
        """Kernel operands (dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
        dx (BG, W*J) f32 in lane order x*J + j, dy (BG, H, J) f32, and the MLP
        weights in the compute dtype (from ``raw``, ``raw()``'s tuple, in place
        of the module's own where given).  Any rows of the query grid may be
        asked for: the MLP is separable in y."""
        cdt = self.compute_dtype
        gk = grid_kv.float()
        dx = _signlog(x_coords[None, :, None] - gk[:, None, :, 0])      # (BG, W, J)
        dy = _signlog(y_coords[None, :, None] - gk[:, None, :, 1])      # (BG, H, J)
        w0, w1, w2, b0, b1, b2 = self.raw() if raw is None else raw
        weights = (w0[0], w0[1], b0, w1, b1, w2, b2)
        return (dx.reshape(dx.shape[0], -1).contiguous(), dy.contiguous(),
                *(w.to(cdt).contiguous() for w in weights))

    def naive(self, x_coords: torch.Tensor, y_coords: torch.Tensor,
              grid_kv: torch.Tensor, query_chunk: int = 512) -> torch.Tensor:
        """(BG, H*W, J, heads/groups) bias from the dense displacement MLP
        (the JAX ``CPB2D._naive``), queries in chunks; query index iy*W + ix."""
        cdt = self.compute_dtype
        grid_q = torch.stack([x_coords.repeat(y_coords.shape[0]),
                              y_coords.repeat_interleave(x_coords.shape[0])], dim=-1)
        ws = [w.to(cdt) for w in (self.w0, self.w1, self.w2)]
        bs = [b.to(cdt) for b in (self.b0, self.b1, self.b2)]

        def mlp(pos):
            x = pos.to(cdt)
            for i in range(3):
                x = (x @ ws[i]).to(cdt) + bs[i]
                if i < 2:
                    x = torch.relu(x)
            return x

        outs = []
        for i0 in range(0, grid_q.shape[0], query_chunk):
            pos = grid_q[None, i0:i0 + query_chunk, None, :] - grid_kv[:, None, :, :]
            outs.append(mlp(_signlog(pos)))
        return torch.cat(outs, dim=1)


class DeformCrossAttention2D(nn.Module):
    """2-D deformable cross-attention over (B, N, C) tokens, N a perfect square."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 dropout: float = 0.0, downsample_factor: int = 4, offset_scale: float = 4.0,
                 offset_groups: int = 8, offset_kernel_size: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if heads != offset_groups:
            raise ValueError("the kernels take one bias head per offset group")
        if (offset_kernel_size - downsample_factor) % 2:
            raise ValueError("offset_kernel_size - downsample_factor must be even")
        inner = dim_head * heads
        offset_dims = inner // offset_groups
        g = offset_groups
        self.dim, self.dim_head, self.heads, self.groups = dim, dim_head, heads, g
        self.offset_scale = offset_scale
        self.dropout = dropout
        self.compute_dtype = dtype
        pad = (offset_kernel_size - downsample_factor) // 2
        self.to_q = Conv(dim, inner, groups=g, bias=False, dtype=dtype)
        self.offset_conv = Conv(offset_dims, offset_dims, offset_kernel_size,
                                stride=downsample_factor, padding=pad,
                                groups=offset_dims, dtype=dtype)
        self.offset_proj = Conv(offset_dims, 2, bias=False, dtype=dtype)
        self.to_k = Conv(dim, inner, groups=g, bias=False, dtype=dtype)
        self.to_v = Conv(dim, inner, groups=g, bias=False, dtype=dtype)
        self.to_out = Conv(inner, dim, dtype=dtype)
        self.rel_pos_bias = CPB2D(dim // 4, heads, g, dtype=dtype)
        self.seq = None

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, return_vgrid: bool = False,
                rng: Optional[DropoutRNG] = None, mask: Optional[torch.Tensor] = None):
        """``rng`` draws the dropout seed; needed in training mode with dropout > 0.
        ``mask`` (B, N) marks the valid tokens."""
        b, n, c = x1.shape
        h = w = math.isqrt(n)
        if h * w != n:
            raise ValueError(f"token count {n} must be a perfect square (the model pads "
                             "a bag to the next square grid, with a mask)")
        if self.seq is not None:
            from sml_tpu_torch.parallel.seq_deform import seq_parallel_deform_2d

            out, vgrid = seq_parallel_deform_2d(self, x1, x2, mask, rng)
            return (out, vgrid) if return_vgrid else out
        x1, x2 = _masked(x1, x2, mask)
        g, heads, dh = self.groups, self.heads, self.dim_head
        inner = dh * heads

        q = self.to_q(x1.reshape(b, h, w, c))                      # (B, H, W, inner)
        off = self.offset_conv(_group(q, g))                       # (B*g, Hd, Wd, od)
        off = self.offset_proj(F.gelu(off, approximate="none"))
        offsets = torch.tanh(off) * self.offset_scale              # (B*g, Hd, Wd, 2)

        hd, wd = offsets.shape[1], offsets.shape[2]
        j = hd * wd
        vgrid = make_grid_2d(hd, wd, offsets.dtype, offsets.device)[None] + offsets
        vgrid_scaled = normalize_grid_2d(vgrid, hd, wd)

        kv = _ungroup(grid_sample_2d(_group(x2.reshape(b, h, w, c), g), vgrid_scaled), g)
        k = self.to_k(kv)                                          # (B, Hd, Wd, inner)
        v = self.to_v(kv)
        q = q * (dh ** -0.5)

        x_axis, y_axis = normalized_axis(w, x1.device), normalized_axis(h, x1.device)
        grid_kv = vgrid_scaled.reshape(b * g, j, 2)
        bias = cpb_bias_trainable(*self.rel_pos_bias.factors(x_axis, y_axis, grid_kv))
        keep_prob, seed = 1.0, 0
        if self.training and self.dropout > 0.0:
            if rng is None:
                raise ValueError("training-mode attention dropout needs a DropoutRNG")
            keep_prob, seed = 1.0 - self.dropout, rng.philox_seed()
        out = deform_attention_trainable(_flat_heads(q, heads, dh), _flat_heads(k, heads, dh),
                                         _flat_heads(v, heads, dh), bias.reshape(b * g, n, j),
                                         keep_prob, seed)           # (B*heads, N, dh)
        out = self.to_out(_unflat_heads(out, heads).reshape(b, h, w, inner))
        out = out.reshape(b, n, self.dim)
        if return_vgrid:
            return out, vgrid.reshape(b, g, hd, wd, 2)
        return out


class CPB1D(nn.Module):
    """Continuous position bias over signed-log 1-D displacements: a
    1 -> dim -> dim -> heads/groups MLP at every (query, sampled point) pair, in
    f32, over chunks of ``query_chunk`` queries.  Raw parameters named as in the
    flax tree (w0 (1, dim) ... b2)."""

    def __init__(self, dim: int, heads: int, offset_groups: int, query_chunk: int = 512):
        super().__init__()
        o = heads // offset_groups
        self.groups, self.query_chunk = offset_groups, query_chunk
        self.w0 = nn.Parameter(torch.empty(1, dim))
        self.w1 = nn.Parameter(torch.empty(dim, dim))
        self.w2 = nn.Parameter(torch.empty(dim, o))
        self.b0 = nn.Parameter(torch.zeros(dim))
        self.b1 = nn.Parameter(torch.zeros(dim))
        self.b2 = nn.Parameter(torch.zeros(o))

    def init_raw_params(self, generator: torch.Generator) -> None:
        for w in (self.w0, self.w1, self.w2):
            torch_kernel_init_(w, w.shape[0], generator)
        for b in (self.b0, self.b1, self.b2):
            nn.init.zeros_(b)

    def _chunk(self, grid_q: torch.Tensor, grid_kv: torch.Tensor) -> torch.Tensor:
        """(BG, I, J, o) MLP of the displacements of queries grid_q (I,) to the
        points grid_kv (BG, J)."""
        pos = _signlog(grid_q[None, :, None, None] - grid_kv[:, None, :, None])  # (BG, I, J, 1)
        x = torch.relu(pos * self.w0[0] + self.b0)
        x = torch.relu(x @ self.w1 + self.b1)
        return x @ self.w2 + self.b2

    def forward(self, grid_q: torch.Tensor, grid_kv: torch.Tensor,
                batch: int) -> torch.Tensor:
        """grid_q (N,), grid_kv (B*g, J) normalized f32 coordinates ->
        (B, heads, N, J) f32 bias, head = group * heads/groups + o."""
        grid_q, grid_kv = grid_q.float(), grid_kv.float()
        g, n, j = self.groups, grid_q.shape[0], grid_kv.shape[1]
        chunk = self.query_chunk
        outs = []
        for i0 in range(0, n, chunk):
            out = self._chunk(grid_q[i0:i0 + chunk], grid_kv)      # (BG, I, J, o)
            # -> (B, g, o, I, J)
            outs.append(out.reshape(batch, g, out.shape[1], j, -1).permute(0, 1, 4, 2, 3))
        return torch.cat(outs, dim=3).reshape(batch, -1, n, j)


class DeformCrossAttention1D(nn.Module):
    """1-D deformable cross-attention over (B, N, C) token sequences (the cls
    token is prepended upstream).  to_q, to_k and to_v are not grouped, the
    position bias takes signed-log distances over query chunks of 512, and the
    layer that uses it passes no dropout."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 downsample_factor: int = 4, offset_scale: float = 4.0,
                 offset_groups: int = 4, offset_kernel_size: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if (offset_kernel_size - downsample_factor) % 2:
            raise ValueError("offset_kernel_size - downsample_factor must be even")
        inner = dim_head * heads
        offset_dims = inner // offset_groups
        g = offset_groups
        self.dim, self.dim_head, self.heads, self.groups = dim, dim_head, heads, g
        self.offset_scale = offset_scale
        pad = (offset_kernel_size - downsample_factor) // 2
        self.to_q = Conv1(dim, inner, bias=False, dtype=dtype)
        self.offset_conv = Conv1(offset_dims, offset_dims, offset_kernel_size,
                                 stride=downsample_factor, padding=pad,
                                 groups=offset_dims, dtype=dtype)
        self.offset_proj = Conv1(offset_dims, 1, bias=False, dtype=dtype)
        self.to_k = Conv1(dim, inner, bias=False, dtype=dtype)
        self.to_v = Conv1(dim, inner, bias=False, dtype=dtype)
        self.to_out = Conv1(inner, dim, dtype=dtype)
        self.rel_pos_bias = CPB1D(dim // 4, heads, g)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x1 (queries) and x2 (sampled) (B, N, C); ``mask`` (B, N) marks the
        valid tokens."""
        b, n, _ = x1.shape
        x1, x2 = _masked(x1, x2, mask)
        g, heads, dh = self.groups, self.heads, self.dim_head

        q = self.to_q(x1)                                          # (B, N, inner)
        off = self.offset_conv(_group(q, g))                       # (B*g, Nd, od)
        off = self.offset_proj(F.gelu(off, approximate="none"))[..., 0]
        offsets = torch.tanh(off.float()) * self.offset_scale      # (B*g, Nd)
        nd = offsets.shape[-1]
        vgrid = torch.arange(nd, dtype=torch.float32, device=x1.device)[None] + offsets
        vgrid_scaled = 2.0 * vgrid / max(nd - 1, 1) - 1.0

        kv = _ungroup(grid_sample_1d(_group(x2, g), vgrid_scaled), g)   # (B, Nd, C)
        k, v = self.to_k(kv), self.to_v(kv)
        q = q * (dh ** -0.5)
        # (B, heads, N, Nd) f32
        bias = self.rel_pos_bias(normalized_axis(n, x1.device), vgrid_scaled, b)
        out = deform_attention_trainable(_flat_heads(q, heads, dh), _flat_heads(k, heads, dh),
                                         _flat_heads(v, heads, dh),
                                         bias.reshape(b * heads, n, nd))
        return self.to_out(_unflat_heads(out, heads))
