"""Genomic-guided 2-D deformable cross-attention with a continuous relative position
bias (counterpart of ``sml_tpu/ops/deformable.py``: ``CPB2D`` and
``DeformCrossAttention2D``).

Queries come from the fused stream x1; keys and values are bilinearly sampled
from the path stream x2 at learned offset locations on a downsampled grid.
The bias MLP runs in the CPB kernel (``ops/kernels/cpb_bias.py``) and the
bias + softmax + @v chain in the attention kernel
(``ops/kernels/deform_attn.py``): on CUDA tensors both launch their CUDA
kernels at every bag size.  Tensors are channels-last, as in the JAX package.

Semantics kept from the JAX module:
* the query axes are normalized by ``w - 1`` / ``h - 1`` of the query grid, the
  sampled kv grid by ``wd - 1`` / ``hd - 1`` of the offset grid;
* channels split into contiguous groups (``_group`` / ``_ungroup``);
* the offset conv is depthwise (kernel 6, stride 4, padding 1), GELU is exact
  and the offsets are ``tanh(.) * offset_scale``;
* q is scaled by ``dim_head ** -0.5`` before the CPB and the attention;
* the returned ``vgrid`` is the unnormalized (B, g, Hd, Wd, 2) grid.
Not ported yet: the sequence-parallel branch and the token ``mask`` branch
(non-square bags).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sml_tpu_torch.ops.common import Conv, torch_kernel_init_
from sml_tpu_torch.ops.grid_sample import grid_sample_2d
from sml_tpu_torch.ops.kernels.cpb_bias import cpb_bias
from sml_tpu_torch.ops.kernels.deform_attn import deform_attention_fwd


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

    def factors(self, x_coords: torch.Tensor, y_coords: torch.Tensor,
                grid_kv: torch.Tensor):
        """Kernel operands (dx, dy, w0x, w0y, b0, w1, b1, w2, b2):
        dx (BG, W*J) f32 in lane order x*J + j, dy (BG, H, J) f32, and the MLP
        weights in the compute dtype."""
        cdt = self.compute_dtype
        gk = grid_kv.float()
        dx = _signlog(x_coords[None, :, None] - gk[:, None, :, 0])      # (BG, W, J)
        dy = _signlog(y_coords[None, :, None] - gk[:, None, :, 1])      # (BG, H, J)
        weights = (self.w0[0], self.w0[1], self.b0, self.w1, self.b1, self.w2,
                   self.b2)
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
                 downsample_factor: int = 4, offset_scale: float = 4.0,
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

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, return_vgrid: bool = False):
        b, n, c = x1.shape
        h = w = math.isqrt(n)
        if h * w != n:
            raise NotImplementedError(
                f"token count {n} is not a perfect square: the masked bag path "
                "is not ported yet")
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

        def flat_heads(t, length):                                 # -> (B*heads, L, dh)
            return t.reshape(b, length, heads, dh).transpose(1, 2).reshape(
                b * heads, length, dh).contiguous()

        dev = x1.device
        x_axis = 2.0 * torch.arange(w, dtype=torch.float32, device=dev) / max(w - 1, 1) - 1.0
        y_axis = 2.0 * torch.arange(h, dtype=torch.float32, device=dev) / max(h - 1, 1) - 1.0
        grid_kv = vgrid_scaled.reshape(b * g, j, 2)
        bias = cpb_bias(*self.rel_pos_bias.factors(x_axis, y_axis, grid_kv))
        out = deform_attention_fwd(flat_heads(q, n), flat_heads(k, j), flat_heads(v, j),
                                   bias.reshape(b * g, n, j))      # (B*heads, N, dh)
        out = out.reshape(b, heads, n, dh).transpose(1, 2).reshape(b, h, w, inner)
        out = self.to_out(out).reshape(b, n, self.dim)
        if return_vgrid:
            return out, vgrid.reshape(b, g, hd, wd, 2)
        return out
