"""Fusion blocks (counterpart of ``sml_tpu/ops/fusion.py``): the per-token
concat fusion ``FusionNet``, the gated ``BilinearFusion`` (with flax's
BatchNorm) and ``TrilinearFusion``.

In ``FusionNet`` the second stream is one omic vector per sample, broadcast to every token, so
the concat product splits exactly: ``[x1, x2] @ W == x1 @ W[:d1] + (x2 @ W[d1:]
+ b)``, the second term one row per sample instead of N identical token rows.
The parameter is the single ``fusion_layer`` kernel of the flax tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sml_tpu_torch.ops.common import Bilinear, Dense, DropoutRNG, dropout
from sml_tpu_torch.parallel.batchnorm import moments


class FusionNet(nn.Module):
    def __init__(self, gene_dim: int, image_dim: int, feature_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gene_dim = gene_dim
        self.fusion_layer = Dense(gene_dim + image_dim, feature_dim, dtype=dtype)

    def forward(self, gene_features: torch.Tensor,
                image_features: torch.Tensor) -> torch.Tensor:
        """gene_features (B, N, d1) tokens; image_features (B, d2) per sample."""
        layer = self.fusion_layer
        cdt = layer.compute_dtype
        w = layer.weight.to(cdt)                                  # (out, d1 + d2)
        d1 = self.gene_dim
        tok = F.linear(gene_features.to(cdt), w[:, :d1])
        per_sample = F.linear(image_features.to(cdt), w[:, d1:], layer.bias.to(cdt))
        return tok + per_sample[:, None, :]


class BatchNorm(nn.BatchNorm1d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the batch axis of
    (B, C) features, in f32 whatever the input's dtype (flax promotes to its
    f32 parameters).  Training mode normalizes by the batch's mean and *biased*
    variance and moves the running averages by ``ra = 0.9 ra + 0.1 batch``, the
    variance biased too; eval mode normalizes by the running averages.  torch's
    own update would take the unbiased variance, and its ``momentum`` is 1 -
    flax's.  The variance is taken in two passes, E[(x - E[x])^2], a
    departure from flax kept on purpose (ROADMAP.md section 3): flax's one
    pass E[x^2] - E[x]^2 is the same in exact arithmetic but cancels where a
    feature's batch mean is far above its spread, as in small batches
    (tests/test_torch_fusion_modes.py::
    test_bilinear_fusion_b3_gradients_nearer_float64_than_jax).  With ``group``
    (a data group of more than one rank, set by the model factory) the batch's
    moments are the global batch's, taken over the group
    (``parallel/batchnorm.py:moments``), as flax's BatchNorm sees the global
    batch under the JAX package's jit; the running variance stays biased."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean, var, _ = moments(x, self.group)
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _with_ones(o: torch.Tensor) -> torch.Tensor:
    return torch.cat([o, o.new_ones(o.shape[0], 1)], dim=1)


def _outer_with_ones(o1: torch.Tensor, o2: torch.Tensor) -> torch.Tensor:
    """(B, (d1 + 1) (d2 + 1)): the outer product of [o1, 1] and [o2, 1]."""
    o1, o2 = _with_ones(o1), _with_ones(o2)
    return (o1[:, :, None] * o2[:, None, :]).reshape(o1.shape[0], -1)


class _GatedFusion(nn.Module):
    """The gated branch of the JAX fusion blocks (``dim_in`` the input's width,
    ``dim`` the branch's): ``linear_o{i}`` of the input,
    or, gated, of sigmoid(z) * relu(``linear_h{i}``(input)) with z the
    ``linear_z{i}`` of a pair of inputs (``Bilinear``, or a Dense of their
    concat); ReLU and dropout after."""

    def _make_gate(self, idx: int, gate: int, use_bilinear: int, dim_in: int, dim: int,
                   pair: tuple, dtype: torch.dtype) -> None:
        if gate:
            self.add_module(f"linear_h{idx}", Dense(dim_in, dim, dtype=dtype))
            z = (Bilinear(pair[0], pair[1], dim) if use_bilinear
                 else Dense(pair[0] + pair[1], dim, dtype=dtype))
            self.add_module(f"linear_z{idx}", z)
        self.add_module(f"linear_o{idx}", Dense(dim_in if not gate else dim, dim, dtype=dtype))

    def _gated(self, idx: int, gate: int, vec: torch.Tensor, pair: tuple, drop) -> torch.Tensor:
        out = getattr(self, f"linear_o{idx}")
        if not gate:
            return drop(torch.relu(out(vec)))
        h = torch.relu(getattr(self, f"linear_h{idx}")(vec))
        z_layer = getattr(self, f"linear_z{idx}")
        z = (z_layer(*pair) if isinstance(z_layer, Bilinear)
             else z_layer(torch.cat(pair, dim=1)))
        return drop(torch.relu(out(torch.sigmoid(z) * h)))


class BilinearFusion(_GatedFusion):
    """Gated bilinear fusion of two vectors (counterpart of
    ``sml_tpu/ops/fusion.py:BilinearFusion``): gated branches o1, o2, the outer
    product of [o1, 1] and [o2, 1], then ``encoder1`` -> ``bn1`` -> ReLU and
    ``encoder2`` (over [out, o1, o2] with ``skip``) -> ``bn2`` -> ReLU, with
    dropout at each of those five points; (B, mmhid) f32 out."""

    def __init__(self, skip: int = 1, use_bilinear: int = 1, gate1: int = 1,
                 gate2: int = 1, dim1: int = 32, dim2: int = 32, scale_dim1: int = 1,
                 scale_dim2: int = 1, mmhid: int = 64, dropout_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32, in1: Optional[int] = None,
                 in2: Optional[int] = None):
        """``in1`` / ``in2``: the widths of vec1 / vec2 (default dim1 / dim2);
        the flax layers take them from their inputs, and deformpathomic hands
        two path_dim-wide vectors to a block of dim2 = omic_dim."""
        super().__init__()
        d1, d2 = dim1 // scale_dim1, dim2 // scale_dim2
        in1, in2 = in1 or dim1, in2 or dim2
        self.skip, self.gate1, self.gate2 = skip, gate1, gate2
        self.dropout_rate = dropout_rate
        self._make_gate(1, gate1, use_bilinear, in1, d1, (in1, in2), dtype)
        self._make_gate(2, gate2, use_bilinear, in2, d2, (in1, in2), dtype)
        self.encoder1 = Dense((d1 + 1) * (d2 + 1), mmhid, dtype=dtype)
        self.bn1 = BatchNorm(mmhid)
        self.encoder2 = Dense(mmhid + (d1 + d2 + 2 if skip else 0), mmhid, dtype=dtype)
        self.bn2 = BatchNorm(mmhid)

    def forward(self, vec1: torch.Tensor, vec2: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Training mode: batch statistics (and their running averages move),
        dropout from ``rng``; eval mode: the running averages, no dropout."""
        gen = None if rng is None else rng.device
        drop = lambda x: dropout(x, self.dropout_rate, self.training, gen)
        vec1, vec2 = torch.relu(vec1), torch.relu(vec2)
        o1 = self._gated(1, self.gate1, vec1, (vec1, vec2), drop)
        o2 = self._gated(2, self.gate2, vec2, (vec1, vec2), drop)
        out = drop(_outer_with_ones(o1, o2))
        out = drop(torch.relu(self.bn1(self.encoder1(out))))
        if self.skip:
            out = torch.cat([out, _with_ones(o1), _with_ones(o2)], dim=1)
        return drop(torch.relu(self.bn2(self.encoder2(out))))


class TrilinearFusion(_GatedFusion):
    """Gated fusion of three vectors (counterpart of
    ``sml_tpu/ops/fusion.py:TrilinearFusion``; no mode of either package calls
    it): variant A gates o2 by (vec2, vec3), variant B by (vec2, vec1); o1 and o3
    by (vec1, vec3); the outer product of [o1, 1], [o2, 1] and [o3, 1], then
    ``encoder1`` and ``encoder2`` (over [out, o1, o2, o3] with ``skip``), each
    with ReLU and dropout, no BatchNorm."""

    def __init__(self, variant: str = "A", skip: int = 1, use_bilinear: int = 1,
                 gate1: int = 1, gate2: int = 1, gate3: int = 1, dim1: int = 32,
                 dim2: int = 32, dim3: int = 32, scale_dim1: int = 1, scale_dim2: int = 1,
                 scale_dim3: int = 1, mmhid: int = 96, dropout_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d1, d2, d3 = dim1 // scale_dim1, dim2 // scale_dim2, dim3 // scale_dim3
        self.variant, self.skip, self.gates = variant, skip, (gate1, gate2, gate3)
        self.dropout_rate = dropout_rate
        pair2 = (dim2, dim3) if variant == "A" else (dim2, dim1)
        for idx, (gate, dim_in, d, pair) in enumerate(
                ((gate1, dim1, d1, (dim1, dim3)), (gate2, dim2, d2, pair2),
                 (gate3, dim3, d3, (dim1, dim3))), start=1):
            self._make_gate(idx, gate, use_bilinear, dim_in, d, pair, dtype)
        self.encoder1 = Dense((d1 + 1) * (d2 + 1) * (d3 + 1), mmhid, dtype=dtype)
        self.encoder2 = Dense(mmhid + (d1 + d2 + d3 + 3 if skip else 0), mmhid, dtype=dtype)

    def forward(self, vec1: torch.Tensor, vec2: torch.Tensor, vec3: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        gen = None if rng is None else rng.device
        drop = lambda x: dropout(x, self.dropout_rate, self.training, gen)
        g1, g2, g3 = self.gates
        pair2 = (vec2, vec3) if self.variant == "A" else (vec2, vec1)
        o1 = self._gated(1, g1, vec1, (vec1, vec3), drop)
        o2 = self._gated(2, g2, vec2, pair2, drop)
        o3 = self._gated(3, g3, vec3, (vec1, vec3), drop)
        o123 = (_outer_with_ones(o1, o2)[:, :, None] * _with_ones(o3)[:, None, :]
                ).reshape(o1.shape[0], -1)
        out = drop(o123)
        out = drop(torch.relu(self.encoder1(out)))
        if self.skip:
            out = torch.cat([out, _with_ones(o1), _with_ones(o2), _with_ones(o3)], dim=1)
        return drop(torch.relu(self.encoder2(out)))
