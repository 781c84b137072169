"""DeformPathomicNet, the paper's dual-subspace genomic-guided deformable model
(counterpart of ``sml_tpu/models/deform.py``).

Two branches (tumor / immune genes), each MaxNet -> per-token fusion with the
path bag -> deformable cross-attention -> pooled vector; the two vectors are
concatenated (``fusion_type`` concat) or fused by ``BilinearFusion`` (any
other ``fusion_type``, gates 1 and 1) -> classifier, plus per-branch heads;
for survival the heads are sigmoided in the model.  Submodules carry the flax
tree's names so the weight bridge maps leaf by leaf.

``attn_dim`` 2 pads a bag to the next square grid (its padded tokens masked),
runs ``DeformCrossAttention2D`` and pools the tokens under the mask;
``attn_dim`` 1 prepends a learned cls token to both streams (and a valid
entry to the mask), runs ``DeformCrossAttention1D`` and reads the cls token
after a final LayerNorm.  ``remat`` rematerialises each branch's
``DeformCrossTransMIL`` in training (JAX ``nn.remat``): its activations are
dropped after the forward and recomputed in the backward, from the dropout
generators' states of the forward.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sml_tpu_torch.models.maxnet import MaxNet
from sml_tpu_torch.ops.common import Dense, DropoutRNG
from sml_tpu_torch.ops.deformable import DeformCrossAttention1D, DeformCrossAttention2D
from sml_tpu_torch.ops.fusion import BilinearFusion, FusionNet
from sml_tpu_torch.ops.pooling import Pooler


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


def _norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm with f32 params: statistics and output in f32."""
    return norm(x.float())


class DeformCrossTransLayer(nn.Module):
    """Pre-norm deformable cross-attention residual block; ONE LayerNorm shared by
    both streams.  ``attn_dim`` 1 takes no dropout (as in the JAX layer)."""

    def __init__(self, dim: int = 128, attn_dim: int = 2, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn_dim = attn_dim
        self.norm = _layer_norm(dim)
        if attn_dim == 1:
            self.attn1d = DeformCrossAttention1D(dim, downsample_factor=4, offset_scale=2.0,
                                                 offset_kernel_size=6, dtype=dtype)
        else:
            self.attn2d = DeformCrossAttention2D(dim, dim_head=64, heads=8, dropout=dropout,
                                                 downsample_factor=4, offset_scale=4.0,
                                                 offset_groups=8, offset_kernel_size=6,
                                                 dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                rng: Optional[DropoutRNG] = None, mask: Optional[torch.Tensor] = None):
        """(x1 + attention, vgrid); the 1-D attention has no vgrid (None)."""
        n1, n2 = _norm_f32(self.norm, x1), _norm_f32(self.norm, x2)
        if self.attn_dim == 1:
            return x1 + self.attn1d(n1, n2, mask=mask), None
        out, vgrid = self.attn2d(n1, n2, return_vgrid=True, rng=rng, mask=mask)
        return x1 + out, vgrid


class DeformCrossTransMIL(nn.Module):
    """Pathomic fusion MIL block of one branch."""

    def __init__(self, input_path_dim: int, omic_dim: int, n_classes: int = 4,
                 path_dim: int = 128, attn_dim: int = 2, return_vgrid: bool = True,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn_dim, self.return_vgrid = attn_dim, return_vgrid
        self.fc1 = Dense(input_path_dim, path_dim, dtype=dtype)
        self.fusion_layer = FusionNet(path_dim, omic_dim, path_dim, dtype=dtype)
        self.layer3 = DeformCrossTransLayer(path_dim, attn_dim, dropout, dtype=dtype)
        if attn_dim == 1:
            self.cls_token = nn.Parameter(torch.empty(1, 1, path_dim))
        self.norm = _layer_norm(path_dim)
        if attn_dim == 2:
            self.pooler = Pooler(path_dim, dtype=dtype)
        self.fc2 = Dense(path_dim, n_classes, dtype=dtype)
        self.multimodal_projection = Dense(path_dim, path_dim, dtype=dtype)

    def init_raw_params(self, generator: torch.Generator) -> None:
        """``cls_token``: flax's normal(1.0)."""
        if self.attn_dim == 1:
            with torch.no_grad():
                self.cls_token.normal_(0.0, 1.0, generator=generator)

    def forward(self, path: torch.Tensor, omic: torch.Tensor,
                rng: Optional[DropoutRNG] = None,
                mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """path (B, N, input_path_dim); omic (B, omic_dim); mask (B, N) marks the
        real patches."""
        b, n, _ = path.shape
        path = torch.relu(self.fc1(path))                          # (B, N, path_dim)
        if self.attn_dim == 2:
            # a bag that is no square grid: zero tokens to the next square, masked
            side = math.isqrt(n - 1) + 1
            add = side * side - n
            if add:
                path = F.pad(path, (0, 0, 0, add))
                if mask is None:
                    mask = torch.ones(b, n, dtype=torch.bool, device=path.device)
                mask = F.pad(mask.bool(), (0, add))
        h = self.fusion_layer(path, omic)
        vgrid = None
        if self.attn_dim == 1:
            cls = self.cls_token.expand(b, 1, -1).to(h.dtype)
            h = torch.cat([cls, h], dim=1)
            path = torch.cat([cls.to(path.dtype), path], dim=1)
            if mask is not None:                                   # the cls token is valid
                mask = torch.cat([mask.new_ones(b, 1).bool(), mask.bool()], dim=1)
            h, _ = self.layer3(h, path, rng, mask)
            h = _norm_f32(self.norm, h)[:, 0]
        else:
            h, vgrid = self.layer3(h, path, rng, mask)
            h = self.pooler(_norm_f32(self.norm, h), mask)
        out = {"features": self.multimodal_projection(h), "logits": self.fc2(h)}
        if self.return_vgrid and vgrid is not None:
            out["omic"] = omic                                     # (B, omic_dim)
            out["vgrid"] = vgrid                                   # (B, g, Hd, Wd, 2)
        return out


def _rematerialised(module: nn.Module, path: torch.Tensor, omic: torch.Tensor,
                    rng: Optional[DropoutRNG], mask: Optional[torch.Tensor]):
    """``module(path, omic, rng, mask)`` under ``torch.utils.checkpoint``.
    The checkpoint restores only torch's global generators, and the branch
    draws from ``rng``'s: the recompute starts from their states before the
    forward (the same Philox seeds and dropout masks) and leaves them as it
    found them, so the gradients and every later draw are those of the run
    without remat."""
    before = None if rng is None else rng.get_state()
    calls = []

    def run(path, omic, mask):
        if not calls or rng is None:
            calls.append(1)
            return module(path, omic, rng, mask)
        now = rng.get_state()                      # the recompute, in the backward
        rng.set_state(before)
        try:
            return module(path, omic, rng, mask)
        finally:
            rng.set_state(now)

    return checkpoint(run, path, omic, mask, use_reentrant=False, preserve_rng_state=False)


class DeformPathomicNet(nn.Module):
    """Flagship model."""

    def __init__(self, label_dim: int = 4, input_size_omic_tumor: int = 59,
                 input_size_omic_immune: int = 361, input_path_dim: int = 1024,
                 path_dim: int = 128, omic_dim: int = 128, mmhid: int = 128,
                 dropout_rate: float = 0.1, attn_dim: int = 2, return_vgrid: bool = True,
                 fusion_type: str = "concat", cut_fuse_grad: bool = False,
                 task_type: str = "diag2021", init_max: bool = True, skip: int = 0,
                 use_bilinear: int = 1, path_scale: int = 1, omic_scale: int = 1,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_vgrid, self.remat = return_vgrid, remat
        self.task_type = task_type
        self.fusion_type, self.cut_fuse_grad = fusion_type, cut_fuse_grad
        for name, gene_dim in (("tumor", input_size_omic_tumor),
                               ("immune", input_size_omic_immune)):
            self.add_module(f"omic_net_{name}",
                            MaxNet(gene_dim, omic_dim, dropout_rate, label_dim,
                                   init_max=init_max, dtype=dtype))
            self.add_module(f"pathomic_net_{name}",
                            DeformCrossTransMIL(input_path_dim, omic_dim, label_dim,
                                                path_dim, attn_dim, return_vgrid,
                                                dropout_rate, dtype=dtype))
        if fusion_type == "concat":
            fused = 2 * path_dim
        else:
            # both branches' vectors are path_dim wide; BilinearFusion takes
            # dim1 = path_dim and dim2 = omic_dim, as in the JAX model
            self.fusion = BilinearFusion(skip, use_bilinear, 1, 1, path_dim, omic_dim,
                                         path_scale, omic_scale, mmhid, dropout_rate,
                                         dtype=dtype, in1=path_dim, in2=path_dim)
            fused = mmhid
        if remat and any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                         for name in ("tumor", "immune")
                         for m in getattr(self, f"pathomic_net_{name}").modules()):
            # the recompute would move its running averages a second time
            raise ValueError("remat: a rematerialised branch holds a BatchNorm")
        self.classifier = Dense(fused, label_dim, dtype=dtype)
        self.classifier_tumor = Dense(path_dim, label_dim, dtype=dtype)
        self.classifier_immune = Dense(path_dim, label_dim, dtype=dtype)

    def forward(self, x_path: torch.Tensor, x_omic_tumor: torch.Tensor,
                x_omic_immune: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """``rng`` (training mode with dropout_rate > 0) feeds every dropout;
        ``mask`` (B, N) marks the real patches of padded (bucketed) bags."""
        def branch(name, x_omic):
            mil = getattr(self, f"pathomic_net_{name}")
            omic = getattr(self, f"omic_net_{name}")(x_omic, rng)["features"]
            if self.remat and self.training and torch.is_grad_enabled():
                return _rematerialised(mil, x_path, omic, rng, mask)
            return mil(x_path, omic, rng, mask)

        tumor = branch("tumor", x_omic_tumor)
        immune = branch("immune", x_omic_immune)

        v_t, v_i = tumor["features"], immune["features"]
        if self.cut_fuse_grad:
            v_t, v_i = v_t.detach(), v_i.detach()
        if self.fusion_type == "concat":
            features = torch.cat([v_t, v_i], dim=1)
        else:
            features = self.fusion(v_t, v_i, rng)
        hazard = self.classifier(features)
        hazard_t = self.classifier_tumor(tumor["features"])
        hazard_i = self.classifier_immune(immune["features"])
        if self.task_type == "survival":
            hazard, hazard_t, hazard_i = (torch.sigmoid(t)
                                          for t in (hazard, hazard_t, hazard_i))
        out = {
            "features": features,
            "vec_tumor": tumor["features"],
            "vec_immune": immune["features"],
            "logits_tumor": hazard_t,
            "logits_immune": hazard_i,
            "logits": hazard,
        }
        if self.return_vgrid:
            out["omic_tumor"] = tumor["omic"]
            out["vgrid_tumor"] = tumor["vgrid"]
            out["omic_immune"] = immune["omic"]
            out["vgrid_immune"] = immune["vgrid"]
        return out
