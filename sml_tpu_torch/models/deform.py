"""DeformPathomicNet, the paper's dual-subspace genomic-guided deformable model, with
2-D deformable attention (counterpart of ``sml_tpu/models/deform.py``).

Two branches (tumor / immune genes), each MaxNet -> per-token fusion with the
path bag -> deformable cross-attention -> pooled vector; concat -> classifier,
plus per-branch heads; for survival the heads are sigmoided in the model.
Submodules carry the flax tree's names so the weight bridge maps leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sml_tpu_torch.models.maxnet import MaxNet
from sml_tpu_torch.ops.common import Dense, DropoutRNG
from sml_tpu_torch.ops.deformable import DeformCrossAttention2D
from sml_tpu_torch.ops.fusion import FusionNet
from sml_tpu_torch.ops.pooling import Pooler


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


def _norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm with f32 params: statistics and output in f32."""
    return norm(x.float())


class DeformCrossTransLayer(nn.Module):
    """Pre-norm deformable cross-attention residual block; ONE LayerNorm shared by
    both streams."""

    def __init__(self, dim: int = 128, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = _layer_norm(dim)
        self.attn2d = DeformCrossAttention2D(dim, dim_head=64, heads=8, dropout=dropout,
                                             downsample_factor=4, offset_scale=4.0,
                                             offset_groups=8, offset_kernel_size=6,
                                             dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                rng: Optional[DropoutRNG] = None):
        out, vgrid = self.attn2d(_norm_f32(self.norm, x1), _norm_f32(self.norm, x2),
                                 return_vgrid=True, rng=rng)
        return x1 + out, vgrid


class DeformCrossTransMIL(nn.Module):
    """Pathomic fusion MIL block of one branch."""

    def __init__(self, input_path_dim: int, omic_dim: int, n_classes: int = 4,
                 path_dim: int = 128, return_vgrid: bool = True, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_vgrid = return_vgrid
        self.fc1 = Dense(input_path_dim, path_dim, dtype=dtype)
        self.fusion_layer = FusionNet(path_dim, omic_dim, path_dim, dtype=dtype)
        self.layer3 = DeformCrossTransLayer(path_dim, dropout, dtype=dtype)
        self.norm = _layer_norm(path_dim)
        self.pooler = Pooler(path_dim, dtype=dtype)
        self.fc2 = Dense(path_dim, n_classes, dtype=dtype)
        self.multimodal_projection = Dense(path_dim, path_dim, dtype=dtype)

    def forward(self, path: torch.Tensor, omic: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        # a non-square bag raises in layer3 (the masked bag path is not ported yet)
        path = torch.relu(self.fc1(path))                          # (B, N, path_dim)
        h = self.fusion_layer(path, omic)
        h, vgrid = self.layer3(h, path, rng)
        h = self.pooler(_norm_f32(self.norm, h))
        out = {"features": self.multimodal_projection(h), "logits": self.fc2(h)}
        if self.return_vgrid:
            out["omic"] = omic                                     # (B, omic_dim)
            out["vgrid"] = vgrid                                   # (B, g, Hd, Wd, 2)
        return out


class DeformPathomicNet(nn.Module):
    """Flagship model, ``attn_dim=2`` and ``fusion_type='concat'``."""

    def __init__(self, label_dim: int = 4, input_size_omic_tumor: int = 59,
                 input_size_omic_immune: int = 361, input_path_dim: int = 1024,
                 path_dim: int = 128, omic_dim: int = 128,
                 dropout_rate: float = 0.1, return_vgrid: bool = True,
                 task_type: str = "diag2021", init_max: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_vgrid = return_vgrid
        self.task_type = task_type
        for name, gene_dim in (("tumor", input_size_omic_tumor),
                               ("immune", input_size_omic_immune)):
            self.add_module(f"omic_net_{name}",
                            MaxNet(gene_dim, omic_dim, dropout_rate, label_dim,
                                   init_max=init_max, dtype=dtype))
            self.add_module(f"pathomic_net_{name}",
                            DeformCrossTransMIL(input_path_dim, omic_dim, label_dim,
                                                path_dim, return_vgrid, dropout_rate,
                                                dtype=dtype))
        self.classifier = Dense(2 * path_dim, label_dim, dtype=dtype)
        self.classifier_tumor = Dense(path_dim, label_dim, dtype=dtype)
        self.classifier_immune = Dense(path_dim, label_dim, dtype=dtype)

    def forward(self, x_path: torch.Tensor, x_omic_tumor: torch.Tensor,
                x_omic_immune: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        """``rng`` (training mode with dropout_rate > 0) feeds every dropout."""
        if mask is not None:
            raise NotImplementedError("masked (bucketed) deformpathomic bags are not "
                                      "ported yet")
        tumor = self.pathomic_net_tumor(
            x_path, self.omic_net_tumor(x_omic_tumor, rng)["features"], rng)
        immune = self.pathomic_net_immune(
            x_path, self.omic_net_immune(x_omic_immune, rng)["features"], rng)

        features = torch.cat([tumor["features"], immune["features"]], dim=1)
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
