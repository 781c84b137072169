"""Two-modality pathomic fusion baselines (counterpart of
``sml_tpu/models/pathomic.py``: ``PathomicNet``, ``PathomicNetOriginal``).

A path vector (ABMIL over the bag, or a Dense of the mean-pooled bag) and an
omic vector (MaxNet of the full gene vector) are combined by ``fusion_type``:
concat, add (their sum), or anything else through ``BilinearFusion`` with the
path / omic gates; ``cut_fuse_grad`` stops the gradient into both vectors
there.  A Dense classifier reads the combination.  Neither model takes a bag
mask, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sml_tpu_torch.models.maxnet import MaxNet
from sml_tpu_torch.models.mil import ABMIL
from sml_tpu_torch.ops.common import Dense, DropoutRNG
from sml_tpu_torch.ops.fusion import BilinearFusion


def fused_width(fusion_type: str, dim1: int, dim2: int, mmhid: int) -> int:
    """Width of the combined vector: dim1 + dim2 (concat), dim1 (add: dim1 ==
    dim2), else BilinearFusion's mmhid."""
    if fusion_type == "concat":
        return dim1 + dim2
    return dim1 if fusion_type == "add" else mmhid


class _Pathomic(nn.Module):
    """The omic branch, the fusion and the classifier of both models."""

    def __init__(self, label_dim: int, input_size_omic: int, path_dim: int, omic_dim: int,
                 mmhid: int, dropout_rate: float, fusion_type: str, cut_fuse_grad: bool,
                 skip: int, use_bilinear: int, gate1: int, gate2: int, path_scale: int,
                 omic_scale: int, init_max: bool, dtype: torch.dtype):
        super().__init__()
        self.fusion_type, self.cut_fuse_grad = fusion_type, cut_fuse_grad
        self.omic_net = MaxNet(input_size_omic, omic_dim, dropout_rate, label_dim,
                               init_max=init_max, dtype=dtype)
        if fusion_type not in ("concat", "add"):
            self.fusion = BilinearFusion(skip, use_bilinear, gate1, gate2, path_dim,
                                         omic_dim, path_scale, omic_scale, mmhid,
                                         dropout_rate, dtype=dtype)
        self.classifier = Dense(fused_width(fusion_type, path_dim, omic_dim, mmhid),
                                label_dim, dtype=dtype)

    def _combine(self, v1: torch.Tensor, v2: torch.Tensor,
                 rng: Optional[DropoutRNG]) -> torch.Tensor:
        if self.cut_fuse_grad:
            v1, v2 = v1.detach(), v2.detach()
        if self.fusion_type == "concat":
            return torch.cat([v1, v2], dim=1)
        if self.fusion_type == "add":
            return v1 + v2
        return self.fusion(v1, v2, rng)

    def _head(self, path_vec: torch.Tensor, logits_path: torch.Tensor,
              x_omic: torch.Tensor, rng: Optional[DropoutRNG]) -> Dict[str, torch.Tensor]:
        omic = self.omic_net(x_omic, rng)
        features = self._combine(path_vec, omic["features"], rng)
        return {"features": features, "path_vec": path_vec, "omic_vec": omic["features"],
                "logits_path": logits_path, "logits_omic": omic["logits"],
                "logits": self.classifier(features)}


class PathomicNet(_Pathomic):
    """ABMIL (path) + MaxNet (omic) + fusion head."""

    def __init__(self, label_dim: int = 4, input_size_omic: int = 431,
                 input_path_dim: int = 1024, path_dim: int = 128, omic_dim: int = 128,
                 mmhid: int = 128, dropout_rate: float = 0.25, fusion_type: str = "concat",
                 cut_fuse_grad: bool = False, skip: int = 0, use_bilinear: int = 1,
                 gate1: int = 1, gate2: int = 1, path_scale: int = 1, omic_scale: int = 1,
                 init_max: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(label_dim, input_size_omic, path_dim, omic_dim, mmhid,
                         dropout_rate, fusion_type, cut_fuse_grad, skip, use_bilinear,
                         gate1, gate2, path_scale, omic_scale, init_max, dtype)
        self.path_net = ABMIL(label_dim, path_dim, input_path_dim, dtype=dtype)

    def forward(self, x_path: torch.Tensor, x_omic: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        path = self.path_net(x_path)
        return self._head(path["features"], path["logits"], x_omic, rng)


class PathomicNetOriginal(_Pathomic):
    """Mean-pooled path branch: ``path_net`` and ``path_classifier`` are Dense
    layers of the bag's mean patch.  The JAX package applies
    ``path_classifier`` to the pooled bag (its deliberate fix of the
    reference, which applies it to the raw 3-D bag); so does this one."""

    def __init__(self, label_dim: int = 4, input_size_omic: int = 431,
                 input_path_dim: int = 1024, path_dim: int = 128, omic_dim: int = 128,
                 mmhid: int = 128, dropout_rate: float = 0.25, fusion_type: str = "concat",
                 cut_fuse_grad: bool = False, skip: int = 0, use_bilinear: int = 1,
                 gate1: int = 1, gate2: int = 1, path_scale: int = 1, omic_scale: int = 1,
                 init_max: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(label_dim, input_size_omic, path_dim, omic_dim, mmhid,
                         dropout_rate, fusion_type, cut_fuse_grad, skip, use_bilinear,
                         gate1, gate2, path_scale, omic_scale, init_max, dtype)
        self.path_net = Dense(input_path_dim, path_dim, dtype=dtype)
        self.path_classifier = Dense(input_path_dim, label_dim, dtype=dtype)

    def forward(self, x_path: torch.Tensor, x_omic: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> Dict[str, torch.Tensor]:
        pooled = x_path.mean(dim=1)                                # (B, input_path_dim)
        return self._head(self.path_net(pooled), self.path_classifier(pooled), x_omic, rng)
