"""Model factory for ``mode=deformpathomic`` (counterpart of
``sml_tpu/models/factory.py:define_net`` / ``model_inputs``).

The JAX factory turns its kernels off unless the backend is a TPU; the port
has no such switch: its kernel wrappers launch their CUDA kernels whenever the
tensors are on ``cuda``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from sml_tpu_torch.config import Config
from sml_tpu_torch.models.deform import DeformPathomicNet
from sml_tpu_torch.ops.common import dtype_of, init_params

MODE_INPUTS = {"deformpathomic": ("x_path", "x_omic_tumor", "x_omic_immune")}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device asked for; asking for cuda without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def compute_dtype(config: Config) -> torch.dtype:
    return dtype_of(config.compute_dtype)


def feature_dtype(config: Config) -> torch.dtype:
    """dtype of the WSI feature bags (x_path) in transfer; auto = compute dtype."""
    name = config.compute_dtype if config.feature_dtype == "auto" else config.feature_dtype
    return dtype_of(name)


def define_net(config: Config, device: str | torch.device = "cuda",
               seed: int | None = None) -> nn.Module:
    """The eval-mode model on ``device``, seeded-initialized from ``seed``
    (default ``config.seed``); parameters stay float32."""
    if config.mode != "deformpathomic":
        raise NotImplementedError(f"mode {config.mode!r} is not ported yet")
    if config.attn_dim != 2 or config.fusion_type != "concat":
        raise NotImplementedError("the port runs attn_dim=2 with concat fusion only")
    if config.init_type not in ("max", "none"):
        raise NotImplementedError(f"init_type {config.init_type!r} is not ported yet")
    device = resolve_device(device)
    model = DeformPathomicNet(
        label_dim=config.label_dim,
        input_size_omic_tumor=config.input_size_omic_tumor,
        input_size_omic_immune=config.input_size_omic_immune,
        input_path_dim=config.input_path_dim, path_dim=config.path_dim,
        omic_dim=config.omic_dim, dropout_rate=config.dropout_rate,
        return_vgrid=config.return_vgrid, task_type=config.task_type,
        init_max=config.init_type == "max", dtype=compute_dtype(config))
    init_params(model, config.seed if seed is None else seed)
    return model.to(device).eval()


def model_inputs(config: Config, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: batch[k] for k in MODE_INPUTS[config.mode]}
