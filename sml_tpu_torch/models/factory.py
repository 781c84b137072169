"""Model and optimizer factory for ``mode=deformpathomic`` (counterpart of
``sml_tpu/models/factory.py``: ``define_net``, ``model_inputs``,
``make_lr_schedule``, ``define_optimizer``).

The JAX factory turns its kernels off unless the backend is a TPU; the port
has no such switch: its kernel wrappers launch their CUDA kernels whenever the
tensors are on ``cuda``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

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
               seed: int | None = None, train: bool = False) -> nn.Module:
    """The model on ``device`` in eval mode (``train=True``: training mode),
    seeded-initialized from ``seed`` (default ``config.seed``); parameters stay
    float32."""
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
    return model.to(device).train(train)


def model_inputs(config: Config, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: batch[k] for k in MODE_INPUTS[config.mode]}


def make_lr_schedule(config: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of update ``k`` (from 0): torch's per-epoch schedulers as a
    function of the step count, ``lr * mult(k // steps_per_epoch)``."""
    lr0, policy, epochs = config.lr, config.lr_policy, config.epochs
    if policy == "cosine":
        def mult(epoch: int) -> float:
            return 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))
    elif policy == "none":
        def mult(epoch: int) -> float:
            return 1.0
    else:
        raise NotImplementedError(f"lr_policy {policy!r} is not ported yet")

    def schedule(k: int) -> float:
        return lr0 * mult(k // max(steps_per_epoch, 1))

    return schedule


def define_optimizer(config: Config, model: nn.Module, steps_per_epoch: int = 1
                     ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """Adam with coupled L2 (``weight_decay`` added to the gradient before the
    moments, as ``optax.add_decayed_weights`` before ``scale_by_adam``) and the
    per-step ``make_lr_schedule``; call ``scheduler.step()`` after every
    ``optimizer.step()``."""
    if config.optimizer != "adam":
        raise NotImplementedError(f"optimizer {config.optimizer!r} is not ported yet")
    optimizer = torch.optim.Adam(model.parameters(), lr=config.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=config.weight_decay)
    schedule = make_lr_schedule(config, steps_per_epoch)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: schedule(k) / config.lr)
    return optimizer, scheduler
