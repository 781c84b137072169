"""Train state of the port (counterpart of ``sml_tpu/train/state.py``): the
model, its optimizer and learning-rate scheduler, the step count and the
dropout generators.  PyTorch updates the model and the optimizer in place, so
the state is a plain container."""

from __future__ import annotations

import dataclasses

import torch

from sml_tpu_torch.ops.common import DropoutRNG


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    rng: DropoutRNG
    step: int = 0
