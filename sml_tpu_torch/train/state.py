"""Train state of the port (counterpart of ``sml_tpu/train/state.py``): the
model, its optimizer and learning-rate scheduler, the step count and the
dropout generators.  PyTorch updates the model and the optimizer in place, so
the state is a plain container; ``state_dict`` / ``load_state_dict`` carry all
of it (a BatchNorm's running averages with the model's parameters), for
``train/checkpoint.py``.  A loaded state takes the learning rate of its next
update from its own scheduler, as the JAX schedule is a function of the
update count: a run resumed with more ``epochs`` follows the new schedule."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from sml_tpu_torch.ops.common import DropoutRNG


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    rng: DropoutRNG
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step,
                "rng": self.rng.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        sched = self.scheduler
        for group, base, fn in zip(self.optimizer.param_groups, sched.base_lrs,
                                   sched.lr_lambdas):
            group["lr"] = base * fn(sched.last_epoch)
        self.step = int(state["step"])
        self.rng.set_state(state["rng"])
