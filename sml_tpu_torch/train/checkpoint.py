"""Checkpoints of the port (counterpart of ``sml_tpu/train/checkpoint.py``,
without orbax).

The whole train state (``TrainState.state_dict``: the model's parameters and
BatchNorm statistics, the optimizer's and the scheduler's state, the step and
both dropout generators) is one ``torch.save`` file, ``last_state.pt``,
written to a temporary name and moved into place; it loads with
``weights_only=True``.  Beside it, ``last_state_meta.json`` holds what lives on
the host (the epoch just finished, the iteration count, the best Val metrics,
the plateau controller), with the JAX package's keys.  Weights-only snapshots
stay the ``.npz`` of ``train/loop.py:save_weights``; the per-epoch best takes
the reference's metric-bearing name from ``best_checkpoint_name``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from sml_tpu_torch.train.state import TrainState

LAST_STATE = "last_state.pt"
RESUME_META = "last_state_meta.json"


def _replace(path: str, write) -> None:
    """``write(tmp)``, then move ``tmp`` onto ``path`` in one step."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_train_state(path: str, state: TrainState) -> None:
    _replace(path, lambda tmp: torch.save(state.state_dict(), tmp))


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load ``path`` into ``state`` (built as the saved run built it); returns it."""
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state


def save_resume_meta(checkpoints_dir: str, meta: Dict[str, Any]) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _replace(os.path.join(checkpoints_dir, RESUME_META), write)


def load_resume_meta(checkpoints_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(checkpoints_dir, RESUME_META)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def has_resume_state(checkpoints_dir: str) -> bool:
    return os.path.isfile(os.path.join(checkpoints_dir, LAST_STATE))


def best_checkpoint_name(checkpoints_dir: str, epoch: int, task_type: str,
                         test_metrics: dict) -> str:
    """The reference's name of an epoch's best weights (``train_test.py:270-285``)."""
    if task_type == "survival":
        name = f"epoch_{epoch + 1:d}_cindex_{test_metrics['cindex']:f}_"
    else:
        name = (f"epoch_{epoch + 1:d}_AUC_{test_metrics['auc']:f}"
                f"_ACC_{test_metrics['acc']:f}_Sens_{test_metrics['sens']:f}"
                f"_Spec_{test_metrics['spec']:f}_F1_{test_metrics['f1']:f}_")
    return os.path.join(checkpoints_dir, name)
