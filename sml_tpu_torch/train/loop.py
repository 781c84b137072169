"""Training orchestration (counterpart of ``sml_tpu/train/loop.py``: ``setup``,
``_is_better`` and ``train`` in their single-device, per-step form).

Per epoch: the seeded shuffled train batches, one train step each, then Test
and Val evaluation, the ``epoch i/n val=... test=...`` line, and best-on-val
weights written as ``<checkpoints>/best_modal.npz`` (the flattened flax
parameter tree, which ``python -m sml_tpu_torch.inference --weights`` reads).
The train metrics of an epoch stay on the device and are fetched once, at its
end.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from sml_tpu_torch.bridge import export_flax_params, flatten_params
from sml_tpu_torch.config import Config
from sml_tpu_torch.data.loader import Loader, build_datasets
from sml_tpu_torch.models.factory import define_net, define_optimizer, resolve_device
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.train.evaluate import batch_to_device, evaluate
from sml_tpu_torch.train.state import TrainState
from sml_tpu_torch.train.steps import make_eval_step, make_train_step


def setup(config: Config, device: str | torch.device = "cuda"):
    """(state, train_step, eval_step, (train_loader, val_loader, test_loader))."""
    device = resolve_device(device)
    if device.type == "cuda":
        # f32 products and convolutions in full f32, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    train_loader = Loader(build_datasets(config, "Train"), config.batch_size, shuffle=True,
                          drop_last=True, seed=config.seed)
    test_loader = Loader(build_datasets(config, "Test"), config.batch_size)
    val_loader = (None if config.novalset
                  else Loader(build_datasets(config, "Val"), config.batch_size))
    model = define_net(config, device, train=True)
    optimizer, scheduler = define_optimizer(config, model, max(len(train_loader), 1))
    state = TrainState(model, optimizer, scheduler, DropoutRNG.from_seed(config.seed, device))
    return (state, make_train_step(config, model), make_eval_step(config, model),
            (train_loader, val_loader, test_loader))


def _is_better(config: Config, val: Dict[str, float], best: Dict[str, float]) -> bool:
    if config.task_type == "survival":
        return val["cindex"] > best.get("cindex", 0.0)
    # reference: (val_auc > best_auc) or (val_acc > best_acc)
    return (val["auc"] > best.get("auc", 0.0)) or (val["acc"] > best.get("acc", 0.0))


def save_weights(model: torch.nn.Module, path: str) -> None:
    """The model's parameters as an ``.npz`` of the flattened flax tree."""
    np.savez(path, **flatten_params(export_flax_params(model)))


def train(config: Config, device: str | torch.device = "cuda"
          ) -> Tuple[TrainState, Dict[str, float]]:
    """Train ``config.epochs`` epochs; returns (state, best val metrics + epoch)."""
    os.makedirs(config.checkpoints, exist_ok=True)
    state, train_step, eval_step, (train_loader, val_loader, test_loader) = setup(
        config, device)
    dev = next(state.model.parameters()).device
    best: Dict[str, float] = {}
    start = time.time()
    for epoch in range(config.start_epoch, config.epochs):
        train_loader.set_epoch(epoch)
        step_metrics = []
        for batch in train_loader:
            batch.pop("sample_mask", None)
            step_metrics.append(train_step(state, batch_to_device(config, batch, dev)))
        if step_metrics:
            stacked = {k: torch.stack([m[k] for m in step_metrics]).float().mean().item()
                       for k in step_metrics[0]}
            print(f"epoch {epoch + 1}/{config.epochs} train={stacked}", flush=True)

        test_m = evaluate(config, eval_step, test_loader, dev)
        val_m = evaluate(config, eval_step, val_loader, dev) if val_loader else test_m
        print(f"epoch {epoch + 1}/{config.epochs} val={val_m} test={test_m} "
              f"elapsed_sec={time.time() - start:.1f}", flush=True)
        if _is_better(config, val_m, best):
            best = dict(val_m, epoch=epoch)
            save_weights(state.model, os.path.join(config.checkpoints, "best_modal.npz"))
    return state, best
