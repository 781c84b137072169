"""Evaluation loop (counterpart of ``sml_tpu/train/evaluate.py``, without a mesh).

Every batch is enqueued first and the outputs are fetched once at the end.
Quality metrics and the per-batch loss count exactly the real samples: the
``sample_mask`` rides into the eval step, so the padded tail rows of the final
batch contribute nothing.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import feature_dtype
from sml_tpu_torch.train.losses import TASK_LABEL_SLOT
from sml_tpu_torch.train.metrics import cindex, compute_avg_metrics


def batch_to_device(config: Config, batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> device tensors; x_path is cast to the feature dtype on the
    host first, so only those bytes cross to the device (``cast_features``)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if k == "x_path":
            t = t.to(feature_dtype(config))
        out[k] = t.to(device)
    return out


def evaluate(config: Config, eval_step: Callable, loader,
             device: torch.device) -> Dict[str, float]:
    """One pass; returns {'loss', 'cindex'} (survival) or the loss and the seven
    classification metrics (acc, f1, auc, bac, sens, spec, prec)."""
    outs, host_labels, host_masks = [], [], []
    for batch in loader:
        outs.append(eval_step(batch_to_device(config, batch, device)))
        host_labels.append(np.asarray(batch["labels"]))
        host_masks.append(np.asarray(batch["sample_mask"]))
    outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]

    risks, probs, labels, losses_ = [], [], [], []
    for out, lab, mask in zip(outs, host_labels, host_masks):
        valid = mask > 0
        labels.append(lab[valid])
        if "risk" in out:
            risks.append(out["risk"][valid])
        else:
            probs.append(out["probs"][valid])
        losses_.append(float(out["loss"]))

    labels = np.concatenate(labels, axis=0)
    result: Dict[str, float] = {"loss": float(np.mean(losses_))}
    if config.task_type == "survival":
        risk = np.concatenate(risks, axis=0)
        result["cindex"] = float(cindex(risk, labels[:, 9], labels[:, 11]))
        return result
    gt = labels[:, TASK_LABEL_SLOT[config.task_type]]
    names = ("acc", "f1", "auc", "bac", "sens", "spec", "prec")
    values = compute_avg_metrics(gt, np.concatenate(probs, axis=0))
    result.update({k: float(v) for k, v in zip(names, values)})
    return result
