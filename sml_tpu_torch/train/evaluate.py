"""Evaluation loop (counterpart of ``sml_tpu/train/evaluate.py``).

Every batch is enqueued first and the outputs are fetched once at the end.
Quality metrics and the per-batch loss count exactly the real samples: the
``sample_mask`` rides into the eval step, so the padded tail rows of the final
batch contribute nothing.  Under several data ranks every rank holds each
global eval batch, runs the eval step on its own rows (``shard_batch``) and
gets back the global batch's outputs, so every rank computes the same metrics.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import feature_dtype
from sml_tpu_torch.parallel.mesh import make_grid, shard_batch
from sml_tpu_torch.train.losses import TASK_LABEL_SLOT
from sml_tpu_torch.train.metrics import cindex, compute_avg_metrics


def batch_to_device(config: Config, batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> device tensors; x_path is cast to the feature dtype on the
    host first, so only those bytes cross to the device (``cast_features``).
    A field that is already a tensor on ``device`` (a raw patch bag decoded
    there) stays there, x_path cast in place of the copy."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        if k == "x_path":
            t = t.to(feature_dtype(config))
        out[k] = t.to(device)
    return out


def stack_to_device(config: Config, batches: List[Dict[str, np.ndarray]],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batches -> one (len(batches), ...) tensor per field on ``device``
    (counterpart of ``shard_stacked_batches`` on one device), x_path cast to
    the feature dtype on the host.  Each batch's field is cast and copied in
    one pass into its slot of the stack, which on a card lies in pinned
    memory; the stack is then copied to the card once, on a side stream, so
    that the copy of the next chunk runs while the current one computes.  The
    current stream waits for the copy before it reads the chunk, and
    ``record_stream`` keeps the allocator from handing a chunk's memory out
    again before the current stream is done with it.  On the CPU the stacked
    tensors are returned as they are."""
    pin = device.type == "cuda"
    host = {}
    for k in batches[0]:
        fields = [torch.from_numpy(np.asarray(b[k])) for b in batches]
        dtype = feature_dtype(config) if k == "x_path" else fields[0].dtype
        host[k] = torch.empty((len(fields), *fields[0].shape), dtype=dtype, pin_memory=pin)
        for slot, field in zip(host[k], fields):
            slot.copy_(field)
    if not pin:
        return host
    stream = torch.cuda.Stream(device)              # one of torch's pooled streams
    with torch.cuda.stream(stream):
        out = {k: t.to(device, non_blocking=True) for k, t in host.items()}
    compute = torch.cuda.current_stream(device)
    compute.wait_stream(stream)
    for t in out.values():
        t.record_stream(compute)
    return out


def evaluate(config: Config, eval_step: Callable, loader,
             device: torch.device) -> Dict[str, float]:
    """One pass; returns {'loss', 'cindex'} (survival) or the loss and the seven
    classification metrics (acc, f1, auc, bac, sens, spec, prec)."""
    grid = make_grid(config.seq_devices)
    outs, host_labels, host_masks = [], [], []
    for batch in loader:
        outs.append(eval_step(batch_to_device(config, shard_batch(batch, grid), device)))
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
