"""Eval step of the deformpathomic serving path (counterpart of
``sml_tpu/train/steps.py``: ``make_eval_step`` and the deformpathomic branch of
``compute_mode_loss``).  Losses are taken in f32 on the model's outputs."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import model_inputs
from sml_tpu_torch.train import losses


def _survival_loss(config: Config, hazards: torch.Tensor, s: torch.Tensor,
                   labels: torch.Tensor, sample_mask=None) -> torch.Tensor:
    name = config.survival_loss
    if name == "nll_surv" or name.startswith("nll_surv_"):
        return losses.nll_surv_loss(hazards, s, labels[:, 8], labels[:, 9], alpha=0.0,
                                    sample_mask=sample_mask)
    raise NotImplementedError(f"survival_loss {name!r} is not ported yet")


def compute_mode_loss(config: Config, out: Dict[str, torch.Tensor],
                      labels: torch.Tensor, train: bool = True,
                      sample_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss of ``mode=deformpathomic``: the task loss plus, with
    ``return_vgrid``, the mean of the two branches' batch-similarity losses.
    (``batchloss_grad_scale`` only rescales the gradient, not this value.)"""
    if config.mode != "deformpathomic":
        raise NotImplementedError(f"mode {config.mode!r} is not ported yet")
    main = out["logits"].float()
    if config.task_type == "survival":
        # the model applied the sigmoid: logits are hazards
        loss3 = _survival_loss(config, main, torch.cumprod(1.0 - main, dim=1), labels,
                               sample_mask)
    else:
        loss3 = losses.task_loss(main, labels, config.task_type, train=train,
                                 sample_mask=sample_mask)
    aux = {"loss3": loss3}
    total = loss3
    if config.return_vgrid:
        bs = [losses.batch_similarity_loss(out[f"omic_{b}"].float(),
                                           out[f"vgrid_{b}"].float(),
                                           sample_mask=sample_mask,
                                           layout=config.batchloss_layout)
              for b in ("tumor", "immune")]
        aux["batch_sim_loss"] = 0.5 * bs[0] + 0.5 * bs[1]
        total = loss3 + aux["batch_sim_loss"]
    return total, aux


def make_eval_step(config: Config, model: torch.nn.Module
                   ) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """(batch of device tensors) -> per-sample ``risk`` or ``probs``, and ``loss``
    over the rows that ``sample_mask`` marks as real."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = model(**model_inputs(config, batch))
        logits = out["logits"].float()
        result: Dict[str, torch.Tensor] = {}
        if config.task_type == "survival":
            result["risk"] = -torch.cumprod(1.0 - logits, dim=1).sum(dim=1)
        else:
            result["probs"] = torch.softmax(logits, dim=1)
        result["loss"], _ = compute_mode_loss(config, out, batch["labels"], train=False,
                                              sample_mask=batch.get("sample_mask"))
        return result

    return eval_step
