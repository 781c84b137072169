"""Train and eval steps of mode=deformpathomic (counterpart of
``sml_tpu/train/steps.py``: ``make_train_step``, ``modulate_classifier_grads``,
``make_eval_step`` and the deformpathomic branch of ``compute_mode_loss``).
Losses are taken in f32 on the model's outputs.

A train step is the forward in training mode (dropout from the state's
``DropoutRNG``), ``backward``, the gradient modulation of the fused
classifier, then ``optimizer.step()`` and the learning-rate scheduler.  The
JAX classifier kernel is (2*hs, L) and splits by rows; torch's ``weight`` is
(L, 2*hs), so its tumor / immune halves are its columns."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import model_inputs
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.train import losses
from sml_tpu_torch.train.metrics import batch_cindex
from sml_tpu_torch.train.state import TrainState


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
        model.eval()
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


def _branch_ratios(config: Config, model: torch.nn.Module, out: Dict[str, torch.Tensor],
                   labels: torch.Tensor):
    """Per-branch performance ratios from the classifier-weight halves (read
    detached, in f32)."""
    hs = config.mmhid
    weight = model.classifier.weight.detach()                # (L, 2*hs)
    bias = model.classifier.bias.detach()
    out_t = out["vec_tumor"].detach().float() @ weight[:, :hs].T + bias / 2.0
    out_i = out["vec_immune"].detach().float() @ weight[:, hs:].T + bias / 2.0
    if config.task_type == "survival":
        censor, survtime = labels[:, 9], labels[:, 11]
        risk = [-torch.cumprod(1.0 - torch.sigmoid(o), dim=1).sum(dim=1)
                for o in (out_t, out_i)]
        c_t, valid_t = batch_cindex(risk[0], censor, survtime)
        c_i, valid_i = batch_cindex(risk[1], censor, survtime)
        valid = valid_t & valid_i & (c_i > 0)
        ratio_t = torch.where(valid, c_t / c_i.clamp_min(1e-8), 1.0)
    else:
        y = labels[:, losses.TASK_LABEL_SLOT[config.task_type]].long()
        score = lambda o: torch.softmax(o, dim=1).gather(1, y[:, None]).sum()
        valid = torch.ones((), dtype=torch.bool, device=labels.device)
        ratio_t = score(out_t) / score(out_i).clamp_min(1e-12)
    return ratio_t, 1.0 / ratio_t.clamp_min(1e-12), valid


def modulate_classifier_grads(config: Config, model: torch.nn.Module,
                              out: Dict[str, torch.Tensor], labels: torch.Tensor) -> None:
    """Project conflicting per-class gradients of the fused classifier, in
    place on ``model.classifier.weight.grad``.  ``modulation_style='reference'``
    keeps the reference's arithmetic (the projection subtracted twice, then
    renormalized to the once-projected norm); ``'orthogonal'`` is PCGrad."""
    ratio_t, ratio_i, valid = _branch_ratios(config, model, out, labels)
    hs = config.mmhid
    grad = model.classifier.weight.grad                      # (L, 2*hs)
    g_t, g_i = grad[:, :hs], grad[:, hs:]

    def project(g, onto):                                    # per class (row)
        dot = (g * onto).sum(dim=1, keepdim=True)
        proj = dot / (onto * onto).sum(dim=1, keepdim=True).clamp_min(1e-12) * onto
        a = g - proj
        if config.modulation_style == "reference":
            perpen = a - proj
            norm_p = torch.linalg.norm(perpen, dim=1, keepdim=True).clamp_min(1e-12)
            return torch.linalg.norm(a, dim=1, keepdim=True) / norm_p * perpen
        return a

    sim = (g_t * g_i).sum(dim=1) / (torch.linalg.norm(g_t, dim=1)
                                    * torch.linalg.norm(g_i, dim=1)).clamp_min(1e-12)
    conflict = (sim < 0) & valid
    mod_t = conflict & (ratio_t < 1)
    mod_i = conflict & ~(ratio_t < 1) & (ratio_i < 1)
    new_t = torch.where(mod_t[:, None], project(g_t, g_i), g_t)
    new_i = torch.where(mod_i[:, None], project(g_i, g_t), g_i)
    grad.copy_(torch.cat([new_t, new_i], dim=1))


def make_grad_step(config: Config, model: torch.nn.Module
                   ) -> Callable[[Dict[str, Any], Optional[DropoutRNG]], Dict[str, torch.Tensor]]:
    """(batch of device tensors, rng) -> {'loss', 'loss3', 'batch_sim_loss'}
    (detached device scalars), leaving the modulated gradients in ``.grad``."""

    def grad_step(batch: Dict[str, Any], rng: Optional[DropoutRNG]) -> Dict[str, torch.Tensor]:
        model.train()
        model.zero_grad(set_to_none=True)
        labels = batch["labels"]
        out = model(**model_inputs(config, batch), rng=rng)
        total, aux = compute_mode_loss(config, out, labels, train=True)
        total.backward()
        for p in model.parameters():
            # zeros, not None: a parameter the loss does not reach still gets
            # its weight decay and Adam update, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if config.gradient_modulate and config.fusion_type == "concat":
            with torch.no_grad():
                modulate_classifier_grads(config, model, out, labels)
        return {"loss": total.detach(), **{k: v.detach() for k, v in aux.items()}}

    return grad_step


def make_train_step(config: Config, model: torch.nn.Module
                    ) -> Callable[[TrainState, Dict[str, Any]], Dict[str, torch.Tensor]]:
    """(state, batch) -> metrics; updates the state's model, optimizer,
    scheduler and step in place."""
    grad_step = make_grad_step(config, model)

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        metrics = grad_step(batch, state.rng)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return metrics

    return train_step
