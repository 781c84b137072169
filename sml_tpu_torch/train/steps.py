"""Train and eval steps of the ported modes (counterpart of
``sml_tpu/train/steps.py``: ``make_train_step``, ``modulate_classifier_grads``
(deformpathomic with concat fusion only), ``make_eval_step`` and
``compute_mode_loss`` for every mode, with every ``survival_loss`` and CMTA's
alignment term).  Losses are taken in f32 on the model's outputs.

A train step is the forward in training mode (dropout from the state's
``DropoutRNG``; a BatchNorm normalizes by the batch and moves its running
averages, as the JAX step's mutable ``batch_stats``), ``backward``, the
gradient modulation of the fused classifier, then ``optimizer.step()`` and
the learning-rate scheduler.  The eval step runs the model in eval mode (the
BatchNorms' running averages).  The JAX classifier kernel is (2*hs, L) and
splits by rows; torch's ``weight`` is (L, 2*hs), so its tumor / immune halves
are its columns.

Several data ranks (``parallel/mesh.py``): as under the JAX package's jit,
every loss sees the global batch.  Each rank gathers the model's outputs and
the labels of the whole batch over its data group (the backward hands it the
gradient of its own rows), every rank computes the same global loss, the
gradients are summed over the data group, then modulated, so every rank takes
the same update.  The eval step gathers the same way and returns the global
batch's outputs and loss."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sml_tpu_torch.config import Config
from sml_tpu_torch.models.factory import model_inputs
from sml_tpu_torch.ops.common import DropoutRNG
from sml_tpu_torch.parallel.mesh import gather_outputs, make_grid, sum_grads
from sml_tpu_torch.train import losses
from sml_tpu_torch.train.metrics import batch_cindex
from sml_tpu_torch.train.state import TrainState


def _survival_loss(config: Config, hazards: torch.Tensor, s: torch.Tensor,
                   labels: torch.Tensor, sample_mask=None) -> torch.Tensor:
    """``nll_surv`` (and its ``nll_surv_*`` variants) and ``ce_surv`` on the
    hazards; ``cox_surv`` ranks the risk -sum(S)."""
    name = config.survival_loss
    y, c = labels[:, 8], labels[:, 9]
    if name == "ce_surv":
        return losses.ce_surv_loss(hazards, s, y, c, alpha=0.0, sample_mask=sample_mask)
    if name == "cox_surv":
        return losses.cox_loss(labels[:, 11], 1.0 - c, -s.sum(dim=1), sample_mask=sample_mask)
    if name == "nll_surv" or name.startswith("nll_surv_"):
        return losses.nll_surv_loss(hazards, s, y, c, alpha=0.0, sample_mask=sample_mask)
    raise ValueError(f"unknown survival_loss {name!r}")


def _cmta_alignment(config: Config, out: Dict[str, torch.Tensor],
                    sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CMTA's alignment of the decoders' cls tokens with the (detached)
    encoders': L1 by default, or the auxiliary loss a ``survival_loss``
    variant ``nll_surv_{kl,mse,l1,cos,ol}`` names."""
    p, p_hat, g, g_hat = (out[k].float() for k in ("P", "P_hat", "G", "G_hat"))
    name = config.survival_loss if config.task_type == "survival" else "nll_surv"
    if name == "nll_surv_ol":
        return losses._masked_mean(losses.orthogonal_loss(p, p_hat, g, g_hat, gamma=0.5),
                                   sample_mask)
    pair = {
        "nll_surv_kl": lambda a, b: losses.kl_loss(a, b, sample_mask=sample_mask),
        "nll_surv_mse": lambda a, b: losses._masked_mean((a - b) ** 2, sample_mask),
        "nll_surv_cos": lambda a, b: losses._masked_mean(losses.cosine_loss(a, b),
                                                         sample_mask),
    }.get(name, lambda a, b: losses.l1_loss(a, b, sample_mask=sample_mask))
    return 0.5 * (pair(p.detach(), p_hat) + pair(g.detach(), g_hat))


def _hazards_and_s(config: Config, out: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hazards, S) in f32: the model's own where it returns them (mcat,
    cmta), else from the logits (deformpathomic's logits are hazards)."""
    logits = out["logits"].float()
    if "hazards" in out:
        return out["hazards"].float(), out["S"].float()
    hazards = logits if config.mode == "deformpathomic" else torch.sigmoid(logits)
    return hazards, torch.cumprod(1.0 - hazards, dim=1)


def ddp_world(config: Config) -> int:
    """w of ``batchloss_grad_scale='ddp'``: ``num_devices``, else every rank of
    the grid, seq ranks included (the JAX mesh's devices).  Under several ranks
    the launch fixes the devices, so another ``num_devices`` raises."""
    world = make_grid(config.seq_devices).world
    if world > 1 and config.num_devices not in (0, world):
        raise ValueError(f"num_devices={config.num_devices} under {world} ranks: the "
                         "launch fixes the devices (set 0 or the number of ranks)")
    return max(config.num_devices or world, 1)


def compute_mode_loss(config: Config, out: Dict[str, torch.Tensor],
                      labels: torch.Tensor, train: bool = True,
                      sample_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss: the task loss, or for survival the survival loss (on the
    model's hazards and S for mcat and cmta, else from the logits).
    ``mode=cmta`` adds the alignment term; ``mode=deformpathomic`` adds, with
    ``return_vgrid``, the mean of the two branches' batch-similarity losses.
    With ``batchloss_grad_scale='ddp'`` that term keeps its full value and its
    gradient is scaled by 1/w, w = ``num_devices``, else the number of ranks
    (``ddp_world``): the reference's GatherLayer over w processes."""
    if config.task_type == "survival":
        hazards, s = _hazards_and_s(config, out)
        loss3 = _survival_loss(config, hazards, s, labels, sample_mask)
    else:
        loss3 = losses.task_loss(out["logits"].float(), labels, config.task_type,
                                 train=train, sample_mask=sample_mask)
    aux = {"loss3": loss3}
    total = loss3
    if config.mode == "cmta":
        aux["alignment_loss"] = _cmta_alignment(config, out, sample_mask)
        total = loss3 + aux["alignment_loss"]
    if config.mode == "deformpathomic" and config.return_vgrid:
        bs = [losses.batch_similarity_loss(out[f"omic_{b}"].float(),
                                           out[f"vgrid_{b}"].float(),
                                           sample_mask=sample_mask,
                                           layout=config.batchloss_layout)
              for b in ("tumor", "immune")]
        batch_sim = 0.5 * bs[0] + 0.5 * bs[1]
        if config.batchloss_grad_scale == "ddp":
            w = ddp_world(config)
            batch_sim = batch_sim / w + (batch_sim * (1.0 - 1.0 / w)).detach()
        aux["batch_sim_loss"] = batch_sim
        total = loss3 + batch_sim
    return total, aux


def make_eval_step(config: Config, model: torch.nn.Module
                   ) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """(batch of device tensors) -> per-sample ``risk`` or ``probs``, and ``loss``
    over the rows that ``sample_mask`` marks as real.  Under several data ranks
    the batch is this rank's slice of a global batch, and the outputs and the
    loss are the global batch's."""
    grid = make_grid(config.seq_devices)

    @torch.inference_mode()
    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.eval()
        out = model(**model_inputs(config, batch))
        if grid.active:
            out = gather_outputs(out, grid)
            batch = gather_outputs({k: batch[k] for k in ("labels", "sample_mask")
                                    if k in batch}, grid)
        logits = out["logits"].float()
        result: Dict[str, torch.Tensor] = {}
        if config.task_type == "survival":
            result["risk"] = -_hazards_and_s(config, out)[1].sum(dim=1)
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
    (detached device scalars), leaving the modulated gradients in ``.grad``.
    Under several data ranks the batch is this rank's local batch and the
    loss, its gradients and their modulation are the global batch's."""
    grid = make_grid(config.seq_devices)

    def grad_step(batch: Dict[str, Any], rng: Optional[DropoutRNG]) -> Dict[str, torch.Tensor]:
        model.train()
        model.zero_grad(set_to_none=True)
        labels = batch["labels"]
        out = model(**model_inputs(config, batch), rng=rng)
        if grid.active:
            out = gather_outputs(out, grid, differentiable=True)
            labels = gather_outputs({"labels": labels}, grid)["labels"]
        total, aux = compute_mode_loss(config, out, labels, train=True)
        total.backward()
        for p in model.parameters():
            # zeros, not None: a parameter the loss does not reach still gets
            # its weight decay and Adam update, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sum_grads(model, grid)
        if (config.mode == "deformpathomic" and config.gradient_modulate
                and config.fusion_type == "concat"):
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


def make_epoch_loop(config: Config, model: torch.nn.Module
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """(state, stacked batches) -> stacked metrics: one train step for each
    slice [i] along the stack's leading dimension (counterpart of
    ``make_epoch_scan``, whose ``lax.scan`` becomes this Python loop over the
    train step: the same kernels launch as in per-step training, as often).
    The metrics stay on the device, (steps,) per key; nothing waits for the
    device inside."""
    train_step = make_train_step(config, model)

    def epoch_loop(state: TrainState, batches: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        lengths = {k: v.shape[0] for k, v in batches.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"stacked batches of unequal lengths {lengths}")
        metrics = [train_step(state, {k: v[i] for k, v in batches.items()})
                   for i in range(next(iter(lengths.values())))]
        return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return epoch_loop
