"""The loss zoo (counterpart of ``sml_tpu/train/losses.py``): class-weighted
cross entropy, the discrete-hazard survival NLL and cross entropy, the Cox
partial likelihood, the subspace batch-similarity loss, and CMTA's alignment
losses (L1, KL, cosine, subspace orthogonality), each with the eval
``sample_mask`` that excludes the wrap-padded rows of the final batch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# class weights, reference train_test.py:25-27 (train) and :465,533 (test)
TASK_WEIGHTS_TRAIN = {
    "diag2021": (1.0, 4.15, 2.93, 2.43),
    "grade": (1.47, 1.51, 1.0),
    "subtype": (1.0, 1.72, 2.43),
}
TASK_WEIGHTS_TEST = {
    "diag2021": (1.0, 4.56, 3.21, 2.65),
    "grade": None,
    "subtype": None,
}
# label-vector slot per task (reference data/dataset.py:523)
TASK_LABEL_SLOT = {"diag2021": 5, "grade": 4, "subtype": 7}


def _masked_mean(x: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over valid samples (axis 0); ``x.mean()`` when mask is None."""
    if sample_mask is None:
        return x.mean()
    per_row = x.reshape(x.shape[0], -1).mean(dim=1)
    m = sample_mask.to(per_row.dtype)
    return (per_row * m).sum() / m.sum().clamp_min(1.0)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights=None,
                           sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``nn.CrossEntropyLoss`` semantics: weighted mean normalized by the sum
    of the per-target weights."""
    y = labels.long()
    nll = -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]
    if weights is None:
        return _masked_mean(nll, sample_mask)
    w = torch.as_tensor(weights, dtype=logits.dtype, device=logits.device)[y]
    if sample_mask is not None:
        w = w * sample_mask.to(w.dtype)
    return (w * nll).sum() / w.sum().clamp_min(1e-12)


def nll_surv_loss(hazards: torch.Tensor, s: Optional[torch.Tensor], y: torch.Tensor,
                  c: torch.Tensor, alpha: float = 0.4, eps: float = 1e-7,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Discrete-hazard NLL with censoring; hazards (B, K) in (0, 1), y (B,) bin,
    c (B,) censorship (1 = alive)."""
    y = y.long()[:, None]
    c = c.to(hazards.dtype)[:, None]
    if s is None:
        s = torch.cumprod(1.0 - hazards, dim=1)
    s_padded = torch.cat([torch.ones_like(c), s], dim=1)
    uncensored = -(1.0 - c) * (torch.log(s_padded.gather(1, y).clamp_min(eps))
                               + torch.log(hazards.gather(1, y).clamp_min(eps)))
    censored = -c * torch.log(s_padded.gather(1, y + 1).clamp_min(eps))
    loss = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    return _masked_mean(loss, sample_mask)


def ce_surv_loss(hazards: torch.Tensor, s: Optional[torch.Tensor], y: torch.Tensor,
                 c: torch.Tensor, alpha: float = 0.4, eps: float = 1e-7,
                 sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy survival loss on S at the event bin, with the NLL's
    uncensored term as a regulariser weighted ``alpha``."""
    y = y.long()[:, None]
    c = c.to(hazards.dtype)[:, None]
    if s is None:
        s = torch.cumprod(1.0 - hazards, dim=1)
    s_padded = torch.cat([torch.ones_like(c), s], dim=1)
    reg = -(1.0 - c) * (torch.log(s_padded.gather(1, y) + eps)
                        + torch.log(hazards.gather(1, y).clamp_min(eps)))
    s_y = s.gather(1, y)
    ce_l = -c * torch.log(s_y.clamp_min(eps)) - (1.0 - c) * torch.log((1.0 - s_y).clamp_min(eps))
    return _masked_mean((1.0 - alpha) * ce_l + alpha * reg, sample_mask)


def cox_loss(survtime: torch.Tensor, censor: torch.Tensor, hazard_pred: torch.Tensor,
             sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative Cox partial log-likelihood of the risk ``hazard_pred`` (B,);
    ``censor`` is 1 for an observed event.  The risk set of sample i is every
    (valid) j with survtime_j >= survtime_i."""
    r_mat = (survtime[None, :] >= survtime[:, None]).to(hazard_pred.dtype)
    theta = hazard_pred.reshape(-1)
    if sample_mask is not None:
        r_mat = r_mat * sample_mask.to(r_mat.dtype)[None, :]
    ll = (theta - torch.log((theta.exp() * r_mat).sum(dim=1).clamp_min(1e-30))) * censor
    return -_masked_mean(ll, sample_mask)


def l1_loss(a: torch.Tensor, b: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean((a - b).abs(), sample_mask)


def kl_loss(y: torch.Tensor, y_hat: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``F.kl_div(y_hat.softmax().log(), y.softmax(), reduction='sum')``
    over the valid rows."""
    p = torch.softmax(y, dim=-1)
    per_row = (p * (torch.log(p.clamp_min(1e-12)) - F.log_softmax(y_hat, dim=-1))).sum(dim=-1)
    if sample_mask is not None:
        per_row = per_row * sample_mask.to(per_row.dtype)
    return per_row.sum()


def _cos(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity, the norms' product floored at ``eps``."""
    den = torch.linalg.norm(a, dim=1) * torch.linalg.norm(b, dim=1)
    return (a * b).sum(dim=1) / den.clamp_min(eps)


def cosine_loss(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    return 1.0 - _cos(y, y_hat)


def orthogonal_loss(p: torch.Tensor, p_hat: torch.Tensor, g: torch.Tensor,
                    g_hat: torch.Tensor, gamma: float = 0.5) -> torch.Tensor:
    """Per-row subspace orthogonality loss: each translated token aligned with
    its (detached) source, the two modalities and the crossed pairs pushed
    apart, weighted ``gamma``."""
    pd, gd = p.detach(), g.detach()
    pos = (1.0 - _cos(pd, p_hat).abs()) + (1.0 - _cos(gd, g_hat).abs())
    neg = _cos(p, g).abs() + _cos(pd, g_hat).abs() + _cos(gd, p_hat).abs()
    return pos + gamma * neg


def batch_similarity_loss(omic: torch.Tensor, vgrid: torch.Tensor,
                          sample_mask: Optional[torch.Tensor] = None,
                          layout: str = "group") -> torch.Tensor:
    """Subspace batch-similarity loss, summed.

    omic (N, F) per-sample omic vectors; vgrid (N, g, ...) offset grids.
    ``layout='group'``: similarity per offset group over the batch, averaged
    over groups.  ``layout='reference'``: the reference's ``vgrid.view(8, N, -1)``
    row blocks (needs g == 8).  With ``sample_mask`` the padded rows and
    columns drop out, as if computed on the valid rows alone.
    """
    n = omic.shape[0]
    omic2 = omic.reshape(n, -1)
    g = vgrid.shape[1]
    if layout == "reference":
        if g != 8:
            raise ValueError(f"batchloss_layout='reference' replicates the reference's "
                             f"vgrid.view(8, N, -1) and needs offset_groups == 8 (got {g})")
        v = vgrid.reshape(n * g, -1).reshape(8, n, -1)
    elif layout == "group":
        v = vgrid.reshape(n, g, -1).movedim(1, 0)                   # (g, N, F)
    else:
        raise ValueError(f"unknown batchloss layout {layout!r}")

    if sample_mask is None:
        sim = omic2 @ omic2.T
        sim = sim / torch.linalg.norm(sim, dim=1, keepdim=True)
        vsim = torch.einsum("gif,gjf->gij", v, v)
        vsim = vsim / torch.linalg.norm(vsim, dim=2, keepdim=True)
        return torch.sum((sim - vsim.mean(dim=0)) ** 2 / n)

    m = sample_mask.to(omic2.dtype)
    omic2 = omic2 * m[:, None]
    sim = omic2 @ omic2.T
    sim = sim / torch.linalg.norm(sim, dim=1, keepdim=True).clamp_min(1e-30)
    if layout == "reference":
        # flat row k*n+j of the (8, N) view belongs to sample (k*n+j)//g
        rows = torch.arange(8 * n, device=m.device) // g
        v = v * m[rows].reshape(8, n)[:, :, None]
    else:
        v = v * m[None, :, None]
    vsim = torch.einsum("gif,gjf->gij", v, v)
    vsim = vsim / torch.linalg.norm(vsim, dim=2, keepdim=True).clamp_min(1e-30)
    diff = (sim - vsim.mean(dim=0)) ** 2 * (m[:, None] * m[None, :])
    return diff.sum() / m.sum().clamp_min(1.0)


def task_loss(logits: torch.Tensor, labels: torch.Tensor, task_type: str,
              hazards: Optional[torch.Tensor] = None, s: Optional[torch.Tensor] = None,
              train: bool = True,
              sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's per-task loss (train vs test class weights)."""
    if task_type == "survival":
        h = hazards if hazards is not None else torch.sigmoid(logits)
        return nll_surv_loss(h, s, labels[:, 8], labels[:, 9], alpha=0.0,
                             sample_mask=sample_mask)
    slot = TASK_LABEL_SLOT[task_type]
    weights = (TASK_WEIGHTS_TRAIN if train else TASK_WEIGHTS_TEST)[task_type]
    return weighted_cross_entropy(logits, labels[:, slot], weights,
                                  sample_mask=sample_mask)
