"""Evaluation metrics, numpy only (counterpart of ``sml_tpu/train/metrics.py``).

Survival: Harrell's C for right-censored data with sksurv's
``concordance_index_censored`` semantics (``tied_tol=1e-8``), and its on-device
batch form for gradient modulation (``batch_cindex``, torch).  Classification:
``compute_avg_metrics`` gives the seven metrics the JAX package takes from
scikit-learn (accuracy, macro F1, one-vs-rest macro AUC, balanced accuracy,
macro sensitivity / specificity / precision) with scikit-learn's label sets
and edge cases, written in numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def concordance_index_censored(event_indicator: np.ndarray, event_time: np.ndarray,
                               estimate: np.ndarray, tied_tol: float = 1e-8
                               ) -> Tuple[float, int, int, int, int]:
    """sksurv-compatible Harrell's C: (cindex, concordant, discordant, tied_risk,
    tied_time).  Comparable pairs: time_i < time_j with event_i; concordant when
    estimate_i > estimate_j; risk ties (|diff| <= tied_tol) count 0.5."""
    event = np.asarray(event_indicator, dtype=bool)
    time = np.asarray(event_time, dtype=float)
    est = np.asarray(estimate, dtype=float)
    order = np.argsort(time, kind="mergesort")
    time_s, event_s, est_s = time[order], event[order], est[order]

    n = len(time_s)
    concordant = discordant = tied_risk = 0
    tied_time = 0
    numerator = denominator = 0.0

    i = 0
    while i < n:
        # group of tied times [i, end)
        end = i + 1
        while end < n and time_s[end] == time_s[i]:
            end += 1
        for idx in range(i, end):
            if not event_s[idx]:
                continue
            rest = est_s[end:]
            if rest.size == 0:
                continue
            diff = est_s[idx] - rest
            ties = np.abs(diff) <= tied_tol
            con = (diff > 0) & ~ties
            dis = (diff < 0) & ~ties
            concordant += int(con.sum())
            discordant += int(dis.sum())
            tied_risk += int(ties.sum())
            numerator += con.sum() + 0.5 * ties.sum()
            denominator += rest.size
        tied_time += (end - i - 1) * (end - i) // 2
        i = end

    if denominator == 0:
        raise ValueError("No comparable pairs available (all samples censored or tied)")
    return (numerator / denominator, concordant, discordant, tied_risk, tied_time)


def cindex(all_risk_scores: np.ndarray, all_censorships: np.ndarray,
           all_event_times: np.ndarray) -> float:
    """Reference ``CIndex_sksurv``: events = 1 - censorship."""
    return concordance_index_censored(
        (1 - np.asarray(all_censorships)).astype(bool), all_event_times,
        all_risk_scores, tied_tol=1e-8)[0]


def _counts(gt: np.ndarray, pred: np.ndarray, labels: np.ndarray):
    """(tp, fp, fn) per label, over the samples whose true and predicted labels
    are both in ``labels`` (scikit-learn's ``confusion_matrix(labels=...)``)."""
    idx_t = np.searchsorted(labels, gt)
    idx_p = np.searchsorted(labels, pred)
    idx_t, idx_p = np.clip(idx_t, 0, len(labels) - 1), np.clip(idx_p, 0, len(labels) - 1)
    ok = (labels[idx_t] == gt) & (labels[idx_p] == pred)
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    np.add.at(cm, (idx_t[ok], idx_p[ok]), 1)
    tp = np.diag(cm)
    return cm, tp, cm.sum(axis=0) - tp, cm.sum(axis=1) - tp


def _binary_auc(positive: np.ndarray, score: np.ndarray) -> float:
    """ROC AUC as the Mann-Whitney statistic, ties counted one half."""
    _, inverse, counts = np.unique(score, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inverse]
    n_pos = int(positive.sum())
    n_neg = len(score) - n_pos
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _ovr_auc(gt: np.ndarray, act: np.ndarray) -> float:
    """One-vs-rest macro AUC; raises ValueError where scikit-learn does."""
    classes = np.unique(gt)
    if not np.allclose(1, act.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass "
                         "roc_auc, i.e. they should sum up to 1.0 over classes")
    if len(classes) != act.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of "
                         "columns in 'y_score'")
    return float(np.mean([_binary_auc(gt == c, act[:, i]) for i, c in enumerate(classes)]))


def compute_avg_metrics(ground_truth: np.ndarray, activations: np.ndarray
                        ) -> Tuple[float, float, float, float, float, float, float]:
    """acc, macro F1, one-vs-rest AUC, balanced accuracy, macro sensitivity /
    specificity / precision (reference ``utils/metrics.py:9-25``; an AUC that
    cannot be computed is 0)."""
    gt = np.asarray(ground_truth)
    act = np.asarray(activations)
    pred = np.argmax(act, -1)
    acc = float(np.mean(pred == gt))
    union = np.unique(np.concatenate([gt.astype(np.float64), pred.astype(np.float64)]))
    _, tp, fp, fn = _counts(gt, pred, union)
    f1 = float(np.mean(2 * tp / (2 * tp + fp + fn)))
    prec = float(np.mean(np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)))
    support = tp + fn
    bac = float(np.mean(tp[support > 0] / support[support > 0]))
    try:
        auc = _ovr_auc(gt, act)
    except ValueError as err:
        print(f"Error in computing AUC. Error msg:{err}")
        auc = 0.0
    cm, tp, fp, fn = _counts(gt, pred, np.unique(gt).astype(np.float64))
    tn = cm.sum() - tp - fp - fn
    sens = float(np.mean(np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)))
    spec = float(np.mean(np.where(tn + fp > 0, tn / np.maximum(tn + fp, 1), 0.0)))
    return acc, f1, auc, bac, sens, spec, prec


def batch_cindex(risk: torch.Tensor, censor: torch.Tensor, time: torch.Tensor,
                 tied_tol: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device batch concordance for gradient modulation: (cindex, valid),
    valid False when the batch has no comparable pair (then cindex = 0.5)."""
    event_i = (1.0 - censor)[:, None]
    comparable = (time[:, None] < time[None, :]) & (event_i > 0)
    diff = risk[:, None] - risk[None, :]
    ties = diff.abs() <= tied_tol
    concordant = (diff > 0) & ~ties
    num = torch.where(comparable, concordant.to(risk.dtype) + 0.5 * ties.to(risk.dtype),
                      0.0).sum()
    den = comparable.sum()
    valid = den > 0
    return torch.where(valid, num / den.clamp_min(1), 0.5), valid
