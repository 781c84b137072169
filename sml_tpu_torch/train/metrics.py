"""Host-side evaluation metrics, numpy only (counterpart of ``sml_tpu/train/metrics.py``).

Survival: Harrell's C for right-censored data with sksurv's
``concordance_index_censored`` semantics (``tied_tol=1e-8``).  Classification
eval reports accuracy; f1 / auc / balanced accuracy / sensitivity /
specificity / precision need scikit-learn in the JAX package and wait for a
numpy port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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


def accuracy(gt: np.ndarray, probs: np.ndarray) -> float:
    return float(np.mean(np.argmax(probs, axis=1) == np.asarray(gt)))
