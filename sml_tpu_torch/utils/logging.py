"""Metric logging (counterpart of ``sml_tpu/utils/logging.py``): wandb when it
can be imported and initialised, and always a JSONL file, ``metrics.jsonl``,
one ``{"t": seconds, <flattened keys>}`` record per ``log`` call."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """Exponential rampup (reference ``utils/utils.py:21-28``)."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), rampup_length)
    phase = 1.0 - current / rampup_length
    return float(math.exp(-5.0 * phase * phase))


class MetricLogger:
    """wandb-compatible ``.log(dict)`` backed by ``<out_dir>/metrics.jsonl``
    (``out_dir`` must exist); ``disabled`` (``--debug``) writes nothing."""

    def __init__(self, config=None, out_dir: str = ".", disabled: bool = False):
        self.disabled = disabled
        self._wandb = None
        self._file = None
        self._t0 = time.time()
        if disabled:
            return
        self._file = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        try:
            import wandb  # type: ignore

            cfg = dataclasses.asdict(config) if config is not None else {}
            self._wandb = wandb.init(
                project=f"MMD_on_{getattr(config, 'dataset', 'unknown')}",
                notes="sml_tpu_torch", tags=["gpu", "multimodal"], config=cfg)
        except Exception:
            self._wandb = None

    def log(self, metrics: Dict[str, Any]) -> None:
        if self.disabled:
            return
        rec = {"t": round(time.time() - self._t0, 3), **_flatten(metrics)}
        if self._file is not None:
            self._file.write(json.dumps(rec, default=float) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {'a/b': float (or str where it is no number)}."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else f"{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            try:
                out[key] = float(v)
            except (TypeError, ValueError):
                out[key] = str(v)
    return out
