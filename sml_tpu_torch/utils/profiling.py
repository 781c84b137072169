"""Profiling hooks (counterpart of ``sml_tpu/utils/profiling.py``).

``trace(log_dir)`` records a region with ``torch.profiler`` (host activity,
and the card's kernels when there is one, the hand-written ones launched
through ``ctypes`` included) and writes a Chrome trace under ``log_dir``;
``annotate(name)`` names a sub-region in it; ``StepTimer`` gives per-step
wall times that wait for the card, with warm-up steps left out of the stats.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the path of the Chrome trace it writes on exit
    (``<log_dir>/trace.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named sub-region inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Step timer: ``with timer.step(block_on=t): ...``; stats skip the warm-up
    steps (all steps when there are no more)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, block_on=None):
        """Time the block; with ``block_on`` a CUDA tensor or device, the card's
        work is waited for before the time is taken."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            device = block_on.device if isinstance(block_on, torch.Tensor) \
                else torch.device(block_on)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> dict:
        t = np.asarray(self.times[self.warmup:] or self.times)
        return {"mean_ms": float(t.mean() * 1e3), "p50_ms": float(np.median(t) * 1e3),
                "min_ms": float(t.min() * 1e3), "max_ms": float(t.max() * 1e3),
                "steps": len(t)}
