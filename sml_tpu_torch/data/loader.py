"""Eval-mode batching (counterpart of ``sml_tpu/data/loader.py``).

Sequential order; the final batch is padded to ``batch_size`` by repeating its
last sample, and ``sample_mask`` (1 = real, 0 = pad) marks the pad rows so the
metrics and the loss count exactly the real samples.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from sml_tpu_torch.config import Config


def build_datasets(config: Config, phase: str):
    """dataset flag -> dataset for ``phase`` (``synthetic`` only in the port)."""
    if config.dataset == "synthetic":
        from sml_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(phase, config)
    raise NotImplementedError(
        f"dataset {config.dataset!r} is not ported yet (synthetic only)")


class Loader:
    """Yields dict batches of stacked numpy arrays, in dataset order."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _collate(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        samples = [self.dataset[int(i)] for i in chunk]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        pad = self.batch_size - len(samples)
        mask = np.ones(self.batch_size, dtype=np.float32)
        if pad > 0:
            for k, v in batch.items():
                batch[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
            mask[len(samples):] = 0.0
        batch["sample_mask"] = mask
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.dataset))
        for start in range(0, len(idx), self.batch_size):
            yield self._collate(idx[start:start + self.batch_size])
