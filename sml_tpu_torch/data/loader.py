"""Batching (counterpart of ``sml_tpu/data/loader.py``, single host).

Eval mode: sequential order; the final batch is padded to ``batch_size`` by
repeating its last sample, and ``sample_mask`` (1 = real, 0 = pad) marks the
pad rows so the metrics and the loss count exactly the real samples.
Train mode (``shuffle=True, drop_last=True``): each epoch's order is the
permutation of ``np.random.default_rng(seed * 100003 + epoch)``, set by
``set_epoch``, and the last partial batch is dropped; the batches are the JAX
Loader's.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

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
    """Yields dict batches of stacked numpy arrays."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed * 100_003 + self.epoch).shuffle(idx)
        chunks = [idx[s:s + self.batch_size] for s in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            chunks = [c for c in chunks if len(c) == self.batch_size]
        return chunks

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
        for chunk in self._index_batches():
            yield self._collate(chunk)
