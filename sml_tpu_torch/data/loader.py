"""Datasets by name and batching (counterpart of ``sml_tpu/data/loader.py``:
``build_datasets``, ``Loader`` and ``BucketedLoader``, single host).

``dataset`` synthetic, IvYGAP, TCGA, or both (the two cohorts concatenated,
IvYGAP first).

Eval mode: sequential order; the final batch is padded to ``batch_size`` by
repeating its last sample, and ``sample_mask`` (1 = real, 0 = pad) marks the
pad rows so the metrics and the loss count exactly the real samples.
Train mode (``shuffle=True, drop_last=True``): each epoch's order is the
permutation of ``np.random.default_rng(seed * 100003 + epoch)``, set by
``set_epoch``, and the last partial batch is dropped; the batches are the JAX
Loader's.  With ``workers > 0`` one thread collates the batches ahead of the
consumer, at most ``max(2, workers)`` of them (the JAX Loader's Python
prefetch): the same batches in the same order, only sooner.

A field that the samples hold as tensors (the raw patch bags of
``if_end2end``, already on the card) is stacked and padded with torch, on
its device; every other field with numpy.

Several data ranks: ``num_shards`` / ``shard_id`` give each rank the
contiguous slice of every global batch of ``batch_size * num_shards``
(``sharded_index_batches``), ``batch_size`` being the rank's local batch; all
ranks shuffle with the same seed.
"""

from __future__ import annotations

import threading
import warnings
from collections import Counter
from queue import Queue
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from sml_tpu_torch.config import Config


class ConcatDataset:
    """The samples of each dataset in turn."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cum[-1]) if len(self.cum) else 0

    def __getitem__(self, index: int):
        ds_idx = int(np.searchsorted(self.cum, index, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cum[ds_idx - 1])
        return self.datasets[ds_idx][index - prev]


def build_datasets(config: Config, phase: str):
    """dataset flag -> dataset for ``phase``: synthetic, IvYGAP, TCGA, or
    both (IvYGAP then TCGA, the reference's default)."""
    if config.dataset == "synthetic":
        from sml_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(phase, config)
    from sml_tpu_torch.data.datasets import IvYGAPDataset, TCGADataset

    if config.dataset == "IvYGAP":
        return IvYGAPDataset(phase, config)
    if config.dataset == "TCGA":
        return TCGADataset(phase, config)
    if config.dataset == "both":
        return ConcatDataset([IvYGAPDataset(phase, config), TCGADataset(phase, config)])
    raise ValueError(f"unknown dataset {config.dataset!r} "
                     "(synthetic, IvYGAP, TCGA or both)")


def sharded_index_batches(idx: np.ndarray, local_bs: int, num_shards: int,
                          shard_id: int, drop_last: bool) -> List[np.ndarray]:
    """The JAX ``sharded_index_batches``: global batches of ``local_bs *
    num_shards`` indices in ``idx``'s order, of each the ``shard_id``-th
    contiguous slice, so the gathered global batch is the one-process batch
    row for row.  A short last batch is dropped (``drop_last``) or
    wrap-padded, as torch's DistributedSampler pads."""
    global_bs = local_bs * num_shards
    out = []
    for start in range(0, len(idx), global_bs):
        chunk = idx[start:start + global_bs]
        if len(chunk) < global_bs:
            if drop_last:
                continue
            chunk = np.tile(chunk, -(-global_bs // len(chunk)))[:global_bs]
        out.append(chunk[shard_id * local_bs:(shard_id + 1) * local_bs])
    return out


def _stack(values: list):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack(values)


def _pad(v, pad: int):
    """``v`` with its last row repeated ``pad`` times."""
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v[-1:].expand(pad, *v.shape[1:])])
    return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)


class Loader:
    """Yields dict batches of stacked numpy arrays (tensors where the samples
    hold tensors)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, workers: int = 0,
                 num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.workers = workers
        self.num_shards = max(num_shards, 1)
        self.shard_id = shard_id
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        global_bs = self.batch_size * self.num_shards
        if self.drop_last:
            return len(self.dataset) // global_bs
        return -(-len(self.dataset) // global_bs)

    def _batches_of(self, idx: np.ndarray) -> List[np.ndarray]:
        """``idx`` in batches (this shard's slices of the global ones)."""
        if self.num_shards > 1:
            return sharded_index_batches(idx, self.batch_size, self.num_shards,
                                         self.shard_id, self.drop_last)
        chunks = [idx[s:s + self.batch_size] for s in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            chunks = [c for c in chunks if len(c) == self.batch_size]
        return chunks

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed * 100_003 + self.epoch).shuffle(idx)
        return self._batches_of(idx)

    def _collate(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        samples = [self.dataset[int(i)] for i in chunk]
        batch = {k: _stack([s[k] for s in samples]) for k in samples[0]}
        pad = self.batch_size - len(samples)
        mask = np.ones(self.batch_size, dtype=np.float32)
        if pad > 0:
            for k, v in batch.items():
                batch[k] = _pad(v, pad)
            mask[len(samples):] = 0.0
        batch["sample_mask"] = mask
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        if self.workers <= 0:
            for chunk in batches:
                yield self._collate(chunk)
            return
        yield from self._threaded_iter(batches)

    def _threaded_iter(self, batches: List[np.ndarray]) -> Iterator[Dict[str, np.ndarray]]:
        """Collate on one producer thread through a bounded queue; an error
        in the producer is raised here, in the consumer."""
        q: Queue = Queue(maxsize=max(2, self.workers))
        stop = object()

        def producer():
            try:
                for chunk in batches:
                    q.put(self._collate(chunk))
            except BaseException as e:  # noqa: BLE001 - handed to the consumer
                q.put(e)
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()


class BucketedLoader(Loader):
    """Loader whose every batch holds one bag-size bucket (the JAX package's
    ``BucketedLoader``).  The dataset gives ``bucket_of(i)``.
    Each bucket is batched on its own (dropping or padding its own
    remainder); in train mode the epoch's batches are then put in the order
    of ``np.random.default_rng(seed * 900007 + epoch)``, so buckets
    interleave."""

    def __len__(self) -> int:
        bs = self.batch_size * self.num_shards
        sizes = Counter(self.dataset.bucket_of(i) for i in range(len(self.dataset)))
        return sum(n // bs if self.drop_last else -(-n // bs) for n in sizes.values())

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed * 100_003 + self.epoch).shuffle(idx)
        by_bucket: Dict[int, List[int]] = {}
        for i in idx:
            by_bucket.setdefault(self.dataset.bucket_of(int(i)), []).append(i)
        batches: List[np.ndarray] = []
        global_bs = self.batch_size * self.num_shards
        for bucket in sorted(by_bucket):
            bidx = np.asarray(by_bucket[bucket])
            if self.drop_last and len(bidx) < global_bs:
                warnings.warn(f"bucket {bucket} holds {len(bidx)} samples < batch "
                              f"{global_bs} and drop_last=True: they never train",
                              stacklevel=2)
            batches.extend(self._batches_of(bidx))
        if self.shuffle:
            order = np.random.default_rng(self.seed * 900_007 + self.epoch).permutation(
                len(batches))
            batches = [batches[i] for i in order]
        return batches
