"""Packed binary dataset format and its loader (counterpart of
``sml_tpu/data/packed.py``, single host).

``pack_dataset`` flattens a sample-dict dataset into fixed-size records (the
fields' little-endian bytes, concatenated) with a JSON sidecar describing the
fields: the JAX package's files, byte for byte.  ``PackedLoader`` batches them
as the ``Loader`` batches the dataset (the same seeded epoch order, train
drops the last partial batch, eval pads it by repeating its last record with
``sample_mask`` 0; several data ranks take ``num_shards`` / ``shard_id``,
each the contiguous slice of every global batch, whose wrap-padded rows count
as real, as in the JAX loader).  With ``workers > 0`` the native C++ prefetcher
(``sml_tpu_torch.runtime``) reads the records on ``workers`` threads, at most
``queue_depth`` batches ahead; a failed build, a failed ``pf_open`` or a
short read raises.  ``workers == 0`` reads through a numpy memmap on the
calling thread.  At 2500 x 1024 f32 a record is about 10.2 MB.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from sml_tpu_torch.data.loader import sharded_index_batches


def pack_dataset(dataset, path: str) -> dict:
    """Write ``dataset`` (indexable -> dict of np arrays) to ``path`` (+ .json),
    every field of its first sample, in that sample's order."""
    sample = dataset[0]
    meta = {"fields": [], "n_records": len(dataset)}
    record_bytes = 0
    for name, value in sample.items():
        arr = np.asarray(value)
        meta["fields"].append({"name": name, "shape": list(arr.shape),
                               "dtype": str(arr.dtype)})
        record_bytes += arr.nbytes
    meta["record_bytes"] = record_bytes

    with open(path, "wb") as f:
        for i in range(len(dataset)):
            s = dataset[i]
            for spec in meta["fields"]:
                arr = np.ascontiguousarray(np.asarray(s[spec["name"]], dtype=spec["dtype"]))
                if list(arr.shape) != spec["shape"]:
                    raise ValueError(f"ragged field {spec['name']} at record {i}: "
                                     f"{list(arr.shape)} != {spec['shape']}")
                f.write(arr.tobytes())
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return meta


class PackedDataset:
    """Random access over a packed file (numpy memmap)."""

    def __init__(self, path: str):
        self.path = path
        with open(path + ".json") as f:
            self.meta = json.load(f)
        self.record_bytes = self.meta["record_bytes"]
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return self.meta["n_records"]

    def record(self, index: int) -> np.ndarray:
        start = index * self.record_bytes
        return np.array(self._mm[start:start + self.record_bytes])

    def decode(self, raw: np.ndarray, batch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Fields of one record (``batch`` None) or of ``batch`` stacked records."""
        rows = raw.reshape(-1 if batch is None else batch, self.record_bytes)
        out, off = {}, 0
        for spec in self.meta["fields"]:
            dt = np.dtype(spec["dtype"])
            nbytes = int(np.prod(spec["shape"], dtype=np.int64)) * dt.itemsize
            lead = [] if batch is None else [batch]
            out[spec["name"]] = np.ascontiguousarray(
                rows[:, off:off + nbytes]).view(dt).reshape(lead + spec["shape"])
            off += nbytes
        return out

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.decode(self.record(index))


class PackedLoader:
    """Batches of a packed file, read by the native prefetcher (``workers >
    0``) or through the memmap (``workers == 0``)."""

    def __init__(self, path: str, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, workers: int = 2,
                 queue_depth: int = 4, num_shards: int = 1, shard_id: int = 0):
        self.ds = PackedDataset(path)
        self.path = path
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.workers = workers
        self.queue_depth = queue_depth
        self.num_shards = max(num_shards, 1)
        self.shard_id = shard_id
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        global_bs = self.batch_size * self.num_shards
        if self.drop_last:
            return len(self.ds) // global_bs
        return -(-len(self.ds) // global_bs)

    def _epoch_indices(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Each batch's record indices (a short eval batch padded with its last
        index) and its ``sample_mask``."""
        idx = np.arange(len(self.ds), dtype=np.int64)
        if self.shuffle:
            np.random.default_rng(self.seed * 100_003 + self.epoch).shuffle(idx)
        if self.num_shards > 1:
            batches = sharded_index_batches(idx, self.batch_size, self.num_shards,
                                            self.shard_id, self.drop_last)
            return batches, [np.ones(self.batch_size, np.float32) for _ in batches]
        batches, masks = [], []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            mask = np.ones(self.batch_size, np.float32)
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    continue
                mask[len(chunk):] = 0.0
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], self.batch_size - len(chunk))])
            batches.append(chunk)
            masks.append(mask)
        return batches, masks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches, masks = self._epoch_indices()
        if self.workers <= 0:
            for chunk, mask in zip(batches, masks):
                raw = np.stack([self.ds.record(int(i)) for i in chunk])
                yield dict(self.ds.decode(raw, self.batch_size), sample_mask=mask)
            return
        yield from self._native_iter(batches, masks)

    def _native_iter(self, batches, masks) -> Iterator[Dict[str, np.ndarray]]:
        from sml_tpu_torch import runtime

        lib = runtime.load_library()
        handle = lib.pf_open(self.path.encode(), self.ds.record_bytes, self.batch_size,
                             self.queue_depth, self.workers)
        if not handle:
            raise OSError(f"pf_open failed for {self.path}")
        try:
            if not batches:
                return
            flat = np.ascontiguousarray(np.concatenate(batches), dtype=np.int64)
            n = lib.pf_submit(handle, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              len(flat))
            if n != len(batches):
                raise RuntimeError(f"pf_submit queued {n} batches, expected {len(batches)}")
            total = self.batch_size * self.ds.record_bytes
            for mask in masks:
                buf = lib.pf_next(handle)
                if not buf:
                    raise OSError(f"short read of a record of {self.path}")
                raw = np.ctypeslib.as_array(buf, shape=(total,)).copy()
                yield dict(self.ds.decode(raw, self.batch_size), sample_mask=mask)
        finally:
            lib.pf_close(handle)
