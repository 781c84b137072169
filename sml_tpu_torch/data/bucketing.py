"""Bag-size bucketing for variable-length WSI bags (copy of
``sml_tpu/data/bucketing.py:bucket_for, bucket_bag``).

Each bag is zero-padded up to the smallest bucket that holds it, with a
validity mask; only bags larger than the largest bucket are uniformly
subsampled.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (1024, 2500, 4096)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def bucket_bag(bag: np.ndarray, buckets: Sequence[int] = DEFAULT_BUCKETS
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (with zeros + mask) or uniformly subsample ``bag`` (N, D) to a bucket
    size.  Returns (bag[bucket, D], mask[bucket] bool)."""
    n, d = bag.shape
    target = bucket_for(n, buckets)
    if n == target:
        return bag, np.ones(target, bool)
    if n < target:
        out = np.zeros((target, d), bag.dtype)
        out[:n] = bag
        mask = np.zeros(target, bool)
        mask[:n] = True
        return out, mask
    # uniform subsample, the rule of the reference's read_img downsampling
    idx = np.around(np.arange(target) * (n / target)).astype(int).clip(0, n - 1)
    return bag[idx], np.ones(target, bool)
