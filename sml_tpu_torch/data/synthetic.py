"""Synthetic multimodal dataset with the exact reference sample contract (copy of
``sml_tpu/data/synthetic.py``: same seeds, same numpy streams, same arrays).

Per sample:
    x_path        (fixdim, input_path_dim)  WSI patch-feature bag
    x_omic        (431,)          full gene-expression vector
    x_omic_tumor  (59,)           tumor-signature subset
    x_omic_immune (361,)          immune-signature subset
    labels        (12,)           [IDH, 1p19q, CDKN, His, Grade, Diag2021, His2,
                                   Subtype, surv_bin, censor, event, surv_time]

A 4-class latent drives the class labels, the omic class centers, a third of the
path patches and the survival time scale.  With ``variable_bags`` each sample
draws its bag size from [smallest bucket / 2, largest bucket] (or [fixdim / 2,
fixdim]) and the bag is bucketed with a validity ``mask``
(``data/bucketing.py``); ``bucket_of`` gives a sample's bucket without
building its bag.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sml_tpu_torch.config import Config
from sml_tpu_torch.data.bucketing import bucket_bag, bucket_for

# survival-bin thresholds shared with the reference (data/dataset.py:112-119)
QUANTILES_ALL = (233.5, 511.0, 929.0)
QUANTILES_UNCENSORED = (212.5, 454.0, 776.5)

_PHASE_SALT = {"Train": 0, "Val": 1, "Test": 2}


class SyntheticDataset:
    def __init__(self, phase: str, config: Config):
        self.phase = phase
        self.config = config
        n = config.synthetic_size if phase == "Train" else max(config.synthetic_size // 4, 8)
        self.n = n

        gen_rng = np.random.default_rng(config.seed)  # shared generative constants
        n_classes = 4
        self.omic_centers = gen_rng.normal(size=(n_classes, config.input_size_omic)) * 2.0
        self.path_centers = gen_rng.normal(size=(n_classes, config.input_path_dim))

        rng = np.random.default_rng(config.seed * 1000 + _PHASE_SALT.get(phase, 9))
        self.classes = rng.integers(0, n_classes, size=n)

        # survival: class 0 (GBM-like) shortest, class 3 longest
        scale = np.array([180.0, 420.0, 750.0, 1300.0])[self.classes]
        self.times = rng.gamma(shape=2.0, scale=scale / 2.0, size=n).clip(5.0, 4000.0)
        self.censor = (rng.uniform(size=n) < 0.35).astype(np.int64)  # 1 = alive

        self.omic_noise_seed = rng.integers(0, 2 ** 31, size=n)
        q = QUANTILES_UNCENSORED if config.survival_interval == "uncensored" else QUANTILES_ALL
        self.quantiles = q

        # tumor/immune gene index subsets (fixed, like the signature xlsx column subsets)
        self.idx_tumor = np.arange(0, config.input_size_omic_tumor)
        self.idx_immune = np.arange(config.input_size_omic - config.input_size_omic_immune,
                                    config.input_size_omic)

        # variable bags: each size is the first draw of a fresh generator on the
        # sample's noise seed, so a bucketed loader groups batches without
        # building the bags
        self.buckets = config.bucket_list() if config.variable_bags else ()
        if self.buckets:
            lo, hi = max(self.buckets[0] // 2, 4), self.buckets[-1]
        else:
            lo, hi = max(config.fixdim // 2, 4), config.fixdim
        self._bag_lo, self._bag_hi = lo, hi
        if config.variable_bags:
            self.bag_sizes = np.array([int(np.random.default_rng(int(s)).integers(lo, hi + 1))
                                       for s in self.omic_noise_seed])

    def bucket_of(self, index: int) -> int:
        """Bucketed bag length of sample ``index`` (for batch grouping)."""
        if not self.config.variable_bags:
            return self.config.fixdim
        return bucket_for(int(self.bag_sizes[index]), self.buckets or (self.config.fixdim,))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        c = int(self.classes[index])
        rng = np.random.default_rng(int(self.omic_noise_seed[index]))

        omic = (self.omic_centers[c] + rng.normal(size=cfg.input_size_omic)
                ).astype(np.float32)
        n_bag = cfg.fixdim
        if cfg.variable_bags:
            n_bag = int(self.bag_sizes[index])
            rng.integers(self._bag_lo, self._bag_hi + 1)  # keeps the stream of the JAX copy
        # bag: 30% signal patches near the class path-center, rest background
        n_sig = n_bag // 3
        signal = (self.path_centers[c][None, :] * 0.5
                  + rng.normal(size=(n_sig, cfg.input_path_dim)))
        background = rng.normal(size=(n_bag - n_sig, cfg.input_path_dim))
        bag = np.concatenate([signal, background], axis=0).astype(np.float32)
        rng.shuffle(bag)

        sample = {
            "x_path": bag,
            "x_omic": omic,
            "x_omic_tumor": omic[self.idx_tumor],
            "x_omic_immune": omic[self.idx_immune],
            "labels": self._labels(index, c),
        }
        if cfg.variable_bags:
            sample["x_path"], sample["mask"] = bucket_bag(
                bag, buckets=self.buckets or (cfg.fixdim,))
        return sample

    def _labels(self, index: int, c: int) -> np.ndarray:
        t = float(self.times[index])
        q25, q50, q75 = self.quantiles
        surv_bin = 0 if t < q25 else 1 if t < q50 else 2 if t < q75 else 3
        censor = int(self.censor[index])
        event = 1 - censor
        grade = min(c, 2)       # 3-class
        subtype = min(c, 2)     # 3-class
        return np.asarray([0, 0, 0, 0, grade, c, 0, subtype, surv_bin, censor,
                           event, t], dtype=np.float32)
