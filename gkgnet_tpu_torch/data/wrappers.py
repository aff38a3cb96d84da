"""Dataset wrappers (counterpart: ``gkgnet_tpu/data/wrappers.py``, a copy;
reference datasets/dataset_wrappers.py:73-226).

``ClassBalancedDataset`` is on the live path: LVIS-style repeat factors
``r(I) = max_c max(1, sqrt(t / f(c)))`` with ``oversample_thr = 0.01``
(configs/gkgnet/gkgnet_coco_576.py:86-87).
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.CLASSES = getattr(self.datasets[0], "CLASSES", None)
        self.cumulative = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cumulative[-1])

    def _locate(self, idx):
        ds = int(np.searchsorted(self.cumulative, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cumulative[ds - 1])
        return ds, idx - prev

    def prepare_data(self, idx, rng=None):
        ds, sub = self._locate(idx)
        return self.datasets[ds].prepare_data(sub, rng)

    def __getitem__(self, idx):
        ds, sub = self._locate(idx)
        return self.datasets[ds][sub]

    def get_gt_labels(self):
        return np.concatenate([d.get_gt_labels() for d in self.datasets])


class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.CLASSES = getattr(dataset, "CLASSES", None)
        self._ori_len = len(dataset)

    def __len__(self):
        return self.times * self._ori_len

    def prepare_data(self, idx, rng=None):
        return self.dataset.prepare_data(idx % self._ori_len, rng)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]


class ClassBalancedDataset:
    """Repeat-factor oversampling (dataset_wrappers.py:110-226)."""

    def __init__(self, dataset, oversample_thr: float):
        self.dataset = dataset
        self.oversample_thr = oversample_thr
        self.CLASSES = getattr(dataset, "CLASSES", None)

        repeat_factors = self._get_repeat_factors(dataset, oversample_thr)
        repeat_indices = []
        for idx, factor in enumerate(repeat_factors):
            repeat_indices.extend([idx] * math.ceil(factor))
        self.repeat_indices = repeat_indices

    @staticmethod
    def _get_repeat_factors(dataset, repeat_thr: float) -> list[float]:
        category_freq: dict[int, float] = defaultdict(float)
        num_images = len(dataset)
        for idx in range(num_images):
            cat_ids = set(dataset.get_cat_ids(idx))
            for cat_id in cat_ids:
                category_freq[cat_id] += 1
        for k in category_freq:
            category_freq[k] /= num_images
        category_repeat = {
            cat_id: max(1.0, math.sqrt(repeat_thr / cat_freq))
            for cat_id, cat_freq in category_freq.items()
        }
        repeat_factors = []
        for idx in range(num_images):
            cat_ids = set(dataset.get_cat_ids(idx))
            factor = max({category_repeat[c] for c in cat_ids}, default=1.0)
            repeat_factors.append(factor)
        return repeat_factors

    def __len__(self):
        return len(self.repeat_indices)

    def prepare_data(self, idx, rng=None):
        return self.dataset.prepare_data(self.repeat_indices[idx], rng)

    def __getitem__(self, idx):
        return self.dataset[self.repeat_indices[idx]]

    def get_cat_ids(self, idx):
        return self.dataset.get_cat_ids(self.repeat_indices[idx])

    def get_gt_labels(self):
        labels = self.dataset.get_gt_labels()
        return labels[np.asarray(self.repeat_indices)]


class KFoldDataset:
    """K-fold split view (dataset_wrappers.py KFoldDataset)."""

    def __init__(self, dataset, fold=0, num_splits=5, test_mode=False, seed=None):
        self.dataset = dataset
        self.CLASSES = getattr(dataset, "CLASSES", None)
        n = len(dataset)
        indices = np.arange(n)
        if seed is not None:
            np.random.default_rng(seed).shuffle(indices)
        test_start = n * fold // num_splits
        test_end = n * (fold + 1) // num_splits
        if test_mode:
            self.indices = indices[test_start:test_end]
        else:
            self.indices = np.concatenate([indices[:test_start], indices[test_end:]])

    def __len__(self):
        return len(self.indices)

    def prepare_data(self, idx, rng=None):
        return self.dataset.prepare_data(int(self.indices[idx]), rng)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]
