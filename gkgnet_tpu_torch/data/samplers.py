"""Epoch-seeded samplers (counterpart: ``gkgnet_tpu/data/samplers.py``, a
copy; reference datasets/samplers/*), numpy-based. "rank" is the process
index; one card runs rank 0 of 1.
"""

from __future__ import annotations

import math

import numpy as np


class DistributedSampler:
    """Epoch-seeded shuffle + rank shard + round-up padding
    (samplers/distributed_sampler.py)."""

    def __init__(self, dataset, num_replicas=1, rank=0, shuffle=True,
                 round_up=True, seed=0):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.round_up = round_up
        self.seed = seed
        self.epoch = 0
        if round_up:
            self.num_samples = math.ceil(len(dataset) / num_replicas)
            self.total_size = self.num_samples * num_replicas
        else:
            self.num_samples = math.ceil(
                (len(dataset) - rank) / num_replicas)
            self.total_size = len(dataset)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(n).tolist()
        else:
            indices = list(range(n))
        if self.round_up:
            indices = (indices * math.ceil(self.total_size / n))[: self.total_size]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self):
        return self.num_samples


class RepeatAugSampler:
    """DeiT repeated augmentation (samplers/repeat_aug.py:11-94): every
    sample appears ``num_repeats`` times, shards round-robin across ranks so
    the repeats land on different ranks, and each rank yields only
    ``floor(len/selected_round)*selected_round/num_replicas`` samples."""

    def __init__(self, dataset, num_replicas=1, rank=0, shuffle=True,
                 num_repeats=3, selected_round=256, selected_ratio=0, seed=0):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.num_repeats = num_repeats
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(
            math.ceil(len(dataset) * num_repeats / num_replicas))
        self.total_size = self.num_samples * num_replicas
        selected_ratio = selected_ratio or num_replicas
        if selected_round:
            self.num_selected_samples = int(math.floor(
                len(dataset) // selected_round * selected_round / selected_ratio))
        else:
            self.num_selected_samples = int(math.ceil(len(dataset) / selected_ratio))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(len(self.dataset)).tolist()
        else:
            indices = list(range(len(self.dataset)))
        indices = [x for x in indices for _ in range(self.num_repeats)]
        padding = self.total_size - len(indices)
        indices += indices[:padding]
        indices = indices[self.rank:self.total_size:self.num_replicas]
        return iter(indices[: self.num_selected_samples])

    def __len__(self):
        return self.num_selected_samples


class IdInOrderSampler:
    """Sequential ids, rank-sharded, no shuffle (samplers/id_order.py)."""

    def __init__(self, dataset, num_replicas=1, rank=0):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank

    def set_epoch(self, epoch: int):
        pass

    def __iter__(self):
        return iter(range(self.rank, len(self.dataset), self.num_replicas))

    def __len__(self):
        return math.ceil((len(self.dataset) - self.rank) / self.num_replicas)
