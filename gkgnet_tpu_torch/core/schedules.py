"""Learning-rate schedules as plain host arithmetic, ``step -> lr``
(counterpart: ``gkgnet_tpu/core/schedules.py``, mmcv lr_updater semantics).

  * ``step_lr_with_warmup``: step decay at epoch milestones, with mmcv's
    linear warmup ``lr * (1 - (1 - t)(1 - ratio))`` over ``warmup_iters``;
  * ``cosine_cooldown_lr``: cosine from base to ``base * min_lr_ratio`` over
    ``total - cool_down_time`` steps, then flat at
    ``base * cool_down_ratio``;
  * ``ReduceLrOnPlateau``: a host-side reducer whose ``scale`` multiplies
    the schedule's output.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def step_lr_with_warmup(base_lr: float, steps_per_epoch: int,
                        milestones: Sequence[int], gamma: float = 0.1,
                        warmup_iters: int = 0, warmup_ratio: float = 1e-3
                        ) -> Callable[[int], float]:
    """``milestones`` are epochs; ``warmup_iters`` is in iterations."""
    milestone_iters = [m * steps_per_epoch for m in milestones]

    def schedule(step: int) -> float:
        decays = sum(step >= m for m in milestone_iters)
        lr = base_lr * gamma ** decays
        if step < warmup_iters:
            frac = min(step / warmup_iters, 1.0)
            lr *= 1.0 - (1.0 - frac) * (1.0 - warmup_ratio)
        return lr

    return schedule


def cosine_cooldown_lr(base_lr: float, total_steps: int,
                       cool_down_ratio: float = 0.1, cool_down_time: int = 10,
                       min_lr_ratio: float = 0.0, warmup_iters: int = 0,
                       warmup_ratio: float = 1e-3) -> Callable[[int], float]:
    anneal_steps = max(total_steps - cool_down_time, 1)

    def schedule(step: int) -> float:
        if step >= anneal_steps:
            lr = base_lr * cool_down_ratio
        else:
            t = step / anneal_steps
            target = base_lr * min_lr_ratio
            lr = target + 0.5 * (base_lr - target) * (1 + math.cos(math.pi * t))
        if step < warmup_iters:
            frac = min(step / warmup_iters, 1.0)
            lr *= 1.0 - (1.0 - frac) * (1.0 - warmup_ratio)
        return lr

    return schedule


class ReduceLrOnPlateau:
    """Host-side plateau reducer (ReduceLrUpdaterHook semantics): call
    ``update(metric)`` after each evaluation; ``scale`` multiplies the
    schedule's output."""

    def __init__(self, factor: float = 0.1, patience: int = 3,
                 threshold: float = 1e-4, mode: str = "max",
                 min_lr: float = 0.0, cooldown: int = 0):
        self.factor, self.patience, self.threshold = factor, patience, threshold
        self.mode, self.min_lr, self.cooldown = mode, min_lr, cooldown
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1 + self.threshold)
        return metric < self.best * (1 - self.threshold)

    def update(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.num_bad = 0
                self.cooldown_counter = self.cooldown
        return self.scale
