"""Training-support services beyond the basic loop (counterpart:
``gkgnet_tpu/core/hooks.py``, the reference's mmcls core/hook family as
functions):

  * ``precise_bn``: recompute every BatchNorm's running statistics over a
    few batches before eval (PreciseBN), eagerly: one pass, no CUDA graph;
  * ``class_num_check``: the dataset's CLASSES against the head's width.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import nn

from gkgnet_tpu_torch.nn.layers import BatchNorm


def _bn_layers(model: nn.Module) -> list[BatchNorm]:
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


@torch.no_grad()
def precise_bn(model: nn.Module, batches: Iterable, num_samples: int = 8192,
               generator: torch.Generator | None = None) -> int:
    """Set every BatchNorm's running statistics to the average of its
    per-batch moments over up to ``num_samples`` samples (PreciseBN).

    Each batch (a dict with ``img``, or the images themselves, NHWC) runs a
    train-mode forward from zeroed statistics under ``no_grad``: one update
    gives ``new = (1 - m) * 0 + m * moment`` with the layer's momentum m
    (0.1), so the batch's moment is ``new / m`` (the mean, and the unbiased
    variance that the train-mode update moves towards). The moments are
    averaged over the batches, as the JAX package's ``precise_bn`` does.
    ``generator`` feeds the train-mode forward's random draws (DropPath,
    stochastic dilation). The model's mode is restored; with no batch the
    statistics stay as they were. Returns the number of batches used.
    """
    layers = _bn_layers(model)
    device = next(model.parameters()).device
    was_training = model.training
    saved = [(bn.running_mean.clone(), bn.running_var.clone())
             for bn in layers]
    acc = None
    count = seen = 0
    model.train()
    try:
        for batch in batches:
            imgs = batch["img"] if isinstance(batch, dict) else batch
            if isinstance(imgs, np.ndarray):
                imgs = torch.from_numpy(imgs)
            imgs = imgs.to(device)
            for bn in layers:
                bn.running_mean.zero_()
                bn.running_var.zero_()
            model(imgs, generator=generator)
            moments = [(bn.running_mean / bn.momentum,
                        bn.running_var / bn.momentum) for bn in layers]
            if acc is None:
                acc = moments
            else:
                acc = [(am + m, av + v) for (am, av), (m, v)
                       in zip(acc, moments)]
            count += 1
            seen += imgs.shape[0]
            if seen >= num_samples:
                break
    finally:
        model.train(was_training)
    stats = saved if acc is None else [(m / count, v / count)
                                       for m, v in acc]
    for bn, (mean, var) in zip(layers, stats):
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
    return count


def class_num_check(dataset, num_classes: int) -> None:
    """Raise if ``dataset.CLASSES`` disagrees with the head width."""
    classes = getattr(dataset, "CLASSES", None)
    if classes is None:
        return
    if len(classes) != num_classes:
        raise ValueError(
            f"dataset has {len(classes)} classes but head num_classes="
            f"{num_classes}")
