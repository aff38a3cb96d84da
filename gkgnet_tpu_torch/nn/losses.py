"""The multi-label losses of the main path, computed in fp32 whatever the
input dtype (counterpart: ``gkgnet_tpu/nn/losses.py``).

  * ``weight_reduce_loss``: the mmcls reduction; 'mean' with an
    ``avg_factor`` is ``sum / avg_factor``.
  * ``asymmetric_loss``: ASL (arXiv 2009.14119) with a probability margin
    ``clip`` on the negatives.
  * ``binary_cross_entropy_with_logits``: elementwise, numerically stable.
  * ``label_smooth_multilabel_loss``: targets smoothed to {eps, 1 - eps},
    sigmoid BCE.
"""

from __future__ import annotations

import torch


def weight_reduce_loss(loss: torch.Tensor, weight: torch.Tensor | None = None,
                       reduction: str = "mean",
                       avg_factor: float | None = None) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        if avg_factor is None:
            return loss.mean()
        return loss.sum() / avg_factor
    raise ValueError(f"invalid reduction {reduction}")


def asymmetric_loss(pred: torch.Tensor, target: torch.Tensor,
                    weight: torch.Tensor | None = None,
                    gamma_pos: float = 0.0, gamma_neg: float = 4.0,
                    clip: float = 0.05, reduction: str = "mean",
                    avg_factor: float | None = None,
                    use_sigmoid: bool = True, eps: float = 1e-8
                    ) -> torch.Tensor:
    pred = pred.float()
    target = target.float()
    p = torch.sigmoid(pred) if use_sigmoid else torch.softmax(pred, dim=-1)
    if clip and clip > 0:
        pt = torch.clamp(1.0 - p + clip, max=1.0) * (1.0 - target) \
            + p * target
    else:
        pt = (1.0 - p) * (1.0 - target) + p * target
    asym_weight = torch.pow(1.0 - pt,
                            gamma_pos * target + gamma_neg * (1.0 - target))
    loss = -torch.log(torch.clamp(pt, min=eps)) * asym_weight
    if weight is not None and weight.dim() == 1 and pred.dim() > 1:
        weight = weight.reshape(-1, 1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy_with_logits(pred: torch.Tensor,
                                     target: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE in fp32:
    ``max(x, 0) - x * t + log1p(exp(-|x|))``."""
    pred = pred.float()
    target = target.float()
    return torch.clamp(pred, min=0) - pred * target \
        + torch.log1p(torch.exp(-pred.abs()))


def label_smooth_multilabel_loss(pred: torch.Tensor, target: torch.Tensor,
                                 label_smooth_val: float = 0.1,
                                 weight: torch.Tensor | None = None,
                                 reduction: str = "mean",
                                 avg_factor: float | None = None
                                 ) -> torch.Tensor:
    eps = label_smooth_val
    smoothed = torch.where(target > 0, 1.0 - eps, eps)
    loss = binary_cross_entropy_with_logits(pred, smoothed)
    if weight is not None and weight.dim() == 1 and pred.dim() > 1:
        weight = weight.reshape(-1, 1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
