"""Loss functions, computed in fp32 whatever the input dtype (counterpart:
``gkgnet_tpu/nn/losses.py``).

The main path's multi-label losses:
  * ``weight_reduce_loss``: the mmcls reduction; 'mean' with an
    ``avg_factor`` is ``sum / avg_factor``.
  * ``asymmetric_loss``: ASL (arXiv 2009.14119) with a probability margin
    ``clip`` on the negatives.
  * ``binary_cross_entropy_with_logits``: elementwise, numerically stable.
  * ``label_smooth_multilabel_loss``: targets smoothed to {eps, 1 - eps},
    sigmoid BCE.

The reference's other losses: ``soft_cross_entropy``, ``cross_entropy``
(index labels), ``label_smooth_loss`` (single-label, 'original' and
'classy_vision'), ``seesaw_loss``, ``contrastive_loss`` (InfoNCE over
paired features), ``focal_loss`` (sigmoid), ``center_loss`` and
``triplet_loss`` (batch-hard).
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


def soft_cross_entropy(pred: torch.Tensor, soft_target: torch.Tensor,
                       weight: torch.Tensor | None = None,
                       reduction: str = "mean",
                       avg_factor: float | None = None) -> torch.Tensor:
    """``-sum(target * log_softmax(pred))`` per sample."""
    logp = torch.log_softmax(pred.float(), dim=-1)
    loss = -(soft_target.float() * logp).sum(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def cross_entropy(pred: torch.Tensor, label: torch.Tensor,
                  weight: torch.Tensor | None = None,
                  reduction: str = "mean",
                  avg_factor: float | None = None) -> torch.Tensor:
    """Cross-entropy of index labels ``(N,)``."""
    logp = torch.log_softmax(pred.float(), dim=-1)
    loss = -logp.gather(-1, label.long()[:, None])[:, 0]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def label_smooth_loss(pred: torch.Tensor, target_onehot: torch.Tensor,
                      label_smooth_val: float = 0.1,
                      mode: str = "classy_vision", reduction: str = "mean",
                      avg_factor: float | None = None) -> torch.Tensor:
    """Single-label smoothing: ``onehot * (1 - eps) + eps / C`` with
    ``eps = val`` ('original') or ``val / (1 + val)`` ('classy_vision'),
    then the soft cross-entropy."""
    eps = label_smooth_val
    if mode == "classy_vision":
        eps = label_smooth_val / (1.0 + label_smooth_val)
    num_classes = pred.shape[-1]
    smooth = target_onehot.float() * (1.0 - eps) + eps / num_classes
    return soft_cross_entropy(pred, smooth, reduction=reduction,
                              avg_factor=avg_factor)


def seesaw_loss(pred: torch.Tensor, label: torch.Tensor,
                cum_samples: torch.Tensor, p: float = 0.8, q: float = 2.0,
                eps: float = 1e-2, reduction: str = "mean",
                avg_factor: float | None = None) -> torch.Tensor:
    """Seesaw loss: the negative classes' logits of a softmax CE shifted by
    ``log(max(mitigation * compensation, eps))``, with the mitigation
    ``(n_j / n_i) ** p`` where class j is rarer than the label i
    (``cum_samples`` the per-class counts) and the compensation
    ``(s_j / s_i) ** q`` where class j scores above the label."""
    pred = pred.float()
    n, c = pred.shape
    onehot = torch.nn.functional.one_hot(label.long(), c).float()
    seesaw = torch.ones((n, c), dtype=torch.float32, device=pred.device)
    if p > 0:
        cum = cum_samples.float()
        ratio = cum[None, :] / torch.clamp(cum[:, None], min=1.0)
        mitigation = torch.where(ratio < 1.0, ratio ** p, 1.0)
        seesaw = seesaw * mitigation[label.long()]
    if q > 0:
        scores = torch.softmax(pred, dim=-1)
        self_score = scores.gather(-1, label.long()[:, None])
        compensation = torch.where(
            scores > self_score,
            (scores / torch.clamp(self_score, min=1e-12)) ** q, 1.0)
        seesaw = seesaw * compensation
    pred_adj = pred + torch.log(torch.clamp(seesaw, min=eps)) * (1.0 - onehot)
    logp = torch.log_softmax(pred_adj, dim=-1)
    loss = -(onehot * logp).sum(dim=-1)
    return weight_reduce_loss(loss, None, reduction, avg_factor)


def contrastive_loss(feats_a: torch.Tensor, feats_b: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE over paired features: the diagonal pairs are positives."""
    a = feats_a / torch.linalg.vector_norm(feats_a, dim=-1, keepdim=True)
    b = feats_b / torch.linalg.vector_norm(feats_b, dim=-1, keepdim=True)
    logits = (a @ b.T).float() / temperature
    labels = torch.arange(a.shape[0], device=a.device)
    return cross_entropy(logits, labels)


def focal_loss(pred: torch.Tensor, target: torch.Tensor,
               weight: torch.Tensor | None = None, gamma: float = 2.0,
               alpha: float = 0.25, reduction: str = "mean",
               avg_factor: float | None = None) -> torch.Tensor:
    """Sigmoid focal loss."""
    pred = pred.float()
    target = target.float()
    p = torch.sigmoid(pred)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) \
        * torch.pow(pt, gamma)
    loss = binary_cross_entropy_with_logits(pred, target) * focal_weight
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def center_loss(feats: torch.Tensor, labels: torch.Tensor,
                centers: torch.Tensor) -> torch.Tensor:
    """Center loss: the squared distance of each feature to its class's
    centre (``centers`` (num_classes, feat_dim), owned by the caller),
    clipped to [1e-12, 1e12] per entry of the masked distance matrix, mean
    over the batch."""
    f32 = feats.float()
    c32 = centers.float()
    distmat = (f32 * f32).sum(dim=1, keepdim=True) - 2.0 * f32 @ c32.T \
        + (c32 * c32).sum(dim=1)[None, :]
    onehot = torch.nn.functional.one_hot(labels.long(),
                                         centers.shape[0]).float()
    dist = torch.clamp(distmat * onehot, 1e-12, 1e12)
    return dist.sum() / feats.shape[0]


def triplet_loss(feats: torch.Tensor, labels: torch.Tensor,
                 margin: float = 0.3, distance: str = "euclidean"
                 ) -> torch.Tensor:
    """Batch-hard triplet loss: for each anchor the hardest positive (the
    largest same-label distance) against the hardest negative (the
    smallest other-label distance), hinged at ``margin``."""
    f32 = feats.float()
    if distance == "euclidean":
        sq = (f32 * f32).sum(dim=1)
        dist = sq[:, None] - 2.0 * f32 @ f32.T + sq[None, :]
        dist = torch.sqrt(torch.clamp(dist, min=1e-12))
    elif distance == "cosine":
        ln = f32 / torch.linalg.vector_norm(f32, dim=1, keepdim=True)
        dist = -(ln @ ln.T)
    else:
        raise KeyError(f"Unsupported distance: {distance}")
    same = labels[:, None] == labels[None, :]
    big = 1e12
    dist_ap = torch.where(same, dist, -big).amax(dim=1)
    dist_an = torch.where(same, big, dist).amin(dim=1)
    return torch.clamp(margin - (dist_an - dist_ap), min=0.0).mean()
