"""Classification heads (counterpart: ``gkgnet_tpu/nn/heads.py``).

``LabelQueryHead``: per-class score = diagonal of fc1(label_embeddings) +
fc2(gap_features), with the diagonal computed directly as a per-class dot
product (no (B, C, C) intermediate). Computed in fp32. Its train loss is
the dual loss: label-smoothed sigmoid BCE averaged over the batch, plus 10x
the asymmetric loss.

``LinearClsHead`` (single-label: cross-entropy, softmax scores) and
``MultiLabelLinearClsHead`` (sigmoid BCE with difficult labels, -1, taken
as positive, sigmoid scores): one fp32 linear layer ``fc`` over pooled
features, the heads of a classifier with a neck.
"""

from __future__ import annotations

import torch
from torch import nn

from gkgnet_tpu_torch.nn import losses as L


class LabelQueryHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 640,
                 gamma_pos: float = 0.0, gamma_neg: float = 2.0,
                 clip: float = 0.05, asy_loss_scale: float = 10.0,
                 label_smooth_val: float = 0.1):
        super().__init__()
        self.gamma_pos, self.gamma_neg, self.clip = gamma_pos, gamma_neg, clip
        self.asy_loss_scale = asy_loss_scale
        self.label_smooth_val = label_smooth_val
        self.fc1 = nn.Linear(in_channels, num_classes)
        self.fc2 = nn.Linear(in_channels, num_classes)

    def forward(self, label_emb: torch.Tensor, gap: torch.Tensor) -> torch.Tensor:
        """label_emb (B, num_classes, C), gap (B, C) -> logits (B, num_classes)."""
        score1 = torch.einsum("bnc,nc->bn", label_emb.float(),
                              self.fc1.weight) + self.fc1.bias
        return score1 + self.fc2(gap.float())

    def loss(self, cls_score: torch.Tensor, gt_label: torch.Tensor
             ) -> dict[str, torch.Tensor]:
        """The dual loss: ``bce_loss`` (label-smoothed, ``avg_factor`` =
        batch) and ``asy_loss`` (asymmetric, mean, times asy_loss_scale).
        Uses no parameter of the head."""
        asy = L.asymmetric_loss(cls_score, gt_label, gamma_pos=self.gamma_pos,
                                gamma_neg=self.gamma_neg, clip=self.clip)
        bce = L.label_smooth_multilabel_loss(
            cls_score, gt_label, self.label_smooth_val,
            avg_factor=cls_score.shape[0])
        return {"bce_loss": bce, "asy_loss": asy * self.asy_loss_scale}

    @staticmethod
    def simple_test(cls_score: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(cls_score)


class LinearClsHead(nn.Module):
    """Single-label linear head: logits ``fc(x)`` in fp32."""

    def __init__(self, num_classes: int, in_channels: int):
        super().__init__()
        self.fc = nn.Linear(in_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.float())

    @staticmethod
    def loss(cls_score: torch.Tensor, gt_label: torch.Tensor
             ) -> dict[str, torch.Tensor]:
        return {"loss": L.cross_entropy(cls_score, gt_label)}

    @staticmethod
    def simple_test(cls_score: torch.Tensor) -> torch.Tensor:
        return torch.softmax(cls_score, dim=1)


class MultiLabelLinearClsHead(nn.Module):
    """Multi-label linear head: logits ``fc(x)`` in fp32; its loss is the
    sigmoid BCE on ``|gt|`` summed over the classes, divided by their
    number and averaged over the batch."""

    def __init__(self, num_classes: int, in_channels: int):
        super().__init__()
        self.fc = nn.Linear(in_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.float())

    @staticmethod
    def loss(cls_score: torch.Tensor, gt_label: torch.Tensor
             ) -> dict[str, torch.Tensor]:
        bce = L.binary_cross_entropy_with_logits(cls_score, gt_label.abs())
        return {"loss": (bce.sum(dim=-1) / cls_score.shape[-1]).mean()}

    @staticmethod
    def simple_test(cls_score: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(cls_score)
