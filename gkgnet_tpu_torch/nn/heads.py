"""Classification head, forward and ``simple_test`` only (counterpart:
``gkgnet_tpu/nn/heads.py``; its losses come with the training slice).

``LabelQueryHead``: per-class score = diagonal of fc1(label_embeddings) +
fc2(gap_features), with the diagonal computed directly as a per-class dot
product (no (B, C, C) intermediate). Computed in fp32.
"""

from __future__ import annotations

import torch
from torch import nn


class LabelQueryHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 640):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, num_classes)
        self.fc2 = nn.Linear(in_channels, num_classes)

    def forward(self, label_emb: torch.Tensor, gap: torch.Tensor) -> torch.Tensor:
        """label_emb (B, num_classes, C), gap (B, C) -> logits (B, num_classes)."""
        score1 = torch.einsum("bnc,nc->bn", label_emb.float(),
                              self.fc1.weight) + self.fc1.bias
        return score1 + self.fc2(gap.float())

    @staticmethod
    def simple_test(cls_score: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(cls_score)
