"""Top-level image classifier: GKGNet backbone + LabelQueryHead, without a
neck (counterpart: ``gkgnet_tpu/nn/classifier.py``).

``forward`` returns ``(cls_score (B, n_classes) fp32, edge_index)``, where
the edge indices are those of the last label GCN; ``loss`` is the head's
dual loss and ``parse_losses`` sums it. ``init_parameters`` fills the
weights from a seeded ``torch.Generator`` with the JAX package's
initializer families.
"""

from __future__ import annotations

import torch
from torch import nn

from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS, GKGNet
from gkgnet_tpu_torch.nn.heads import LabelQueryHead
from gkgnet_tpu_torch.utils.weights import init_block_parameters


class GKGNetClassifier(nn.Module):

    def __init__(self, arch: str = "s", k: int = 9, k_label_gcn: int = 9,
                 num_group: int = 2, n_classes: int = 80, size: int = 576,
                 num_gcn: int = 1, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 head_kwargs: dict | None = None):
        """``head_kwargs``: the LabelQueryHead's loss settings (a config's
        ``model.head``)."""
        super().__init__()
        self.backbone = GKGNet(arch=arch, k=k, k_label_gcn=k_label_gcn,
                               num_group=num_group, n_classes=n_classes,
                               size=size, num_gcn=num_gcn,
                               drop_path=drop_path, dtype=dtype)
        self.head = LabelQueryHead(
            n_classes, ARCH_SETTINGS[arch]["channels"][-1],
            **(head_kwargs or {}))

    def forward(self, imgs: torch.Tensor,
                generator: torch.Generator | None = None):
        """imgs (B, H, W, 3) NHWC -> (logits (B, n_classes), edge_index).
        ``generator`` feeds the DropPath draws in train mode."""
        label_emb, gap, edge_index = self.backbone(imgs, generator)
        return self.head(label_emb, gap), edge_index

    def build_loss_head(self) -> LabelQueryHead:
        """The head whose ``loss`` matches this classifier; the loss uses
        none of its parameters."""
        return self.head

    def loss(self, cls_score: torch.Tensor, gt_label: torch.Tensor
             ) -> dict[str, torch.Tensor]:
        return self.head.loss(cls_score, gt_label)

    def predict(self, cls_score: torch.Tensor) -> torch.Tensor:
        return self.head.simple_test(cls_score)


def parse_losses(losses: dict[str, torch.Tensor]
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss = the sum of every mean value whose key contains 'loss';
    the log holds each mean and the total under 'loss'."""
    log_vars = {k: v.mean() for k, v in losses.items()}
    total = sum(v for k, v in log_vars.items() if "loss" in k)
    log_vars["loss"] = total
    return total, log_vars


@torch.no_grad()
def init_parameters(model: GKGNetClassifier, generator: torch.Generator) -> None:
    """Seeded init: kaiming-normal (fan_in) convolutions, normal(1.0) label
    embeddings, lecun-normal label projections, normal(0.01) head; zero
    biases, unit BN scales and running variances, zero pos_embed."""
    init_block_parameters(model, generator)
    model.backbone.label_lt.weight.normal_(0.0, 1.0, generator=generator)
    for seq in model.backbone.ffn_label:
        lin = seq[0]
        lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
        lin.bias.zero_()
    for lin in (model.head.fc1, model.head.fc2):
        lin.weight.normal_(0.0, 0.01, generator=generator)
        lin.bias.zero_()
