"""Top-level image classifier: GKGNet backbone + LabelQueryHead, or, with
a neck, backbone -> neck -> MultiLabelLinearClsHead (counterpart:
``gkgnet_tpu/nn/classifier.py``).

``forward`` returns ``(cls_score (B, n_classes) fp32, edge_index)``, where
the edge indices are those of the last label GCN (None with the perturbed
graph build); ``loss`` is the head's loss (the dual loss of the label-query
head) and ``parse_losses`` sums it. With ``neck_cfg`` the backbone returns
the maps of the stages in the neck's ``out_indices`` (else the
classifier's), the neck's last output is averaged over its spatial or class
axis, and a linear multi-label head scores it. ``init_parameters`` fills
the weights from a seeded ``torch.Generator`` with the JAX package's
initializer families. Each build is timed in the set-up table's
``setup.model`` row (``utils/profiling.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS, GKGNet
from gkgnet_tpu_torch.nn.heads import LabelQueryHead, MultiLabelLinearClsHead
from gkgnet_tpu_torch.nn.necks import (MultiLabelProjection, NHWCConv,
                                       build_neck, neck_out_channels)
from gkgnet_tpu_torch.utils import profiling
from gkgnet_tpu_torch.utils.weights import init_block_parameters


class GKGNetClassifier(nn.Module):

    @profiling.timed("setup.model")
    def __init__(self, arch: str = "s", k: int = 9, k_label_gcn: int = 9,
                 num_group: int = 2, n_classes: int = 80, size: int = 576,
                 num_gcn: int = 1, drop_path: float = 0.0,
                 out_indices: tuple = (3,), graph_builder: str = "knn",
                 dtype: torch.dtype = torch.float32,
                 head_kwargs: dict | None = None,
                 neck_cfg: dict | None = None):
        """``head_kwargs``: the head's settings (a config's ``model.head``);
        ``neck_cfg``: a config's ``model.neck``, or None."""
        super().__init__()
        channels = ARCH_SETTINGS[arch]["channels"]
        if neck_cfg is not None:
            out_indices = neck_cfg.get("out_indices", out_indices)
        out_indices = tuple(out_indices)
        self.backbone = GKGNet(arch=arch, k=k, k_label_gcn=k_label_gcn,
                               num_group=num_group, n_classes=n_classes,
                               size=size, num_gcn=num_gcn,
                               drop_path=drop_path, dtype=dtype,
                               out_indices=out_indices,
                               return_stage_feats=neck_cfg is not None,
                               graph_builder=graph_builder)
        self.neck_cfg = neck_cfg
        if neck_cfg is not None:
            stage_channels = [channels[i] for i in sorted(out_indices)]
            self.neck = build_neck(neck_cfg, stage_channels, dtype)
            self.head = MultiLabelLinearClsHead(
                n_classes, neck_out_channels(neck_cfg, stage_channels),
                **(head_kwargs or {}))
        else:
            self.head = LabelQueryHead(n_classes, channels[-1],
                                       **(head_kwargs or {}))

    def forward(self, imgs: torch.Tensor,
                generator: torch.Generator | None = None):
        """imgs (B, H, W, 3) NHWC -> (logits (B, n_classes), edge_index).
        ``generator`` feeds the DropPath (and stochastic graph build) draws
        in train mode."""
        if self.neck_cfg is None:
            label_emb, gap, edge_index = self.backbone(imgs, generator)
            return self.head(label_emb, gap), edge_index
        _, _, edge_index, feats = self.backbone(imgs, generator)
        h = self.neck(feats)
        if isinstance(h, (tuple, list)):
            h = h[-1]
        if h.dim() == 4:
            h = h.mean(dim=(1, 2))
        elif h.dim() == 3:  # (B, n_classes, P) from MultiLabelProjection
            h = h.mean(dim=1)
        return self.head(h), edge_index

    def build_loss_head(self) -> nn.Module:
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
    embeddings, lecun-normal label projections and neck kernels,
    normal(0.01) head; zero biases, unit BN scales and running variances,
    zero pos_embed, prelu slopes at their initial value."""
    init_block_parameters(model, generator)
    model.backbone.label_lt.weight.normal_(0.0, 1.0, generator=generator)
    for seq in model.backbone.ffn_label:
        lin = seq[0]
        lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
        lin.bias.zero_()
    heads = (model.head.fc,) if isinstance(model.head, MultiLabelLinearClsHead) \
        else (model.head.fc1, model.head.fc2)
    for lin in heads:
        lin.weight.normal_(0.0, 0.01, generator=generator)
        lin.bias.zero_()
    if model.neck_cfg is not None:  # lecun-normal kernels, zero biases
        for mod in model.neck.modules():
            if isinstance(mod, NHWCConv):
                mod.weight.normal_(0.0, mod.weight[0].numel() ** -0.5,
                                   generator=generator)
            elif isinstance(mod, MultiLabelProjection):
                mod.kernel.normal_(0.0, mod.kernel.shape[1] ** -0.5,
                                   generator=generator)
