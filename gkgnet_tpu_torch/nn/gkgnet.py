"""GKGNet backbone (counterpart: ``gkgnet_tpu/nn/gkgnet.py``).

A 4-stage pyramid of Grapher+FFN blocks over a stride-4 patch grid, with a
parallel label-embedding pathway: after the last block of every stage the
label tokens query the stage feature map through a cross-graph k-NN
(GrapherLabel) and are projected to the next stage's width.

Module names follow the reference's mmcls state_dict: ``stem.convs.*``,
``pos_embed`` (1, C, H, W), ``label_lt``, ``backbone.{i}`` (a Downsample, or
a Grapher/FFN pair as ``.0``/``.1``), ``gcn_label.{stage}.{j}`` and
``ffn_label.{stage}.0``. The per-stage relative-position distance bias is
computed once per model (numpy) and held as a non-persistent fp32 buffer,
one table per stage shared by the blocks of the stage. Stochastic depth
grows linearly over the blocks, ``np.linspace(0, drop_path, n_blocks)``;
the label blocks of stage i take the rate of the stage's first block.

``use_multi_group`` / ``backbone_multi_group`` fold ``num_group`` channel
groups in the label / spatial graph convs (off: one group, so arch b's
stage 4 builds its graph on all 1024 channels). ``out_indices`` and
``return_stage_feats`` return the end-of-stage maps for a neck;
``graph_builder`` picks the hard kNN or the perturbed soft build;
``knn_budget`` bounds the plain graph build's distance block (a spatial
stage whose N x M exceeds it tiles its query rows, ``_divisor_chunk``).

``forward`` runs in the device spans (``utils/profiling.py``) ``stem``,
``stage<i>`` (the downsample and the stage's Grapher/FFN blocks),
``label<i>`` (the stage's label GCN taps and the label projection) and
``head`` (the pooled feature), i = 1..4.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gkgnet_tpu_torch.nn.grapher import Grapher, GrapherLabel
from gkgnet_tpu_torch.nn.layers import FFN, Downsample, Stem
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu_torch.utils import profiling

ARCH_SETTINGS = {
    "t": dict(conv="mr", act="gelu", norm="batch", bias=True,
              epsilon=0.2, use_stochastic=False,
              blocks=(2, 2, 6, 2), channels=(48, 96, 240, 384), emb_dims=1024),
    "s": dict(conv="mr", act="gelu", norm="batch", bias=True,
              epsilon=0.2, use_stochastic=False,
              blocks=(2, 2, 6, 2), channels=(80, 160, 400, 640), emb_dims=1024),
    "b": dict(conv="mr", act="gelu", norm="batch", bias=True,
              epsilon=0.2, use_stochastic=False,
              blocks=(2, 2, 18, 2), channels=(128, 256, 512, 1024),
              emb_dims=1024),
}

REDUCE_RATIOS = (4, 2, 1, 1)


def _divisor_chunk(n: int, m: int, budget_elems: int = 1 << 22) -> int | None:
    """The largest divisor c of n with c * m <= budget, or None where no
    tiling is needed (n * m within the budget) or possible (no divisor
    below n fits)."""
    if n * m <= budget_elems:
        return None
    best = 1
    for c in range(1, n + 1):
        if n % c == 0 and c * m <= budget_elems and c > best:
            best = c
    return best if best < n else None


class GKGNet(nn.Module):
    """Multi-label Vision-GNN backbone. ``forward`` returns
    ``(label_embeddings (B, n_classes, C3), gap_features (B, C3),
    edge_index)``, and with ``return_stage_feats`` also the tuple of the
    end-of-stage maps (NHWC) of the stages in ``out_indices``."""

    def __init__(self, arch: str = "s", k: int = 9, k_label_gcn: int = 9,
                 num_group: int = 2, n_classes: int = 80, size: int = 576,
                 num_gcn: int = 1, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 use_multi_group: bool = True,
                 backbone_multi_group: bool = True,
                 out_indices: tuple = (3,), return_stage_feats: bool = False,
                 graph_builder: str = "knn", knn_budget: int = 1 << 22):
        super().__init__()
        opt = ARCH_SETTINGS[arch]
        blocks, channels = opt["blocks"], opt["channels"]
        act, conv, bias = opt["act"], opt["conv"], opt["bias"]
        stochastic, epsilon = opt["use_stochastic"], opt["epsilon"]
        self.dtype = dtype
        self.n_classes = n_classes
        self.out_indices = tuple(out_indices)
        self.return_stage_feats = return_stage_feats
        max_dilation = 49 // k
        hw = size // 4
        dpr = np.linspace(0, drop_path, sum(blocks))

        self.stem = Stem(3, channels[0], act, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, channels[0], hw, hw))
        self.label_lt = nn.Embedding(n_classes, channels[0])

        n_stage = hw * hw
        for i in range(len(blocks)):
            table = get_relative_pos_table(channels[i], n_stage,
                                           REDUCE_RATIOS[i])
            self.register_buffer(f"rel_pos_stage{i}",
                                 torch.from_numpy(table), persistent=False)
            n_stage //= 4

        self.backbone = nn.ModuleList()
        self.gcn_label = nn.ModuleList()
        self.ffn_label = nn.ModuleList()
        # per stage: the range of its entries in ``backbone``
        self._stages: list[range] = []
        grapher_idx = 0
        stage_n = hw * hw
        for i in range(len(blocks)):
            first = len(self.backbone)
            if i > 0:
                self.backbone.append(Downsample(channels[i - 1], channels[i],
                                                dtype))
                stage_n //= 4
            r_i = REDUCE_RATIOS[i]
            chunk = _divisor_chunk(stage_n, stage_n // (r_i * r_i),
                                   knn_budget)
            for j in range(blocks[i]):
                dilation = min(grapher_idx // 4 + 1, max_dilation)
                n_targets = stage_n // (r_i * r_i)
                if k * dilation > n_targets:
                    raise ValueError(
                        f"stage {i}: k*dilation={k * dilation} exceeds "
                        f"{n_targets} candidate nodes — increase `size` or "
                        f"reduce `k` (k=9 needs size>=224)")
                rate = float(dpr[grapher_idx])
                self.backbone.append(nn.Sequential(
                    Grapher(channels[i], k, dilation, conv, act, "batch",
                            bias, stochastic, epsilon, r_i, drop_path=rate,
                            use_multi_group=backbone_multi_group,
                            num_group=num_group, graph_builder=graph_builder,
                            dtype=dtype, knn_chunk=chunk),
                    FFN(channels[i], channels[i] * 4, act, rate, dtype)))
                grapher_idx += 1
            self._stages.append(range(first, len(self.backbone)))
            n_label_gcn = num_gcn if i == len(blocks) - 1 else 1
            label_rate = float(dpr[sum(blocks[:i])])
            self.gcn_label.append(nn.ModuleList(
                GrapherLabel(channels[i], k_label_gcn, 1, "mr", act, "batch",
                             bias, stochastic, epsilon, drop_path=label_rate,
                             use_multi_group=use_multi_group,
                             num_group=num_group, graph_builder=graph_builder,
                             dtype=dtype)
                for _ in range(n_label_gcn)))
            if i < len(blocks) - 1:
                self.ffn_label.append(nn.Sequential(
                    nn.Linear(channels[i], channels[i + 1])))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """``generator`` feeds the DropPath draws in train mode."""
        b = x.shape[0]
        with profiling.span("stem"):
            label_emb = self.label_lt.weight.to(self.dtype)[None].expand(
                b, self.n_classes, -1)
            x = self.stem(x)
            x = x + self.pos_embed.permute(0, 2, 3, 1).to(self.dtype)
        edge_index = None
        stage_feats = []
        for stage, entries in enumerate(self._stages):
            with profiling.span(f"stage{stage + 1}"):
                for j in entries:
                    module = self.backbone[j]
                    if isinstance(module, Downsample):
                        x = module(x)
                        continue
                    grapher, ffn = module
                    x = grapher(x, getattr(self, f"rel_pos_stage{stage}"),
                                generator)
                    x = ffn(x, generator)
            with profiling.span(f"label{stage + 1}"):
                for gcn in self.gcn_label[stage]:
                    label_emb, edge_index = gcn(label_emb, x, generator)
                if stage < len(self.ffn_label):
                    lin = self.ffn_label[stage][0]
                    label_emb = torch.nn.functional.linear(
                        label_emb, lin.weight.to(self.dtype),
                        lin.bias.to(self.dtype))
            if stage in self.out_indices:
                stage_feats.append(x)
        with profiling.span("head"):
            gap = x.float().mean(dim=(1, 2)).to(self.dtype)
        if self.return_stage_feats:
            return label_emb, gap, edge_index, tuple(stage_feats)
        return label_emb, gap, edge_index
