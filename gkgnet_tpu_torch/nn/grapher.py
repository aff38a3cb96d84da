"""Grapher blocks: dynamic k-NN graph convolution over the patch grid and the
label->patch cross-graph, single-device 'mr' path, with DropPath residuals
in train mode (counterpart: ``gkgnet_tpu/nn/grapher.py``).

Group folding: with ``num_group=g`` the channel dim is split into g groups
folded into the batch axis; each group builds its own k-NN edge set over its
C/g-dim features. After the max-relative aggregate the groups are unfolded
and the centre and aggregate features are channel-interleaved before the
grouped 1x1 conv. Every graph conv goes through ``knn_mr_fused``: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from gkgnet_tpu_torch.nn.layers import (FFN, BasicConv, ConvNorm, DropPath,
                                        avg_pool_nhwc)
from gkgnet_tpu_torch.ops.aggregate import interleave_channels
from gkgnet_tpu_torch.ops.knn_mr import knn_mr_fused


def _require_ported(conv: str, graph_builder: str, stochastic: bool) -> None:
    if conv != "mr":
        raise NotImplementedError(
            f"conv='{conv}': only 'mr' is ported; the other aggregators "
            f"come with the off-path model features slice")
    if graph_builder != "knn":
        raise NotImplementedError(
            f"graph_builder='{graph_builder}' (perturbed top-k) comes with "
            f"the off-path model features slice")
    if stochastic:
        raise NotImplementedError(
            "stochastic dilation is not ported (no arch uses it: every "
            "ARCH_SETTINGS entry has use_stochastic=False); see ROADMAP.md, "
            "queue 1, 'Off-path model features'")


def fold_groups(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, N, C) -> (B*g, N, C/g), contiguous; group i holds channels
    [i*C/g, (i+1)*C/g)."""
    b, n, c = x.shape
    # at batch 1 the reshape can return a strided view; the kernel takes
    # contiguous rows only
    return x.reshape(b, n, g, c // g).permute(0, 2, 1, 3).reshape(
        b * g, n, c // g).contiguous()


def unfold_groups(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B*g, N, D) -> (B, N, g*D), the inverse of ``fold_groups``."""
    if g == 1:
        return x
    bg, n, d = x.shape
    return x.reshape(bg // g, g, n, d).permute(0, 2, 1, 3).reshape(
        bg // g, n, g * d)


class GraphAggregate(nn.Module):
    """Max-relative aggregate of (group-folded) nodes + 1x1 grouped-conv
    mixing. Returns unfolded ``(B, N, out_channels)``."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 num_group: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_group = num_group
        self.nn = BasicConv([in_channels * 2, out_channels], act, norm,
                            use_bias, dtype=dtype)

    def forward(self, x: torch.Tensor, maxrel: torch.Tensor) -> torch.Tensor:
        g = self.num_group
        h = interleave_channels(unfold_groups(x, g), unfold_groups(maxrel, g))
        return self.nn(h)


class SpatialGraphConv(nn.Module):
    """Dynamic spatial graph conv over the patch grid: a per-group
    k*d-NN graph of the (optionally r x r avg-pooled) targets, dilated to k,
    aggregated. Input and output NHWC."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 9,
                 dilation: int = 1, conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, r: int = 1, num_group: int = 2,
                 graph_builder: str = "knn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _require_ported(conv, graph_builder, stochastic)
        self.k, self.dilation, self.r, self.num_group = k, dilation, r, num_group
        self.out_channels = out_channels
        self.gconv = GraphAggregate(in_channels, out_channels, act, norm,
                                    use_bias, num_group, dtype)

    def forward(self, x: torch.Tensor, rel_pos: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b, h, w, c = x.shape
        g = self.num_group
        xn = fold_groups(x.reshape(b, h * w, c), g)
        y = xn
        if self.r > 1:
            y = fold_groups(avg_pool_nhwc(x, self.r).reshape(b, -1, c), g)
        idx, maxrel = knn_mr_fused(xn, y, rel_pos, self.k, self.dilation)
        out = self.gconv(xn, maxrel)
        return out.reshape(b, h, w, self.out_channels), idx


class LabelGraphConv(nn.Module):
    """Label->patch cross-graph conv: label tokens query the stage feature
    map."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 9,
                 dilation: int = 1, conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, num_group: int = 2,
                 graph_builder: str = "knn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _require_ported(conv, graph_builder, stochastic)
        self.k, self.dilation, self.num_group = k, dilation, num_group
        self.gconv = GraphAggregate(in_channels, out_channels, act, norm,
                                    use_bias, num_group, dtype)

    def forward(self, labels: torch.Tensor, feats: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        g = self.num_group
        xn = fold_groups(labels, g)                   # (B*g, L, C/g)
        yn = fold_groups(feats, g)                    # (B*g, N, C/g)
        idx, maxrel = knn_mr_fused(xn, yn, None, self.k, self.dilation)
        return self.gconv(xn, maxrel), idx


class Grapher(nn.Module):
    """fc1 -> spatial graph conv -> fc2 with a DropPath residual. The
    per-stage relative-position distance bias is passed in."""

    def __init__(self, in_channels: int, k: int = 9, dilation: int = 1,
                 conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, r: int = 1, num_group: int = 2,
                 graph_builder: str = "knn", drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = ConvNorm(in_channels, in_channels, dtype)
        self.graph_conv = SpatialGraphConv(
            in_channels, in_channels * 2, k, dilation, conv, act, norm,
            use_bias, stochastic, r, num_group, graph_builder, dtype)
        self.fc2 = ConvNorm(in_channels * 2, in_channels, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, rel_pos: torch.Tensor | None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h, _ = self.graph_conv(self.fc1(x), rel_pos)
        return self.drop_path(self.fc2(h), generator) + x


class GrapherLabel(nn.Module):
    """Label-token grapher: fc1 -> cross-graph conv -> fc2 -> DropPath
    residual -> FFN (4x hidden, the same drop_path). Returns the updated
    label embeddings and the (group-folded) label->patch edge indices."""

    def __init__(self, in_channels: int, k: int = 9, dilation: int = 1,
                 conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, num_group: int = 2,
                 graph_builder: str = "knn", drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = ConvNorm(in_channels, in_channels, dtype)
        self.graph_conv = LabelGraphConv(
            in_channels, in_channels * 2, k, dilation, conv, act, norm,
            use_bias, stochastic, num_group, graph_builder, dtype)
        self.fc2 = ConvNorm(in_channels * 2, in_channels, dtype)
        self.drop_path = DropPath(drop_path)
        self.ffn = FFN(in_channels, in_channels * 4, act, drop_path, dtype)

    def forward(self, labels: torch.Tensor, feats: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b, h, w, c = feats.shape
        x, edge_idx = self.graph_conv(self.fc1(labels),
                                      feats.reshape(b, h * w, c))
        x = self.drop_path(self.fc2(x), generator) + labels
        return self.ffn(x, generator), edge_idx
