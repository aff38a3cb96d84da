"""Grapher blocks: dynamic k-NN graph convolution over the patch grid and the
label->patch cross-graph, single-device, with DropPath residuals in train
mode (counterpart: ``gkgnet_tpu/nn/grapher.py``).

Group folding: with ``num_group=g`` the channel dim is split into g groups
folded into the batch axis; each group builds its own k-NN edge set over its
C/g-dim features. After the aggregate the groups are unfolded and, for 'mr'
and 'gat', the centre and aggregate features are channel-interleaved before
the grouped 1x1 conv.

Two routes, chosen as the JAX package chooses them:
  * the 'mr' aggregator outside stochastic training goes through
    ``knn_mr_fused``: the fused CUDA kernel for CUDA tensors, its plain
    version for CPU tensors;
  * every other aggregator ('edge', 'sage', 'gin', 'gat'), and 'mr' with
    stochastic dilation in training (epsilon > 0), builds the graph with
    ``knn_graph`` (the knn_topk CUDA kernel for CUDA tensors), subsamples
    it with ``dilate_edges`` and aggregates in plain PyTorch. Only 'mr'
    composes with group folding.
"""

from __future__ import annotations

import torch
from torch import nn

from gkgnet_tpu_torch.nn.layers import (FFN, BasicConv, ConvNorm, DropPath,
                                        PointwiseConv, avg_pool_nhwc)
from gkgnet_tpu_torch.ops.aggregate import (gather_nodes, interleave_channels,
                                            max_relative, sum_neighbors)
from gkgnet_tpu_torch.ops.knn import dilate_edges, knn_graph
from gkgnet_tpu_torch.ops.knn_mr import knn_mr_fused

CONVS = ("mr", "edge", "sage", "gin", "gat")


def _require_ported(graph_builder: str) -> None:
    if graph_builder != "knn":
        raise NotImplementedError(
            f"graph_builder='{graph_builder}' (perturbed top-k) comes with "
            f"the off-path model features slice")


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
    """Aggregate the neighbours of (group-folded) nodes and mix with 1x1
    grouped convs. ``forward(x (BG, N, D), idx (BG, N, k), y (BG, M, D) or
    None for y = x, maxrel)`` returns unfolded ``(B, N, out_channels)``;
    ``maxrel`` is the 'mr' aggregate when the fused kernel computed it.

    The JAX package's channel orders, which decide weight parity:
      * mr: ``nn`` [2C, out] on the interleaved ``[x, max_k(x_j - x)]``;
      * edge: ``nn`` [2C, out] on the concat ``[x_i, x_j - x_i]`` per edge,
        then the max over k;
      * sage: ``nn1`` [C, C] on x_j, the max over k, ``nn2`` [2C, out] on
        the concat ``[x, h]``;
      * gin: ``nn`` [C, out] on ``(1 + eps) x + sum_k x_j``, with ``eps`` an
        fp32 (1,) parameter;
      * gat: the attention ``a`` (a 1x1 conv 2C -> 1) on the concat
        ``[x_i, x_j]``, a softmax over k in fp32, ``nn`` [2C, out] on the
        interleaved ``[x, sum_k att x_j]``.
    """

    def __init__(self, conv: str, in_channels: int, out_channels: int,
                 act: str = "relu", norm: str | None = "batch",
                 use_bias: bool = True, num_group: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv not in CONVS:
            raise NotImplementedError(f"conv:{conv} is not supported")
        if conv != "mr" and num_group != 1:
            raise ValueError(f"conv='{conv}' does not support multi-group "
                             f"folding")
        self.conv = conv
        self.num_group = num_group
        c = in_channels
        if conv == "sage":
            self.nn1 = BasicConv([c, c], act, norm, use_bias, dtype=dtype)
            self.nn2 = BasicConv([2 * c, out_channels], act, norm, use_bias,
                                 dtype=dtype)
            return
        if conv == "gin":
            self.eps = nn.Parameter(torch.zeros(1))
        if conv == "gat":
            self.a = PointwiseConv(2 * c, 1, 1, use_bias, dtype)
        self.nn = BasicConv([c if conv == "gin" else 2 * c, out_channels],
                            act, norm, use_bias, dtype=dtype)

    def forward(self, x: torch.Tensor, idx: torch.Tensor | None,
                y: torch.Tensor | None,
                maxrel: torch.Tensor | None = None) -> torch.Tensor:
        if self.conv == "mr":
            g = self.num_group
            if maxrel is None:
                maxrel = max_relative(x, idx, y)
            return self.nn(interleave_channels(unfold_groups(x, g),
                                               unfold_groups(maxrel, g)))
        if self.conv == "gin":
            h = (1.0 + self.eps.to(x.dtype)) * x + sum_neighbors(x, idx, y)
            return self.nn(h)
        x_j = gather_nodes(x if y is None else y, idx)     # (B, N, k, C)
        if self.conv == "sage":
            h = torch.amax(self.nn1(x_j), dim=2)
            return self.nn2(torch.cat([x, h], dim=-1))
        x_i = x[:, :, None, :].expand_as(x_j)
        if self.conv == "edge":
            h = self.nn(torch.cat([x_i, x_j - x_i], dim=-1))
            return torch.amax(h, dim=2)
        e = self.a(torch.cat([x_i, x_j], dim=-1))[..., 0]  # (B, N, k)
        atten = torch.softmax(e.float(), dim=-1).to(x.dtype)
        agg = torch.sum(atten[..., None] * x_j, dim=2)
        return self.nn(interleave_channels(x, agg))


def _build_edges(conv: nn.Module, xn: torch.Tensor, y: torch.Tensor | None,
                 bias: torch.Tensor | None,
                 generator: torch.Generator | None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The graph of one graph conv and, on the fused route, its 'mr'
    aggregate: ``(idx (BG, N, k), maxrel or None)``."""
    stochastic_now = conv.stochastic and conv.training and conv.epsilon > 0.0
    if conv.conv == "mr" and not stochastic_now:
        return knn_mr_fused(xn, xn if y is None else y, bias, conv.k,
                            conv.dilation)
    idx = knn_graph(xn, y, k=conv.k * conv.dilation, bias=bias)
    idx = dilate_edges(idx, dilation=conv.dilation,
                       stochastic=conv.stochastic, epsilon=conv.epsilon,
                       generator=generator, training=conv.training)
    return idx, None


class SpatialGraphConv(nn.Module):
    """Dynamic spatial graph conv over the patch grid: a per-group
    k*d-NN graph of the (optionally r x r avg-pooled) targets, dilated to k,
    aggregated. Input and output NHWC."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 9,
                 dilation: int = 1, conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, epsilon: float = 0.0, r: int = 1,
                 num_group: int = 2, graph_builder: str = "knn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _require_ported(graph_builder)
        self.k, self.dilation, self.r, self.num_group = k, dilation, r, num_group
        self.conv, self.stochastic, self.epsilon = conv, stochastic, epsilon
        self.out_channels = out_channels
        self.gconv = GraphAggregate(conv, in_channels, out_channels, act,
                                    norm, use_bias, num_group, dtype)

    def forward(self, x: torch.Tensor, rel_pos: torch.Tensor | None,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``generator`` feeds the stochastic dilation's draws."""
        b, h, w, c = x.shape
        g = self.num_group
        xn = fold_groups(x.reshape(b, h * w, c), g)
        y = None
        if self.r > 1:
            y = fold_groups(avg_pool_nhwc(x, self.r).reshape(b, -1, c), g)
        idx, maxrel = _build_edges(self, xn, y, rel_pos, generator)
        out = self.gconv(xn, idx, y, maxrel)
        return out.reshape(b, h, w, self.out_channels), idx


class LabelGraphConv(nn.Module):
    """Label->patch cross-graph conv: label tokens query the stage feature
    map."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 9,
                 dilation: int = 1, conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, epsilon: float = 0.0,
                 num_group: int = 2, graph_builder: str = "knn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _require_ported(graph_builder)
        self.k, self.dilation, self.num_group = k, dilation, num_group
        self.conv, self.stochastic, self.epsilon = conv, stochastic, epsilon
        self.gconv = GraphAggregate(conv, in_channels, out_channels, act,
                                    norm, use_bias, num_group, dtype)

    def forward(self, labels: torch.Tensor, feats: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        g = self.num_group
        xn = fold_groups(labels, g)                   # (B*g, L, C/g)
        yn = fold_groups(feats, g)                    # (B*g, N, C/g)
        idx, maxrel = _build_edges(self, xn, yn, None, generator)
        return self.gconv(xn, idx, yn, maxrel), idx


class Grapher(nn.Module):
    """fc1 -> spatial graph conv -> fc2 with a DropPath residual. The
    per-stage relative-position distance bias is passed in. The graph conv
    folds ``num_group`` channel groups with ``use_multi_group``, else none."""

    def __init__(self, in_channels: int, k: int = 9, dilation: int = 1,
                 conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, epsilon: float = 0.0, r: int = 1,
                 drop_path: float = 0.0, use_multi_group: bool = True,
                 num_group: int = 2, graph_builder: str = "knn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = ConvNorm(in_channels, in_channels, dtype)
        self.graph_conv = SpatialGraphConv(
            in_channels, in_channels * 2, k, dilation, conv, act, norm,
            use_bias, stochastic, epsilon, r,
            num_group if use_multi_group else 1, graph_builder, dtype)
        self.fc2 = ConvNorm(in_channels * 2, in_channels, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, rel_pos: torch.Tensor | None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` feeds the stochastic dilation and DropPath draws in
        train mode."""
        h, _ = self.graph_conv(self.fc1(x), rel_pos, generator)
        return self.drop_path(self.fc2(h), generator) + x


class GrapherLabel(nn.Module):
    """Label-token grapher: fc1 -> cross-graph conv -> fc2 -> DropPath
    residual -> FFN (4x hidden, the same drop_path). Returns the updated
    label embeddings and the (group-folded) label->patch edge indices."""

    def __init__(self, in_channels: int, k: int = 9, dilation: int = 1,
                 conv: str = "mr", act: str = "relu",
                 norm: str | None = "batch", use_bias: bool = True,
                 stochastic: bool = False, epsilon: float = 0.0,
                 drop_path: float = 0.0, use_multi_group: bool = True,
                 num_group: int = 2, graph_builder: str = "knn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = ConvNorm(in_channels, in_channels, dtype)
        self.graph_conv = LabelGraphConv(
            in_channels, in_channels * 2, k, dilation, conv, act, norm,
            use_bias, stochastic, epsilon,
            num_group if use_multi_group else 1, graph_builder, dtype)
        self.fc2 = ConvNorm(in_channels * 2, in_channels, dtype)
        self.drop_path = DropPath(drop_path)
        self.ffn = FFN(in_channels, in_channels * 4, act, drop_path, dtype)

    def forward(self, labels: torch.Tensor, feats: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b, h, w, c = feats.shape
        x, edge_idx = self.graph_conv(self.fc1(labels),
                                      feats.reshape(b, h * w, c), generator)
        x = self.drop_path(self.fc2(x), generator) + labels
        return self.ffn(x, generator), edge_idx
