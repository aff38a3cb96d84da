"""Grapher blocks: dynamic k-NN graph convolution over the patch grid and the
label->patch cross-graph, single-device, with DropPath residuals in train
mode (counterpart: ``gkgnet_tpu/nn/grapher.py``).

Group folding: with ``num_group=g`` the channel dim is split into g groups
folded into the batch axis; each group builds its own k-NN edge set over its
C/g-dim features. After the aggregate the groups are unfolded and, for 'mr'
and 'gat', the centre and aggregate features are channel-interleaved before
the grouped 1x1 conv.

Under an active graph axis (``parallel.sharding.graph_sharding`` over a
mesh with graph > 1) the fused 'mr' route splits its work over the graph
group, as the JAX package's does: a spatial conv whose queries and targets
divide by the axis takes this rank's block of the queries against the
whole targets every rank holds (``parallel.edge_partition.
replicated_targets_knn_mr``, the gather schedule) or, with ``overlap``,
against its block of the targets (``edge_partitioned_knn_mr``'s ring), a
label conv ``label_sharded_knn_mr`` on its block of the targets
(``replicated_knn_mr`` where they do not divide); the grouped route stays
off and the perturbed build is not partitioned.

Three routes, chosen as the JAX package chooses them:
  * the 'mr' aggregator outside stochastic training goes through
    ``knn_mr_fused``: the fused CUDA kernel for CUDA tensors, its plain
    version for CPU tensors;
  * with ``GKGNET_GROUPED=1`` in the environment and channel groups
    (``num_group > 1``), that 'mr' route goes through
    ``knn_mr_fused_grouped`` on the unfolded nodes instead: the same
    numbers without the fold and unfold copies around the call (the
    group-strided CUDA kernel for CUDA tensors); the edge indices still
    come back in the folded ``(B*g, N, k)`` layout;
  * every other aggregator ('edge', 'sage', 'gin', 'gat'), and 'mr' with
    stochastic dilation in training (epsilon > 0), builds the graph with
    ``knn_graph`` (the knn_topk CUDA kernel for CUDA tensors; a spatial
    conv's ``knn_chunk`` tiles the plain build's query rows), subsamples
    it with ``dilate_edges`` and aggregates in plain PyTorch. Only 'mr'
    composes with group folding.

``graph_builder='perturbed'`` (with 'mr' only) replaces the graph by the
differentiable soft gather of ``ops.perturbed_topk.soft_knn_gather``: the
perturbed top-k of the (bias-free) distances in training, drawn from the
generator, the hard top-k in eval; the aggregate is
``max_k(x_j - x)`` of the soft neighbours of the L2-normalized targets, as
in the JAX package, and the conv returns no edge indices.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from gkgnet_tpu_torch.nn.layers import (FFN, BasicConv, ConvNorm, DropPath,
                                        PointwiseConv, avg_pool_nhwc)
from gkgnet_tpu_torch.ops.aggregate import (fold_groups, gather_nodes,
                                            interleave_channels, max_relative,
                                            sum_neighbors, unfold_groups)
from gkgnet_tpu_torch.ops.knn import dilate_edges, knn_graph
from gkgnet_tpu_torch.ops.knn_mr import knn_mr_fused, knn_mr_fused_grouped
from gkgnet_tpu_torch.ops.perturbed_topk import soft_knn_gather
from gkgnet_tpu_torch.parallel import edge_partition
from gkgnet_tpu_torch.parallel.sharding import (active_graph_cfg,
                                                graph_axis_size, shard_nodes)

CONVS = ("mr", "edge", "sage", "gin", "gat")
GRAPH_BUILDERS = ("knn", "perturbed")


def _grouped_enabled() -> bool:
    """The fold-aware grouped route is opt-in (``GKGNET_GROUPED=1``), read
    at every call, as the JAX package reads it; the default is the fold +
    folded-kernel route."""
    return os.environ.get("GKGNET_GROUPED", "0") == "1"


def _check_builder(graph_builder: str, conv: str) -> None:
    if graph_builder not in GRAPH_BUILDERS:
        raise ValueError(f"unknown graph_builder '{graph_builder}'")
    if graph_builder == "perturbed" and conv != "mr":
        raise ValueError("graph_builder='perturbed' requires conv='mr'")


def _soft_maxrel(conv: nn.Module, xn: torch.Tensor, y: torch.Tensor | None,
                 generator: torch.Generator | None) -> torch.Tensor:
    """The perturbed graph build's 'mr' aggregate ``max_k(x_j - x)`` over
    the soft neighbours x_j (``soft_knn_gather``, with the reference's
    num_samples 20 and sigma 0.1), in the dtype of the nodes."""
    if conv.training and generator is None:
        raise ValueError("the perturbed graph build at train time needs a "
                         "generator")
    x_j = soft_knn_gather(xn, xn if y is None else y, conv.k,
                          dilation=conv.dilation, generator=generator,
                          training=conv.training)
    return torch.amax(x_j.to(xn.dtype) - xn[:, :, None, :], dim=2)


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
                y: torch.Tensor | None, maxrel: torch.Tensor | None = None,
                unfolded: bool = False) -> torch.Tensor:
        """``unfolded``: x and maxrel arrive unfolded ``(B, N, C)`` (the
        fold-aware route; 'mr' only)."""
        if self.conv == "mr":
            g = 1 if unfolded else self.num_group
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


def _fused_route(conv: nn.Module) -> bool:
    """Whether a graph conv takes the fused 'mr' route (the kernel builds
    the graph and the aggregate)."""
    stochastic_now = conv.stochastic and conv.training and conv.epsilon > 0.0
    return conv.conv == "mr" and not stochastic_now


def _grouped_route(conv: nn.Module) -> bool:
    """Whether a graph conv takes the fold-aware fused route (never under a
    graph axis above 1, as in the JAX package)."""
    return (_fused_route(conv) and conv.num_group > 1 and _grouped_enabled()
            and graph_axis_size() == 1)


def _partitioned_route(conv: nn.Module, n: int, m: int) -> bool:
    """Whether a spatial graph conv with n queries and m targets splits its
    queries over an active graph axis: the fused 'mr' route, with n and m
    dividing by the axis (``gkgnet_tpu/nn/grapher.py``'s condition; each
    rank holds its own batch rows, so the batch always divides)."""
    gs = graph_axis_size()
    return gs > 1 and _fused_route(conv) and n % gs == 0 and m % gs == 0


def _run_partitioned(conv: nn.Module, xn: torch.Tensor,
                     y: torch.Tensor | None, bias: torch.Tensor | None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge-partitioned build of folded queries xn ``(BG, N, D)`` and
    targets y (None: self-kNN), both whole on every rank: this rank's block
    of the queries in, the whole ``(idx, maxrel)`` out
    (``parallel.sharding.shard_nodes``). The gather schedule takes the
    whole targets as they are; the ring passes this rank's block of them
    round the group."""
    cfg = active_graph_cfg()
    x_l = shard_nodes(xn, "queries")
    bias_l = None
    if bias is not None:
        n_l = x_l.shape[1]
        first = cfg.mesh.graph_rank * n_l
        bias_l = bias[..., first:first + n_l, :]
    if cfg.overlap:
        idx, maxrel = edge_partition.edge_partitioned_knn_mr(
            cfg.mesh, x_l, None if y is None else shard_nodes(y, "targets"),
            bias_l, k=conv.k, dilation=conv.dilation, overlap=True)
    else:
        idx, maxrel = edge_partition.replicated_targets_knn_mr(
            cfg.mesh, x_l, xn if y is None else y, bias_l, k=conv.k,
            dilation=conv.dilation)
    return shard_nodes(idx, "edges"), shard_nodes(maxrel, "nodes")


def _run_grouped(conv: nn.Module, x: torch.Tensor, y: torch.Tensor,
                 bias: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold-aware route on unfolded nodes x ``(B, N, C)`` and targets y
    ``(B, M, C)``: the mixed aggregate ``(B, N, out_channels)`` and the
    edge indices in the folded ``(B*g, N, k)`` layout."""
    g = conv.num_group
    idx, maxrel = knn_mr_fused_grouped(x, y, bias, conv.k, conv.dilation, g)
    out = conv.gconv(x, None, None, maxrel, unfolded=True)
    b, n = x.shape[:2]
    return out, idx.permute(0, 2, 1, 3).reshape(b * g, n, conv.k)


def _build_edges(conv: nn.Module, xn: torch.Tensor, y: torch.Tensor | None,
                 bias: torch.Tensor | None,
                 generator: torch.Generator | None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The graph of one graph conv and, on the fused route, its 'mr'
    aggregate: ``(idx (BG, N, k), maxrel or None)``."""
    if _fused_route(conv):
        return knn_mr_fused(xn, xn if y is None else y, bias, conv.k,
                            conv.dilation)
    idx = knn_graph(xn, y, k=conv.k * conv.dilation, bias=bias,
                    query_chunk=conv.knn_chunk)
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
                 dtype: torch.dtype = torch.float32,
                 knn_chunk: int | None = None):
        """``knn_chunk``: query rows per tile of the plain graph build."""
        super().__init__()
        _check_builder(graph_builder, conv)
        self.k, self.dilation, self.r, self.num_group = k, dilation, r, num_group
        self.conv, self.stochastic, self.epsilon = conv, stochastic, epsilon
        self.graph_builder, self.knn_chunk = graph_builder, knn_chunk
        self.out_channels = out_channels
        self.gconv = GraphAggregate(conv, in_channels, out_channels, act,
                                    norm, use_bias, num_group, dtype)

    def forward(self, x: torch.Tensor, rel_pos: torch.Tensor | None,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``generator`` feeds the stochastic dilation's and the perturbed
        build's draws. The edge indices are None with the perturbed build."""
        b, h, w, c = x.shape
        g = self.num_group
        x_nodes = x.reshape(b, h * w, c)
        y_nodes = None
        if self.r > 1:
            y_nodes = avg_pool_nhwc(x, self.r).reshape(b, -1, c)
        if self.graph_builder == "perturbed":
            xn = fold_groups(x_nodes, g)
            y = None if y_nodes is None else fold_groups(y_nodes, g)
            out = self.gconv(xn, None, y, _soft_maxrel(self, xn, y, generator))
            return out.reshape(b, h, w, self.out_channels), None
        if _grouped_route(self):
            x_nodes = x_nodes.contiguous()  # the kernel takes contiguous rows
            out, idx = _run_grouped(
                self, x_nodes,
                x_nodes if y_nodes is None else y_nodes.contiguous(), rel_pos)
            return out.reshape(b, h, w, self.out_channels), idx
        xn = fold_groups(x_nodes, g)
        y = None if y_nodes is None else fold_groups(y_nodes, g)
        if _partitioned_route(self, xn.shape[1],
                              xn.shape[1] if y is None else y.shape[1]):
            idx, maxrel = _run_partitioned(self, xn, y, rel_pos)
        else:
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
        _check_builder(graph_builder, conv)
        self.k, self.dilation, self.num_group = k, dilation, num_group
        self.conv, self.stochastic, self.epsilon = conv, stochastic, epsilon
        self.graph_builder, self.knn_chunk = graph_builder, None
        self.gconv = GraphAggregate(conv, in_channels, out_channels, act,
                                    norm, use_bias, num_group, dtype)

    def forward(self, labels: torch.Tensor, feats: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        if self.graph_builder == "perturbed":
            g = self.num_group
            xn, yn = fold_groups(labels, g), fold_groups(feats, g)
            return self.gconv(xn, None, yn,
                              _soft_maxrel(self, xn, yn, generator)), None
        if _grouped_route(self):
            return _run_grouped(self, labels.contiguous(),
                                feats.contiguous(), None)
        g = self.num_group
        xn = fold_groups(labels, g)                   # (B*g, L, C/g)
        yn = fold_groups(feats, g)                    # (B*g, N, C/g)
        gs = graph_axis_size()
        if gs > 1 and _fused_route(self):
            # the label queries stay whole: the targets split over the
            # graph axis where they divide, else the whole build on every
            # rank
            mesh = active_graph_cfg().mesh
            if yn.shape[1] % gs == 0:
                idx, maxrel = edge_partition.label_sharded_knn_mr(
                    mesh, xn, shard_nodes(yn, "targets"), k=self.k,
                    dilation=self.dilation)
            else:
                idx, maxrel = edge_partition.replicated_knn_mr(
                    mesh, xn, yn, k=self.k, dilation=self.dilation)
        else:
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
                 dtype: torch.dtype = torch.float32,
                 knn_chunk: int | None = None):
        super().__init__()
        self.fc1 = ConvNorm(in_channels, in_channels, dtype)
        self.graph_conv = SpatialGraphConv(
            in_channels, in_channels * 2, k, dilation, conv, act, norm,
            use_bias, stochastic, epsilon, r,
            num_group if use_multi_group else 1, graph_builder, dtype,
            knn_chunk)
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
