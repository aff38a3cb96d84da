"""The graph-sharding context (counterpart:
``gkgnet_tpu/parallel/sharding.py``).

Inside ``with graph_sharding(mesh):`` the model runs data- and
graph-parallel over the mesh: BatchNorm reduces its train-mode moments
over the data group, DropPath draws its per-sample masks for the global
batch and keeps this rank's rows, and the graph convs route through the
edge-partitioned functions of ``parallel/edge_partition.py`` where the
JAX package does. Outside the context every hook here is a no-op that
returns its input or 1, so a single-device run pays nothing.

The JAX package leaves the layout outside the graph convs to GSPMD. Here
each rank of a graph group keeps its data shard's activations whole (the
stem, FFNs, downsamples, BatchNorm and head run alike on every rank of the
group), and ``shard_nodes`` is the boundary of a partitioned conv:
'queries' (and, on the ring, 'targets') enter it (this rank's contiguous
block of rows; the backward all-gathers the blocks' gradients) and
'nodes' leave it (the blocks all-gathered; the backward keeps this rank's
block). The gather schedule takes the whole targets as every rank holds
them, and its backward sums the ranks' target gradients
(``edge_partition.replicated_targets_knn_mr``). Every rank of a graph
group then ends the backward with the same parameter gradients as one
rank that held the whole data shard.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import NamedTuple

import torch

from gkgnet_tpu_torch.parallel import collectives
from gkgnet_tpu_torch.parallel.mesh import Mesh

_ACTIVE: ContextVar = ContextVar("graph_sharding_cfg", default=None)


class GraphShardingCfg(NamedTuple):
    mesh: Mesh
    # The schedule of the edge-partitioned kNN: one all-gather of the
    # target shards (False, the default) or a ring of s steps that passes
    # them on while each step selects on the shard in hand (True). The JAX
    # package chose the gather by default (its analysis: the targets are
    # pooled and small, so the transfer the ring hides is a sliver of the
    # selection, while the ring pays s launches and an exact merge).
    overlap: bool = False


@contextmanager
def graph_sharding(mesh: Mesh, overlap: bool = False):
    token = _ACTIVE.set(GraphShardingCfg(mesh, overlap))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_graph_cfg() -> GraphShardingCfg | None:
    return _ACTIVE.get()


def graph_axis_size() -> int:
    cfg = _ACTIVE.get()
    return 1 if cfg is None else cfg.mesh.graph


def data_axis_size() -> int:
    cfg = _ACTIVE.get()
    return 1 if cfg is None else cfg.mesh.data


def data_group():
    """The process group BatchNorm reduces its moments over, or None."""
    cfg = _ACTIVE.get()
    return None if cfg is None else cfg.mesh.data_group


def global_rows(n: int) -> tuple[int, int]:
    """``(rows of the global batch, this rank's first row)`` for a local
    batch of n rows: per-sample draws are taken for the global batch and
    each rank keeps its own, so a step is the same on any world size."""
    cfg = _ACTIVE.get()
    return n * data_axis_size(), 0 if cfg is None else n * cfg.mesh.data_rank


def shard_nodes(x: torch.Tensor | None, kind: str) -> torch.Tensor | None:
    """The boundary of a partitioned graph conv on node tensors
    ``(BG, rows, C)`` (or edges ``(BG, rows, k)``):

      'queries', 'targets' -- enter: this rank's contiguous block of rows;
      'nodes', 'edges'     -- leave: the ranks' blocks all-gathered.

    The identity outside the context or on a graph axis of 1."""
    cfg = _ACTIVE.get()
    if cfg is None or x is None or cfg.mesh.graph == 1:
        return x
    group = cfg.mesh.graph_group
    if kind in ("queries", "targets"):
        return collectives.scatter_rows(x, group, dim=1)
    if kind in ("nodes", "edges"):
        return collectives.gather_rows(x, group, dim=1)
    raise ValueError(kind)
