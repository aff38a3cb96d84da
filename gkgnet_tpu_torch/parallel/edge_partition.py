"""The edge-partitioned kNN graph build and max-relative aggregate over a
mesh's graph group (counterpart: ``gkgnet_tpu/parallel/edge_partition.py``).

Each function takes this rank's shards and returns this rank's shards, with
global target indices, the contract of its JAX counterpart inside
``shard_map``: the query nodes are split over the graph group and each
rank selects against the whole candidate set, so no approximation enters;
idx is the unpartitioned build's.

``edge_partitioned_knn_mr`` has two schedules:

  * gather (``overlap=False``, the default): one all-gather of the target
    shards, then one ``knn_mr_fused`` call on this rank's queries with its
    rows of the bias: the fused CUDA kernel on this rank's N/s rows (its
    plain version on the CPU);
  * ring (``overlap=True``): s steps; each passes the shard in hand to the
    next rank (isend / irecv, started before the step's selection) and
    takes ``knn_topk(..., return_values=True)`` of this rank's queries
    against it with its columns of the bias; a running list merges each
    step's candidates exactly on the lexicographic (distance, global index)
    order -- the lowest index first among equal distances, the
    unpartitioned build's order -- then ``dilate_edges`` and the plain
    max-relative run on the assembled targets.

``label_sharded_knn_mr`` splits the TARGET axis instead (the label queries
are few and stay whole): each rank takes its local top-k*d against its M/s
slice with ``knn_topk(return_values=True)``, the candidate lists (padded
with ``inf`` / ``1 << 30`` where k*d exceeds the slice) are all-gathered and
merged the same way, each winner's features are fetched by the rank that
owns it and combined with a sum (every other rank adds exact zeros), and
the max-relative runs on every rank. ``replicated_knn_mr`` is the label
build where the targets do not divide: the fused call on the whole inputs.
``replicated_targets_knn_mr`` is the gather schedule where every rank
already holds the whole targets, as the model's graph convs do (see
``parallel/sharding.py``): no gather, and a backward that sums the ranks'
target gradients in one all-reduce.

Where ``knn_topk`` ranks rows of its own, they are normalized by the
fused kernel's own first kernel, ``l2norm_rows`` (``knn_normalize``), so
that on the card the ring's and the label build's distances are the fused
kernel's bit for bit and their idx the gather schedule's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gkgnet_tpu_torch.ops import knn_mr, knn_topk
from gkgnet_tpu_torch.ops.aggregate import gather_nodes, max_relative
from gkgnet_tpu_torch.ops.knn import (dilate_edges, knn_topk_reference,
                                      l2_normalize)
from gkgnet_tpu_torch.ops.knn_mr import knn_mr_fused
from gkgnet_tpu_torch.parallel import collectives
from gkgnet_tpu_torch.parallel.mesh import Mesh

PAD_INDEX = 1 << 30  # a padded candidate's index: sorts after every real one


def knn_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows L2-normalized as ``knn_mr_fused`` normalizes them: on a CUDA
    tensor by its kernel's own normalization (``knn_mr.launch_normalize``),
    on a CPU tensor as its plain version does (``l2_normalize``)."""
    return knn_mr.launch_normalize(x) if x.is_cuda else l2_normalize(x)


def _local_topk_vals(xn: torch.Tensor, yn: torch.Tensor,
                     bias: torch.Tensor | None, kd: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx, fp32 distances) of the kd nearest targets, lowest index first
    among ties: the knn_topk kernel on CUDA tensors, its plain version on
    CPU tensors."""
    if xn.is_cuda:
        return knn_topk.launch(xn, yn, k=kd, bias=bias, return_values=True)
    return knn_topk_reference(xn, yn, k=kd, bias=bias, return_values=True)


def lex_merge(vals: torch.Tensor, idx: torch.Tensor, kd: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kd smallest of candidate lists in lexicographic (distance,
    index) order, NaN distances last: a stable sort by index, then a stable
    sort by distance."""
    order = torch.sort(idx, dim=-1, stable=True).indices
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    order = torch.sort(vals, dim=-1, stable=True).indices[..., :kd]
    return vals.gather(-1, order), idx.gather(-1, order)


def _gather_schedule(mesh: Mesh, x_l, y_l, bias_l, k: int, dilation: int):
    y_full = collectives.all_gather(y_l, mesh.graph_group, dim=1)
    return knn_mr_fused(x_l, y_full, bias_l, k, dilation)


def _ring_schedule(mesh: Mesh, x_l, y_l, bias_l, k: int, dilation: int):
    s, me = mesh.graph, mesh.graph_rank
    bg, n_l, _ = x_l.shape
    m_l = y_l.shape[1]
    kd = k * dilation
    with torch.no_grad():
        xn = knn_normalize(x_l.detach())
        run_v = torch.full((bg, n_l, kd), torch.inf, device=x_l.device)
        run_i = torch.full((bg, n_l, kd), PAD_INDEX, dtype=torch.int32,
                           device=x_l.device)
        buf = y_l.detach()
        shards = [None] * s
        for step in range(s):
            shard = (me - step) % s
            offset = shard * m_l
            # start the next transfer before selecting on the shard in hand
            nxt = (collectives.RingTransfer(buf, mesh.graph_ranks, me,
                                            mesh.graph_group)
                   if step + 1 < s else None)
            shards[shard] = buf
            bias_c = None if bias_l is None \
                else bias_l[..., offset:offset + m_l].contiguous()
            cidx, cval = _local_topk_vals(xn, knn_normalize(buf), bias_c,
                                          min(kd, m_l))
            run_v, run_i = lex_merge(torch.cat([run_v, cval], -1),
                                     torch.cat([run_i, cidx + offset], -1),
                                     kd)
            if nxt is not None:
                buf = nxt.wait()
        whole = torch.cat(shards, dim=1)
    y_full = collectives.gathered(y_l, whole, mesh.graph_group, dim=1)
    idx = dilate_edges(run_i, dilation=dilation)
    return idx, max_relative(x_l, idx, y_full)


def edge_partitioned_knn_mr(mesh: Mesh, x: torch.Tensor,
                            y: torch.Tensor | None,
                            bias: torch.Tensor | None, *, k: int,
                            dilation: int = 1, overlap: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed kNN build + max-relative aggregate over the graph group.

    Args:
      x: (BG, N/s, C) this rank's block of the query nodes.
      y: (BG, M/s, C) this rank's block of the targets, or None for
         self-kNN (the targets are the queries).
      bias: None, or this rank's rows ``(N/s, M)`` (or ``(BG, N/s, M)``)
         of the fp32 distance bias.
      overlap: the ring schedule (else the gather).
    Returns:
      (idx (BG, N/s, k) int32 GLOBAL target indices, mr (BG, N/s, C)):
      this rank's rows of the unpartitioned build's.
    """
    y_l = x if y is None else y
    if bias is not None:
        bias = bias.contiguous()
    if overlap and mesh.graph > 1:
        return _ring_schedule(mesh, x, y_l, bias, k, dilation)
    return _gather_schedule(mesh, x, y_l, bias, k, dilation)


def replicated_targets_knn_mr(mesh: Mesh, x: torch.Tensor, y: torch.Tensor,
                              bias: torch.Tensor | None, *, k: int,
                              dilation: int = 1
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather schedule on targets every rank of the graph group holds
    whole: x (BG, N/s, C) this rank's block of the queries, y (BG, M, C)
    the whole targets, bias None or this rank's rows of it; one fused call
    (the kernel on the card). Returns this rank's rows of the unpartitioned
    build's ``(idx, mr)``, as ``edge_partitioned_knn_mr`` does; y's
    gradient is the sum of the ranks' (one all-reduce), the same on every
    rank."""
    if bias is not None:
        bias = bias.contiguous()
    return knn_mr_fused(x, collectives.replicated(y, mesh.graph_group), bias,
                        k, dilation)


def label_sharded_knn_mr(mesh: Mesh, x: torch.Tensor, y: torch.Tensor, *,
                         k: int, dilation: int = 1
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The label build with the target axis split over the graph group.

    Args:
      x: (BG, L, C) the label queries, whole on every rank.
      y: (BG, M/s, C) this rank's block of the stage's feature map.
    Returns:
      (idx (BG, L, k) int32 GLOBAL target indices, mr (BG, L, C)), whole
      and the same on every rank: the unpartitioned build's.
    """
    group, s = mesh.graph_group, mesh.graph
    m_l = y.shape[1]
    offset = mesh.graph_rank * m_l
    kd = k * dilation
    with torch.no_grad():
        xn = knn_normalize(x.detach())
        yn = knn_normalize(y.detach())
        kd_l = min(kd, m_l)
        cidx, cval = _local_topk_vals(xn, yn, None, kd_l)
        cidx = cidx + offset
        if kd_l < kd:  # more candidates wanted than the slice holds
            cval = F.pad(cval, (0, kd - kd_l), value=torch.inf)
            cidx = F.pad(cidx, (0, kd - kd_l), value=PAD_INDEX)
        if s > 1:
            cval = collectives.all_gather(cval, group, dim=2)
            cidx = collectives.all_gather(cidx, group, dim=2)
        _, win = lex_merge(cval, cidx, kd)
        idx = dilate_edges(win, dilation=dilation).contiguous()
        # the owner's fetch: each winner's row on the rank holding it
        local = (idx >= offset) & (idx < offset + m_l)
        lidx = (idx - offset).clamp(0, m_l - 1)
    x_j = torch.where(local[..., None], gather_nodes(y, lidx), 0.0)
    x_j = collectives.all_reduce_replicated(x_j.to(y.dtype), group)
    # in the input type, as max_relative: the max's gradient splits over
    # the fused kernel's (and the JAX build's) tie sets
    return idx, torch.amax(x_j - x[:, :, None, :], dim=2)


def replicated_knn_mr(mesh: Mesh, x: torch.Tensor, y: torch.Tensor, *,
                      k: int, dilation: int = 1
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The label build under a graph group whose size does not divide the
    targets: x (BG, L, C) and y (BG, M, C) whole on every rank, and the
    fused call on them on each (the kernel on the card), the same result on
    every rank."""
    del mesh
    return knn_mr_fused(x, y, None, k, dilation)
