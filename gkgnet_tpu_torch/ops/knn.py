"""Dynamic k-NN graph construction in plain PyTorch (counterpart:
``gkgnet_tpu/ops/knn.py``, deterministic mode only).

Contract:
  * features are L2-normalized in fp32 along the channel dim and rounded
    back to their own dtype before the distance,
  * squared euclidean distance ``|x|^2 - 2 x.y + |y|^2`` from fp32
    operands, plus an optional additive bias (the negated relative-position
    table),
  * neighbours are the ``k`` smallest distances in ascending order, the
    lowest target index first among equal distances (the order
    ``lax.top_k`` gives); a stable sort guarantees it where ``torch.topk``
    leaves the tie order unspecified,
  * dilation keeps every d-th of the ``k * d`` candidates.

Node tensors are channel-last ``(B, N, C)``. These functions are the plain
versions the graph-conv kernel is held against; nothing here launches a
hand-written kernel.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Divide by ``max(||x||, eps)`` in fp32 and round back to ``x.dtype``
    (torch ``F.normalize(p=2)`` semantics)."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return (x32 / torch.clamp(norm, min=eps)).to(x.dtype)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(B, N, C)`` queries, ``(B, M, C)`` targets -> ``(B, N, M)`` fp32
    squared distances."""
    x32 = x.detach().float()
    y32 = y.detach().float()
    inner = torch.bmm(x32, y32.transpose(1, 2))
    x_sq = torch.sum(x32 * x32, dim=-1, keepdim=True)
    y_sq = torch.sum(y32 * y32, dim=-1, keepdim=True)
    return x_sq - 2.0 * inner + y_sq.transpose(1, 2)


def knn_graph(
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    *,
    k: int,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """For every query node the indices of its ``k`` nearest targets, on
    L2-normalized features.

    Args:
      x: query nodes ``(B, N, C)``.
      y: target nodes ``(B, M, C)``; ``None`` for self-kNN (y = x).
      k: neighbours per query (callers pass ``k * dilation`` here).
      bias: optional additive distance bias ``(N, M)`` or ``(B, N, M)``.

    Returns:
      ``(B, N, k)`` int32 indices into the target set.
    """
    x = l2_normalize(x)
    y = x if y is None else l2_normalize(y)
    dist = pairwise_sqdist(x, y)
    if bias is not None:
        dist = dist + bias.float()
    _, order = torch.sort(dist, dim=-1, stable=True)
    return order[..., :k].to(torch.int32)


def dilate_edges(idx: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """Keep every d-th of the ``k * d`` neighbour candidates."""
    if dilation <= 1:
        return idx
    return idx[..., ::dilation]
