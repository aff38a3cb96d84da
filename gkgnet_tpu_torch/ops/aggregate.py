"""Neighbour gather and max-relative aggregation in plain PyTorch
(counterpart: ``gkgnet_tpu/ops/aggregate.py``).

  * ``gather_nodes``: ``y (B, M, C)`` gathered with ``idx (B, N, k)`` into
    ``(B, N, k, C)``.
  * ``max_relative``: ``max_k(y[idx] - x)``, the 'mr' aggregation.
  * ``sum_neighbors`` / ``max_neighbors``: the sum / max of ``y[idx]`` over
    the k neighbours (the gin and sage aggregations).
  * ``interleave_channels``: ``[x_0, m_0, x_1, m_1, ...]``, the channel
    order of the reference's concat, which the grouped 1x1 conv after it
    depends on.
  * ``fold_groups`` / ``unfold_groups``: ``(B, N, g*D) <-> (B*g, N, D)``,
    the channel groups folded into the batch axis.
"""

from __future__ import annotations

import torch


def gather_nodes(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``y (B, M, C)``, ``idx (B, N, k)`` -> ``(B, N, k, C)``."""
    b, _, c = y.shape
    _, n, k = idx.shape
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    return torch.gather(y, 1, flat).reshape(b, n, k, c)


def interleave_channels(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Two ``(..., C)`` tensors -> ``(..., 2C)`` as ``[x_0, m_0, x_1, m_1, ...]``."""
    return torch.stack([x, m], dim=-1).reshape(*x.shape[:-1], 2 * x.shape[-1])


def max_relative(x: torch.Tensor, idx: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor:
    """``max_k(y[idx] - x)`` per query node, computed in fp32 and cast to
    ``x.dtype``.

    Args:
      x: query/centre nodes ``(B, N, C)``.
      idx: ``(B, N, k)`` neighbour indices into the target set.
      y: target nodes ``(B, M, C)``; ``None`` -> self (y = x).
    Returns:
      ``(B, N, C)`` aggregated relative features.
    """
    src = x if y is None else y
    rel = gather_nodes(src.float(), idx) - x.float()[:, :, None, :]
    return torch.amax(rel, dim=2).to(x.dtype)


def sum_neighbors(x: torch.Tensor, idx: torch.Tensor,
                  y: torch.Tensor | None = None) -> torch.Tensor:
    """``sum_k y[idx]`` per query node (y = x when ``None``), in the input
    type: ``(B, N, C)``."""
    return torch.sum(gather_nodes(x if y is None else y, idx), dim=2)


def max_neighbors(x: torch.Tensor, idx: torch.Tensor,
                  y: torch.Tensor | None = None) -> torch.Tensor:
    """``max_k y[idx]`` per query node (y = x when ``None``): ``(B, N, C)``."""
    return torch.amax(gather_nodes(x if y is None else y, idx), dim=2)


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
