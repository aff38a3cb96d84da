"""Neighbour gather and max-relative aggregation in plain PyTorch
(counterpart: ``gkgnet_tpu/ops/aggregate.py``), and the gather's backward.

  * ``gather_nodes``: ``y (B, M, C)`` gathered with ``idx (B, N, k)`` into
    ``(B, N, k, C)``; differentiable in y. Its backward
    (``gather_backward``) gives each target the sum of its incoming rows,
    in fp32 from 0.0 in ascending edge id ``(b*N + n)*k + j``, rounded once
    to y's type: on a CUDA tensor the hand-written kernel
    (``csrc/knn_mr_bwd.cu`` ``gather_backward``, no float atomics, bound
    and launched by ``ops/knn_mr.py`` ``launch_gather_backward``), on a
    CPU tensor its plain version ``gather_backward_reference``.
    ``torch.gather``'s own backward on the card is a scatter-add with
    float atomics, whose rounding changes from run to run (the JAX
    package's is XLA's scatter; it had no Pallas kernel).
    ``gather_backward_ordered_reference`` spells the order out, a check.
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


def _take(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    b, _, c = y.shape
    _, n, k = idx.shape
    flat = idx.reshape(b, n * k, 1).long().expand(b, n * k, c)
    return torch.gather(y, 1, flat).reshape(b, n, k, c)


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, idx):
        ctx.save_for_backward(idx)
        ctx.m = y.shape[1]
        return _take(y, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_backward(g, idx, ctx.m), None


def gather_nodes(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``y (B, M, C)``, ``idx (B, N, k)`` -> ``(B, N, k, C)``; y's gradient
    is ``gather_backward``'s."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _GatherNodes.apply(y, idx)
    return _take(y, idx)


def _flat_targets(idx: torch.Tensor, m: int) -> torch.Tensor:
    """idx (B, N, k) -> the flat target rows ``b * M + idx`` (int64), in
    edge order."""
    base = torch.arange(idx.shape[0], device=idx.device) * m
    return (idx.long() + base[:, None, None]).reshape(-1)


def check_gather_backward(g: torch.Tensor, idx: torch.Tensor) -> None:
    if g.dim() != 4 or idx.dim() != 3 or tuple(idx.shape) != g.shape[:3]:
        raise ValueError(f"g must be (B, N, k, C) and idx (B, N, k), got "
                         f"{tuple(g.shape)} and {tuple(idx.shape)}")


def gather_backward_reference(g: torch.Tensor, idx: torch.Tensor,
                              m: int) -> torch.Tensor:
    """Plain PyTorch backward of ``gather_nodes``: g ``(B, N, k, C)``, the
    gradient of its output, and idx ``(B, N, k)`` -> gy ``(B, m, C)`` in
    g's type, each target's rows summed in fp32 and rounded once. On the
    CPU ``index_add_`` adds the rows one at a time in index order, so the
    sum runs in ascending edge id, the kernel's order."""
    check_gather_backward(g, idx)
    b, _, _, c = g.shape
    gy = torch.zeros((b * m, c), dtype=torch.float32, device=g.device)
    gy.index_add_(0, _flat_targets(idx, m), g.reshape(-1, c).float())
    return gy.reshape(b, m, c).to(g.dtype)


def gather_backward_ordered_reference(g: torch.Tensor, idx: torch.Tensor,
                                      m: int) -> torch.Tensor:
    """``gather_backward_reference`` with the order spelled out: each
    target's fp32 sum starts at 0.0 and runs over its edges in ascending
    edge id, one add per edge. A loop over the rank r within the target:
    the r-th edge's row is gathered and added to every target with more
    than r edges. Slow (one pass per rank up to the largest in-degree); a
    check, never the CPU path."""
    check_gather_backward(g, idx)
    b, _, _, c = g.shape
    rows = g.reshape(-1, c)
    flat = _flat_targets(idx, m)
    order = torch.sort(flat, stable=True).indices  # by (target, edge id)
    count = torch.bincount(flat, minlength=b * m)
    first = torch.cumsum(count, 0) - count
    # at rank r the targets with more than r edges: a prefix of this order
    by_degree = torch.sort(count, descending=True, stable=True).indices
    alive = (count.numel() - torch.cumsum(torch.bincount(count), 0)).tolist()
    acc = torch.zeros((b * m, c), dtype=torch.float32, device=g.device)
    for r, live in enumerate(alive[:-1]):
        t = by_degree[:live]
        acc[t] = acc[t] + rows[order[first[t] + r]].float()
    return acc.reshape(b, m, c).to(g.dtype)


def gather_backward(g: torch.Tensor, idx: torch.Tensor,
                    m: int) -> torch.Tensor:
    """The backward of ``gather_nodes``: the kernel on a CUDA tensor
    (``ops/knn_mr.py`` ``launch_gather_backward``), the plain version on a
    CPU tensor."""
    if g.is_cuda:
        from gkgnet_tpu_torch.ops import knn_mr  # imports this module
        return knn_mr.launch_gather_backward(g, idx, m)
    return gather_backward_reference(g, idx, m)


def interleave_channels(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Two ``(..., C)`` tensors -> ``(..., 2C)`` as ``[x_0, m_0, x_1, m_1, ...]``."""
    return torch.stack([x, m], dim=-1).reshape(*x.shape[:-1], 2 * x.shape[-1])


def max_relative(x: torch.Tensor, idx: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor:
    """``max_k(y[idx] - x)`` per query node, in x's type: each
    ``rel_j = y[idx_j] - x`` rounded to it, as the fused kernel's backward
    contract and the JAX package's ``max_relative`` take it, so the tie
    sets that split the max's gradient are theirs (the max itself is the
    rounded max of the exact differences either way).

    Args:
      x: query/centre nodes ``(B, N, C)``.
      idx: ``(B, N, k)`` neighbour indices into the target set.
      y: target nodes ``(B, M, C)`` in x's type; ``None`` -> self (y = x).
    Returns:
      ``(B, N, C)`` aggregated relative features.
    """
    src = x if y is None else y
    if src.dtype != x.dtype:
        raise TypeError(f"x and y must share one type, got {x.dtype} and "
                        f"{src.dtype}")
    return torch.amax(gather_nodes(src, idx) - x[:, :, None, :], dim=2)


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
