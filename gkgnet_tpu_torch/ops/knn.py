"""Dynamic k-NN graph construction (counterpart: ``gkgnet_tpu/ops/knn.py``).

Contract:
  * features are L2-normalized in fp32 along the channel dim and rounded
    back to their own dtype before the distance,
  * squared euclidean distance ``|x|^2 - 2 x.y + |y|^2`` from fp32
    operands, plus an optional additive bias (the negated relative-position
    table),
  * neighbours are the ``k`` smallest distances in ascending order, the
    lowest target index first among equal distances (the order
    ``lax.top_k`` gives; a stable sort guarantees it where ``torch.topk``
    leaves the tie order unspecified), NaN distances last in column order,
  * dilation keeps every d-th of the ``k * d`` candidates, or, in training
    with stochastic dilation, with probability epsilon the first k of a
    random permutation of them.

Node tensors are channel-last ``(B, N, C)``. ``knn_topk_reference`` is the
plain version of the CUDA kernel behind ``ops.knn_topk.launch``;
``knn_graph`` normalizes and then calls the registered operator
``torch.ops.gkgnet_tpu_torch.knn_topk``, which takes the kernel for CUDA
tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from gkgnet_tpu_torch.ops import knn_topk


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


def knn_topk_reference(x: torch.Tensor, y: torch.Tensor, *, k: int,
                       bias: torch.Tensor | None = None,
                       return_values: bool = False):
    """Plain version of the kernel: for already-normalized queries
    ``(BG, N, D)`` and targets ``(BG, M, D)``, the ``k`` targets with the
    smallest fp32 distance (+ bias ``(N, M)`` or ``(BG, N, M)``) by a stable
    sort: the lowest index first among ties, NaN last. Returns idx
    ``(BG, N, k)`` int32, or ``(idx, vals)`` with the fp32 distances."""
    knn_topk.check_inputs(x, y, bias, k)
    dist = pairwise_sqdist(x, y)
    if bias is not None:
        dist = dist + bias.float()
    vals, order = torch.sort(dist, dim=-1, stable=True)
    idx = order[..., :k].to(torch.int32)
    return (idx, vals[..., :k].contiguous()) if return_values else idx


def knn_graph(
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    *,
    k: int,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """For every query node the indices of its ``k`` nearest targets, on
    L2-normalized features; no gradient flows through it.

    Args:
      x: query nodes ``(B, N, C)``.
      y: target nodes ``(B, M, C)``; ``None`` for self-kNN (y = x).
      k: neighbours per query (callers pass ``k * dilation`` here).
      bias: optional additive distance bias ``(N, M)`` or ``(B, N, M)``.

    Returns:
      ``(B, N, k)`` int32 indices into the target set: from the CUDA kernel
      for CUDA tensors, from ``knn_topk_reference`` for CPU tensors.
    """
    x = l2_normalize(x.detach())
    y = x if y is None else l2_normalize(y.detach())
    return _knn_topk_op(x, y, k, bias)


# The registered operator ``torch.ops.gkgnet_tpu_torch.knn_topk``: the
# dispatcher picks the kernel for CUDA tensors and the plain version for CPU
# tensors when the call runs, so an exported graph keeps the node (see
# ``ops/knn_mr.py``). The kernel is looked up at call time.
@torch.library.custom_op("gkgnet_tpu_torch::knn_topk", mutates_args=(),
                         device_types="cpu")
def _knn_topk_op(x: torch.Tensor, y: torch.Tensor, k: int,
                 bias: torch.Tensor | None) -> torch.Tensor:
    return knn_topk_reference(x, y, k=k, bias=bias)


@_knn_topk_op.register_kernel("cuda")
def _(x, y, k, bias):
    return knn_topk.launch(x, y, k=k, bias=bias)


@_knn_topk_op.register_fake
def _(x, y, k, bias):
    knn_topk.check_inputs(x, y, bias, k)
    return x.new_empty((x.shape[0], x.shape[1], k), dtype=torch.int32)


def dilate_edges(idx: torch.Tensor, *, dilation: int,
                 stochastic: bool = False, epsilon: float = 0.0,
                 generator: torch.Generator | None = None,
                 training: bool = False) -> torch.Tensor:
    """Subsample ``k * d`` neighbour candidates ``(..., k*d)`` to ``k``.

    Deterministic mode keeps every d-th candidate. Stochastic mode, in
    training only and with ``epsilon > 0``: one draw from ``generator``
    decides for the whole call; with probability ``epsilon`` it takes the
    candidates at the first k positions of one random permutation of the
    k*d instead (the same positions for every row). Raises without a
    generator there, as the JAX package raises without an rng key.
    """
    if dilation <= 1 and not (stochastic and training):
        return idx
    kd = idx.shape[-1]
    k = kd // max(dilation, 1)
    strided = idx[..., ::dilation]
    if not (stochastic and training and epsilon > 0.0):
        return strided
    if generator is None:
        raise ValueError("stochastic dilation at train time needs a "
                         "generator")
    gate = torch.rand((), generator=generator, device=generator.device)
    perm = torch.randperm(kd, generator=generator, device=generator.device)
    randsel = idx[..., perm[:k].to(idx.device)]
    # no host sync: both candidates exist and the draw picks on the device
    return torch.where(gate.to(idx.device) < epsilon, randsel, strided)
