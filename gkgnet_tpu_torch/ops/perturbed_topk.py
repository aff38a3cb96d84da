"""Differentiable (perturbed) top-k: soft neighbour selection (counterpart:
``gkgnet_tpu/ops/perturbed_topk.py``; Berthet et al.'s perturbed
optimizers, the reference's ``differentiable_topk``).

  * ``hard_topk_indicator(x, k)``: the ``(..., k, D)`` one-hot of the top-k
    of the scores ``x (..., D)``, indices in ascending order (the eval
    behaviour).
  * ``perturbed_topk(x, k, num_samples, sigma, generator)``: the mean over
    ``num_samples`` Gaussian perturbations ``x + sigma * z`` of that
    one-hot, differentiable in x with the perturbed-optimizer gradient
    ``E[onehot * z] / sigma`` (a ``torch.autograd.Function``). The noise
    is drawn from ``generator``; ``perturbed_topk_from_noise`` takes the
    noise itself, so that a test can feed both packages the same draw.
  * ``soft_knn_gather``: the differentiable cross-kNN gather of the
    ``graph_builder='perturbed'`` graph build: each query's soft
    neighbours among the L2-normalized targets, ``(B, N, k, C)``.

The JAX package materialises the ``(num_samples, ..., k, D)`` one-hot of
every sample. Here the selected indices are counted into the mean
indicator with a scatter (the counts are whole numbers, so the mean is
bitwise JAX's, which multiplies them by 1 / num_samples), and the backward scatters the noise at those indices, so
no per-sample one-hot is ever held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gkgnet_tpu_torch.ops.knn import l2_normalize, pairwise_sqdist


def _topk_sorted(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis (the lower index
    first among equal scores, as ``lax.top_k``), in ascending order."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :k], dim=-1).values


def hard_topk_indicator(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., D) scores -> (..., k, D) fp32 one-hot of the top-k, indices
    sorted ascending."""
    return F.one_hot(_topk_sorted(x, k), x.shape[-1]).float()


class _PerturbedTopK(torch.autograd.Function):
    """The mean one-hot of the perturbed top-k and its perturbed-optimizer
    gradient. ``noise`` is ``(num_samples,) + x.shape`` fp32."""

    @staticmethod
    def forward(ctx, x, noise, k, sigma):
        ns, d = noise.shape[0], x.shape[-1]
        idx = _topk_sorted(x[None].float() + noise * sigma, k)  # (nS,..,k)
        counts = torch.zeros(x.shape[:-1] + (k, d), dtype=torch.float32,
                             device=x.device)
        # (..., k, nS): sample s's index of slot j, counted at column idx
        per_slot = idx.movedim(0, -1)
        counts.scatter_add_(-1, per_slot, torch.ones_like(per_slot,
                                                          dtype=torch.float32))
        ctx.save_for_backward(per_slot, noise)
        ctx.sigma = sigma
        # XLA's mean: the sum times the fp32 reciprocal of the count
        return counts * (1.0 / ns)

    @staticmethod
    def backward(ctx, g):
        per_slot, noise = ctx.saved_tensors
        ns, d = noise.shape[0], noise.shape[-1]
        k = per_slot.shape[-2]
        # expected[..., j, c] = sum_s [idx_s(j) == c] z_s[..., c] / nS / sigma
        z = noise.movedim(0, -1)                       # (..., D, nS)
        z_at = torch.gather(z.unsqueeze(-3).expand(
            z.shape[:-2] + (k,) + z.shape[-2:]), -2,
            per_slot.unsqueeze(-2)).squeeze(-2)        # (..., k, nS)
        expected = torch.zeros(per_slot.shape[:-1] + (d,),
                               dtype=torch.float32, device=noise.device)
        expected.scatter_add_(-1, per_slot, z_at)
        expected = expected / ns / ctx.sigma
        return (g * expected).sum(-2), None, None, None


def perturbed_topk_from_noise(x: torch.Tensor, k: int, noise: torch.Tensor,
                              sigma: float) -> torch.Tensor:
    """``perturbed_topk`` on a given noise draw ``(num_samples,) + x.shape``
    (fp32): the soft top-k indicator ``(..., k, D)``, differentiable in
    x."""
    return _PerturbedTopK.apply(x, noise.float(), k, sigma)


def perturbed_topk(x: torch.Tensor, k: int, num_samples: int = 500,
                   sigma: float = 0.05,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Soft top-k indicator ``(..., k, D)``; differentiable wrt x. The
    noise is drawn from ``generator`` (a generator seeded 0 without one,
    as the JAX package takes key 0 without a key)."""
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    noise = torch.randn((num_samples,) + tuple(x.shape), generator=generator,
                        device=x.device, dtype=torch.float32)
    return perturbed_topk_from_noise(x, k, noise, sigma)


def soft_knn_gather(x: torch.Tensor, y: torch.Tensor, k: int, *,
                    num_samples: int = 20, sigma: float = 0.1,
                    dilation: int = 1,
                    generator: torch.Generator | None = None,
                    training: bool = True,
                    noise: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable cross-kNN gather ``(B, N, k, C)`` fp32: every
    ``dilation``-th of the ``k * dilation`` soft neighbours of each query
    of x ``(B, N, C)`` among the L2-normalized targets y ``(B, M, C)``.

    The distances carry no gradient; the result does through the
    normalized targets. In training the indicator is ``perturbed_topk``'s
    on the draw ``noise`` ``(num_samples, B, N, M)`` if given, else on one
    from ``generator``; otherwise the hard one."""
    xn = l2_normalize(x)
    yn = l2_normalize(y)
    scores = -pairwise_sqdist(xn, yn)                  # (B, N, M), no grad
    kd = k * dilation
    if not training:
        ind = hard_topk_indicator(scores, kd)
    elif noise is not None:
        ind = perturbed_topk_from_noise(scores, kd, noise, sigma)
    else:
        ind = perturbed_topk(scores, kd, num_samples, sigma, generator)
    x_j = torch.einsum("bmkn,bnc->bmkc", ind, yn.float())
    return x_j[:, :, ::dilation, :]
