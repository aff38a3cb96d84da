"""2D sin-cos relative position tables (host-side numpy, built once per
model; counterpart: ``gkgnet_tpu/ops/pos_embed.py``).

  P = 2d-sincos positions over a sqrt(n) x sqrt(n) grid  (n, dim)
  rel = 2 * P @ P.T / dim                                 (n, n)
  table = -bicubic_resize(rel, (n, n // r^2))             (n, n_reduced)

Bicubic resize is linear, so the column resize is applied to P before the
product: ``rel_reduced = 2/dim * P @ (W_col @ P).T``; the (n, n)
intermediate is never built.
"""

from __future__ import annotations

import math

import numpy as np

from gkgnet_tpu_torch.ops.interpolate import bicubic_resize_matrix


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, 2*(embed_dim//2)) [sin | cos] features."""
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size^2, embed_dim) 2D sin-cos embedding; the first half of the
    channels encodes the fast (w) axis."""
    coords = np.arange(grid_size, dtype=np.float64)
    grid_w, grid_h = np.meshgrid(coords, coords)  # 'xy': both (H, W)
    emb_w = _sincos_1d(embed_dim // 2, grid_w)
    emb_h = _sincos_1d(embed_dim // 2, grid_h)
    return np.concatenate([emb_w, emb_h], axis=1)


def get_relative_pos_table(
    embed_dim: int, n: int, reduce_ratio: int = 1, dtype=np.float32
) -> np.ndarray:
    """The kNN distance bias a Grapher block adds: negated, column-resized
    to the pooled target count ``n // reduce_ratio^2``.

    Returns ``(n, n // reduce_ratio^2)``.
    """
    grid_size = int(math.isqrt(n))
    if grid_size * grid_size != n:
        raise ValueError(f"n={n} must be a perfect square")
    p = get_2d_sincos_pos_embed(embed_dim, grid_size)  # (n, d)
    n_reduced = n // (reduce_ratio * reduce_ratio)
    if n_reduced == n:
        rel = 2.0 * (p @ p.T) / p.shape[1]
    else:
        w_col = bicubic_resize_matrix(n, n_reduced)    # (n_reduced, n)
        rel = 2.0 * (p @ (w_col @ p).T) / p.shape[1]
    return (-rel).astype(dtype)
