"""Bicubic resize as a matrix, with torch ``F.interpolate(mode='bicubic',
align_corners=False)`` semantics (Keys kernel, A=-0.75, no antialias).

Host-side numpy, used once per model to build the relative-position
distance bias (counterpart: ``gkgnet_tpu/ops/interpolate.py``).
"""

from __future__ import annotations

import numpy as np

_A = -0.75  # torch/OpenCV bicubic coefficient


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x <= 1.0
    m2 = (x > 1.0) & (x < 2.0)
    out[m1] = ((_A + 2.0) * x[m1] - (_A + 3.0)) * x[m1] ** 2 + 1.0
    out[m2] = _A * (((x[m2] - 5.0) * x[m2] + 8.0) * x[m2] - 4.0)
    return out


def bicubic_resize_matrix(n_in: int, n_out: int, dtype=np.float64) -> np.ndarray:
    """Dense 1D resize matrix ``W (n_out, n_in)`` such that ``out = W @ in``
    reproduces torch bicubic (align_corners=False) along one axis. Border
    taps are clamped (replicate padding), as torch does."""
    scale = n_in / n_out
    i = np.arange(n_out, dtype=np.float64)
    src = (i + 0.5) * scale - 0.5
    fl = np.floor(src)
    t = src - fl
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for tap in range(-1, 3):
        tap_idx = np.clip(fl + tap, 0, n_in - 1).astype(np.int64)
        weight = _cubic_kernel(t - tap)
        np.add.at(w, (np.arange(n_out), tap_idx), weight)
    return w.astype(dtype)
