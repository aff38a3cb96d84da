"""Traces, closed-form counters and timing (counterpart:
``gkgnet_tpu/utils/profiling.py``).

  * ``trace(log_dir)``: a ``torch.profiler`` context (host and, with a card,
    device activity) that writes a Chrome trace, ``<log_dir>/trace.json``;
  * ``model_edge_count`` and ``model_flops``: edges built and FLOPs per
    forward in closed form (numpy), from the port's ``ARCH_SETTINGS``;
  * ``timeit``: seconds per call, with CUDA events on the card and the host
    clock on the CPU;
  * the FLOP formulas of the port's kernel operators for
    ``torch.utils.flop_counter.FlopCounterMode``: the distance product,
    2 * BG * N * M * D per call (the selection, the gather and the
    max-relative are not counted, as the analytic count does not count
    them).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import register_flop_formula

from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS, REDUCE_RATIOS
from gkgnet_tpu_torch.ops import knn  # noqa: F401  (registers knn_topk)
from gkgnet_tpu_torch.ops import knn_mr  # noqa: F401  (registers knn_mr_*)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host activity and, when a card is present, its
    device activity; on exit write ``<log_dir>/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto, TensorBoard's profile plugin).
    Yields the profiler (``key_averages()`` for sums by kernel)."""
    os.makedirs(log_dir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def model_edge_count(arch: str, size: int, batch: int, k: int = 9,
                     k_label: int = 9, num_group: int = 2,
                     n_classes: int = 80, num_gcn: int = 1) -> int:
    """Edges built per forward pass: every Grapher block contributes
    BG * N * k spatial edges (the k kept after dilation) and every label
    GCN BG * n_classes * k_label cross edges. The blocks per stage are the
    arch's own (the JAX function counts (2, 2, 6, 2) for every arch)."""
    blocks = ARCH_SETTINGS[arch]["blocks"]
    bg = batch * num_group
    hw = size // 4
    n = hw * hw
    edges = 0
    label_taps = 0
    for i, nb in enumerate(blocks):
        edges += nb * bg * n * k
        n_label = num_gcn if i == len(blocks) - 1 else 1
        label_taps += n_label
        n //= 4
    edges += label_taps * bg * n_classes * k_label
    return edges


def model_flops(arch: str, size: int, batch: int = 1, n_classes: int = 80,
                num_gcn: int = 1) -> dict:
    """Closed-form forward-pass FLOPs (multiply+add = 2) per component, the
    JAX function's count: stem/downsample 3x3 convs, per-block fc1/fc2 1x1
    convs, the grouped BasicConv, the 4x FFN, the kNN distance product
    (2*N*M*C per block: g groups of C/g channels) and the label pathway;
    k, the groups and the dilation do not change it. (The JAX function's
    ``count_impl`` adds the one-hot gather products of the JAX fused
    kernel; the port's kernels gather by index.)

    Geometry: ARCH_SETTINGS (t/s/b), REDUCE_RATIOS (4, 2, 1, 1)."""
    opt = ARCH_SETTINGS[arch]
    blocks, channels = opt["blocks"], opt["channels"]
    c0 = channels[0]
    s2, s4 = (size // 2) ** 2, (size // 4) ** 2
    fl = {}
    # stem: 3->c0/2 (3x3, s2), c0/2->c0 (3x3, s2), c0->c0 (3x3, s1)
    fl["stem"] = 2 * 9 * (3 * (c0 // 2) * s2 + (c0 // 2) * c0 * s4
                          + c0 * c0 * s4)

    n = s4
    label_flops = 0
    for i, nb in enumerate(blocks):
        c = channels[i]
        if i > 0:
            n //= 4
            fl[f"downsample{i}"] = 2 * 9 * channels[i - 1] * c * n
        r = REDUCE_RATIOS[i]
        m = n // (r * r)
        stage = 0
        for _ in range(nb):
            stage += 2 * n * c * c                 # fc1
            stage += 2 * n * m * c                 # distance product
            stage += 2 * n * (2 * c) * (2 * c) // 4  # BasicConv groups=4
            stage += 2 * n * (2 * c) * c           # fc2
            stage += 16 * n * c * c                # FFN c->4c->c
        fl[f"stage{i}"] = stage
        # label tap at stage end
        n_label = num_gcn if i == len(blocks) - 1 else 1
        lt = 0
        for _ in range(n_label):
            lt += 2 * n_classes * c * c            # fc1
            lt += 2 * n_classes * n * c            # cross distance
            lt += 2 * n_classes * (2 * c) * (2 * c) // 4
            lt += 2 * n_classes * (2 * c) * c      # fc2
            lt += 16 * n_classes * c * c           # FFNLabel
        if i < len(blocks) - 1:
            lt += 2 * n_classes * c * channels[i + 1]  # label projection
        label_flops += lt
    fl["label_path"] = label_flops
    fl["head"] = 2 * n_classes * channels[-1] * 2
    fl["total"] = sum(fl.values())
    fl["per_image_total"] = fl["total"]
    fl["total"] *= batch
    return fl


def timeit(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``. When an argument is a tensor on
    the card: CUDA events around ``iters`` calls after ``warmup`` calls,
    the mean. Otherwise the median of the host clock over ``iters`` calls."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(warmup):
        fn(*args)
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _distance_flops(x_shape, y_shape) -> int:
    """2 * rows * N * M * D for x (rows, N, D) and y (rows, M, D); the
    grouped rows (B, N, g*D) give 2 * B * N * M * g*D, the same count."""
    rows, n, d = x_shape
    return 2 * rows * n * y_shape[1] * d


@register_flop_formula(torch.ops.gkgnet_tpu_torch.knn_mr_fused)
def _knn_mr_flops(x_shape, y_shape, *args, out_shape=None, **kwargs) -> int:
    return _distance_flops(x_shape, y_shape)


@register_flop_formula(torch.ops.gkgnet_tpu_torch.knn_mr_fused_grouped)
def _knn_mr_grouped_flops(x_shape, y_shape, *args, out_shape=None,
                          **kwargs) -> int:
    return _distance_flops(x_shape, y_shape)


@register_flop_formula(torch.ops.gkgnet_tpu_torch.knn_topk)
def _knn_topk_flops(x_shape, y_shape, *args, out_shape=None, **kwargs) -> int:
    return _distance_flops(x_shape, y_shape)
