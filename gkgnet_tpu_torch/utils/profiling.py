"""The port's one tracing module: spans, the set-up table, traces,
closed-form counters and timing (counterpart of the last three:
``gkgnet_tpu/utils/profiling.py``).

  * ``span(name)``: a device span. While the current stream is capturing
    a CUDA graph it launches two empty one-thread kernels on that stream,
    ``gkgnet_span_begin_<name>`` and ``gkgnet_span_end_<name>``
    (``csrc/spans.cu``), which become nodes of the graph: every replay
    runs them in stream order, so on the device timeline of a profile
    everything between a begin and its end belongs to the span. Eager
    calls launch no marker. While a ``torch.profiler`` runs it also opens
    the host range ``gkgnet.<name>`` (``record_function``), so an eager
    call's op tree nests the same names. With no profiler and no capture
    it costs a flag test. The device spans: the model's ``stem``,
    ``stage1``-``stage4`` (the downsample and the stage's Grapher/FFN
    blocks), ``label1``-``label4`` (the stage's label GCN taps and the
    label projection) and ``head`` (the pooled feature), inside
    ``forward`` (the model call and the eval step's output transform);
    the train step's ``loss`` (the head's loss and ``parse_losses``),
    ``backward``, ``optimizer`` (global-norm clip and the update) and,
    where enabled, ``ema`` and ``loss_scale`` (the scaler's unscale and
    finite check, its restore and scale update, around ``optimizer``).
    No marker runs inside a registered operator or its autograd formula.
    A captured graph holds at most ``MAX_MARKERS`` markers;
  * ``host_span(name)``: the host range ``gkgnet.<name>`` alone, while a
    profiler runs: ``predict`` (the whole call), ``input`` (a request's
    copy to the card, a batch's normalize on the card), ``train_step``
    and ``eval_step`` (whole calls) with their ``.prepare`` (the host's
    part before the graph), ``graph.check``, ``graph.copy_in``,
    ``graph.replay``, ``graph.copy_out`` (``core/graphs.py``) and
    ``knn_mr.bwd`` (the operators' backward formula);
  * ``timed(name)``: a host range that always adds its count, total and
    longest host seconds to the process's set-up table (``table()``,
    ``reset()``); ``tally(name, key)`` counts beside them. The rows:
    ``setup.kernels`` (each ``ops/_build.load``; ``builds`` nvcc runs and
    ``cached`` loads), ``setup.native`` (``native.lib()``, the same
    counts), ``setup.model`` (``GKGNetClassifier.__init__``, the
    relative-position tables included), ``setup.optimizer``
    (``build_optimizer``), ``graph.warm`` (a signature's first, eager,
    call) and ``graph.capture`` (the capture and its first replay), both
    to the host's return (the card may still run their work);
  * ``trace(log_dir)``: a ``torch.profiler`` context (host and, with a
    card, device activity) that writes a Chrome trace,
    ``<log_dir>/trace.json``;
  * ``model_edge_count`` and ``model_flops``: edges built and FLOPs per
    forward in closed form (numpy), from the port's ``ARCH_SETTINGS``;
  * ``timeit``: seconds per call, with CUDA events on the card and the host
    clock on the CPU.

The kernel operators' FLOP formulas for ``FlopCounterMode`` are registered
beside the operators (``ops/knn.py``, ``ops/knn_mr.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"
PREFIX = "gkgnet."
MAX_MARKERS = 32

# markers launched in this process (a capture counts its graph's)
marker_launches = 0

_lib = None
_markers: dict[str, int] = {}   # span name -> the library's index
_markers_lock = threading.Lock()
_table: dict[str, dict] = {}
_table_lock = threading.Lock()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _capturing() -> bool:
    return torch.cuda.is_initialized() \
        and torch.cuda.is_current_stream_capturing()


def load_markers() -> None:
    """Builds or loads the marker library (``csrc/spans.cu``) and loads its
    kernels on the card, once: a capture calls it before it starts, since
    a stream that captures may not load a module."""
    global _lib
    with _markers_lock:
        if _lib is None:
            from gkgnet_tpu_torch.ops import _build
            lib = _build.load("spans")
            lib.gkgnet_span_count.restype = ctypes.c_int
            lib.gkgnet_span_name.argtypes = [ctypes.c_int]
            lib.gkgnet_span_name.restype = ctypes.c_char_p
            lib.gkgnet_span_load.restype = ctypes.c_int
            lib.gkgnet_span_mark.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]
            lib.gkgnet_span_mark.restype = ctypes.c_int
            lib.gkgnet_span_error_string.argtypes = [ctypes.c_int]
            lib.gkgnet_span_error_string.restype = ctypes.c_char_p
            _raise_on(lib, lib.gkgnet_span_load(), "loading the kernels")
            _markers.update({lib.gkgnet_span_name(i).decode(): i
                             for i in range(lib.gkgnet_span_count())})
            _lib = lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"span markers: {what} failed: "
                           f"{lib.gkgnet_span_error_string(err).decode()}")


def _mark(name: str, end: int) -> None:
    global marker_launches
    if _lib is None:
        load_markers()
    if name not in _markers:
        raise KeyError(f"csrc/spans.cu has no marker kernels for the span "
                       f"{name!r}")
    _raise_on(_lib, _lib.gkgnet_span_mark(
        _markers[name], end, torch.cuda.current_stream().cuda_stream),
        f"launching gkgnet_span_{('begin', 'end')[end]}_{name}")
    marker_launches += 1


class _Span:
    __slots__ = ("name", "device", "_range", "_marked")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self._range = None
        self._marked = False

    def __enter__(self):
        if self.device and _capturing():
            _mark(self.name, 0)
            self._marked = True
        if _profiling():
            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._marked:
            _mark(self.name, 1)
        return False


def span(name: str) -> _Span:
    """A device span (see the module's docstring): its markers while the
    current stream captures, its host range while a profiler runs."""
    return _Span(name, True)


def host_span(name: str) -> _Span:
    """The host range ``gkgnet.<name>`` while a profiler runs."""
    return _Span(name, False)


@contextlib.contextmanager
def timed(name: str):
    """Adds the block's host seconds to the set-up table's row ``name``
    (count, total, longest), and opens its host range while a profiler
    runs. Also a decorator."""
    t = time.perf_counter()
    with host_span(name):
        yield
    dt = time.perf_counter() - t
    with _table_lock:
        row = _table.setdefault(name, {"count": 0, "total_s": 0.0,
                                       "max_s": 0.0})
        row["count"] += 1
        row["total_s"] += dt
        row["max_s"] = max(row["max_s"], dt)


def tally(name: str, key: str, n: int = 1) -> None:
    """Adds ``n`` to the count ``key`` of the set-up table's row ``name``."""
    with _table_lock:
        row = _table.setdefault(name, {"count": 0, "total_s": 0.0,
                                       "max_s": 0.0})
        row[key] = row.get(key, 0) + n


def table() -> dict[str, dict]:
    """The set-up table: per row its ``count``, ``total_s``, ``max_s``
    and its tallies."""
    with _table_lock:
        return {k: dict(v) for k, v in _table.items()}


def reset() -> None:
    """Empties the set-up table."""
    with _table_lock:
        _table.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host activity and, when a card is present, its
    device activity; on exit write ``<log_dir>/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto, TensorBoard's profile plugin).
    Yields the profiler (``key_averages()`` for sums by kernel).

    The port's host ranges appear as ``gkgnet.<name>`` on the host threads
    (``gkgnet.predict``, ``gkgnet.graph.replay``, the model's stages in an
    eager call, ...). A graph replay runs no host code: its spans are the
    marker kernels on the device's stream, ``gkgnet_span_begin_<name>``
    and ``gkgnet_span_end_<name>``, and a span's kernels are those between
    the end of its begin marker and the start of its end marker on that
    stream (``forward`` holds ``stem`` ... ``head``; in training
    ``loss``, ``backward`` and ``optimizer`` follow it)."""
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
    from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS
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
    from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS, REDUCE_RATIOS
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
