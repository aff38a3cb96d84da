"""Fused kNN graph + max-relative aggregate: the port of the TPU kernel
``gkgnet_tpu/ops/pallas/knn_mr.py::knn_mr_fused``.

``knn_mr_fused(x, y, bias, k, dilation) -> (idx, mr)``:
  * x ``(BG, N, D)`` raw queries, y ``(BG, M, D)`` raw targets, bfloat16 or
    float32, one type for both;
  * bias: optional fp32 distance bias ``(N, M)`` or ``(BG, N, M)``;
  * idx ``(BG, N, k)`` int32: of the ``k * dilation`` targets nearest to
    each query (L2-normalized features, fp32 squared distances plus bias,
    the lowest column first among equal distances), every dilation-th;
  * mr ``(BG, N, D)``: ``max_j(y[idx_j] - x)`` on the raw features in fp32,
    cast to the input type.

``knn_mr_fused`` is differentiable in x and y (the registered operator
``torch.ops.gkgnet_tpu_torch.knn_mr_fused`` with its autograd formula); the
graph build gets no gradient, as in the JAX package. Its backward, the
port of ``gkgnet_tpu/ops/pallas/knn_mr.py::_bwd_pallas``, recomputes
``rel_j = y[idx_j] - x`` in the input type from the saved idx, splits each
channel's gradient equally among the tied maxima (``g / cnt``, rounded to
the input type) and scatter-adds it into gy in fp32, rounded once; gx is
``-g``. When y is x, autograd sums the two into the one input.

``knn_mr_fused_grouped(x, y, bias, k, dilation, groups) -> (idx, mr)`` is
the fold-aware variant, the port of ``knn_mr.py::knn_mr_fused_grouped``:
x ``(B, N, g*D)`` and y ``(B, M, g*D)`` arrive unfolded, group gi is
channels ``[gi*D, (gi+1)*D)``, bias is None or ``(N, M)``; idx comes back
``(B, N, g, k)`` and mr ``(B, N, g*D)``, bitwise
``unfold(knn_mr_fused(fold x, fold y))``. Its backward reads the unfolded
rows as they are, with no fold copy, and gives bitwise what fold -> the
folded backward -> unfold gives (the JAX package's ``_bwd_grouped``).

On a CUDA tensor the wrappers launch the hand-written kernels in
``csrc/knn_mr.cu`` (forward, folded and grouped: for bfloat16 rows the
tensor-core scan of ``csrc/knn_scan.cuh``, its products exact and summed in
fp32 by the tensor cores, rows too wide for its whole-row layout, D past
~780, taking its D-chunked instantiations, bitwise the same; for float32
rows the CUDA-core scan of ``csrc/knn_scan_f32.cuh``, register-blocked
fmaf fed by cp.async, one layout for every D) and ``csrc/knn_mr_bwd.cu``
(backward, folded and group-strided: an inverse edge list built by its own
counting sort, each target's sum in ascending edge id), and raise if they
cannot; on a CPU tensor they run
``knn_mr_reference``, ``knn_mr_grouped_reference``,
``knn_mr_backward_reference`` and ``knn_mr_grouped_backward_reference``,
the plain PyTorch versions of the same functions.
``knn_mr_backward_ordered_reference`` is the plain backward with the
kernel's summation order, a check. ``launch_normalize`` launches the
forward's row normalization (``l2norm_rows``) alone: rows normalized bit
for bit as the fused forward normalizes them, for the edge-partitioned
builds that rank rows with ``knn_topk``. ``launch_gather_backward``
launches the same file's ``gather_backward``, the backward of
``aggregate.gather_nodes`` on the card. ``launches``, ``grouped_launches``,
``backward_launches``, ``normalize_launches`` and
``gather_backward_launches`` count the kernels' launches (one backward
launch per call, folded or grouped). The operators' backward runs in the
host range ``gkgnet.knn_mr.bwd`` while a profiler runs, and their FLOP
formula for ``FlopCounterMode`` is ``knn.distance_flops``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from gkgnet_tpu_torch.ops import _build
from gkgnet_tpu_torch.ops.aggregate import (
    _flat_targets, check_gather_backward, fold_groups,
    gather_backward_ordered_reference, gather_backward_reference,
    gather_nodes, max_relative, unfold_groups)
from gkgnet_tpu_torch.ops.knn import (dilate_edges, distance_flops,
                                      knn_topk_reference, l2_normalize)
from gkgnet_tpu_torch.utils import profiling

# Kernel launches since the last reset; each wrapper adds one per launch.
launches = 0
grouped_launches = 0
backward_launches = 0
normalize_launches = 0
gather_backward_launches = 0
COUNTERS = ("launches", "grouped_launches", "backward_launches",
            "normalize_launches", "gather_backward_launches")

MAX_KD = 64  # largest k * dilation the kernel's register lists hold
MAX_BWD_K = 64  # largest k of the backward kernel's per-channel tie masks
MAX_BWD_CHUNKS = 256  # most 16-byte chunks of a row in the backward kernel
MAX_GATHER_BATCH = 65535  # most batch rows of the gather backward's grid

# Test hooks. _FORCE_CHUNKED: the bfloat16 folded forward takes its
# D-chunked scan at every width (the results are bitwise the same); by
# default it takes it only where the whole-row layout does not fit.
# _FP32_BLOCK: None, or (query rows, column groups) of the float32 kernels'
# blocks (rows 8, 16, 32 or 64, groups 1, 2 or 4, 4 * rows * groups <= 256)
# in place of the shape the host picks (the results are bitwise the same).
_FORCE_CHUNKED = False
_FP32_BLOCK = None

_DTYPES = (torch.bfloat16, torch.float32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_mr")
    if lib.knn_mr_forward.argtypes is None:
        lib.knn_mr_forward.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.knn_mr_forward.restype = ctypes.c_int
        lib.knn_mr_forward_grouped.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.knn_mr_forward_grouped.restype = ctypes.c_int
        lib.knn_mr_error_string.argtypes = [ctypes.c_int]
        lib.knn_mr_error_string.restype = ctypes.c_char_p
        lib.knn_mr_smem_bytes.argtypes = [ctypes.c_int] * 9 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.knn_mr_smem_bytes.restype = ctypes.c_longlong
        lib.knn_l2norm.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.knn_l2norm.restype = ctypes.c_int
    return lib


def _fp32_block() -> tuple[int, int]:
    return _FP32_BLOCK if _FP32_BLOCK is not None else (0, 0)


def block_layout(d: int, kd: int, dtype: torch.dtype = torch.float32,
                 bg: int = 1, n: int = 1, m: int = 64) -> tuple[int, bool]:
    """``(bytes, chunked)``: the dynamic shared memory of one block of the
    folded forward at row width ``d`` and ``k * dilation = kd`` in
    ``dtype`` (bfloat16, else the float32 kernel), and whether that block
    runs the bfloat16 D-chunked scan (taken where the whole-row layout does
    not fit, or under ``_FORCE_CHUNKED``; the float32 kernel has one layout
    for every D, whose block depends on the call's ``bg`` batch-groups of
    ``n`` query rows and ``m`` targets: ``fp32_block``); 0 bytes where no
    block fits. Builds the kernel if needed."""
    b = _lib().knn_mr_smem_bytes(d, kd, int(dtype == torch.bfloat16),
                                 int(_FORCE_CHUNKED), bg, n, m,
                                 *_fp32_block(), None)
    return abs(b), b < 0


def fp32_block(bg: int, n: int, m: int, kd: int) -> tuple[int, int]:
    """``(query rows, column groups)`` of the float32 forward's blocks for
    ``bg`` batch-groups of ``n`` query rows, ``m`` targets and ``k *
    dilation = kd`` (``_FP32_BLOCK`` where set). Builds the kernel if
    needed."""
    shape = (ctypes.c_int * 2)()
    _lib().knn_mr_smem_bytes(1, kd, 0, 0, bg, n, m, *_fp32_block(), shape)
    return shape[0], shape[1]


def _check(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None,
           k: int, dilation: int) -> None:
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError(f"x and y must be (BG, N, D) / (BG, M, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    bg, n, d = x.shape
    m = y.shape[1]
    if y.shape[0] != bg or y.shape[2] != d:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ "
                         f"in batch or channels")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"x and y must share one of {_DTYPES}, got "
                        f"{x.dtype} and {y.dtype}")
    if k < 1 or dilation < 1 or k * dilation > m:
        raise ValueError(f"need 1 <= k * dilation <= M, got k={k}, "
                         f"dilation={dilation}, M={m}")
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError(f"bias must be float32, got {bias.dtype}")
        if tuple(bias.shape) not in ((n, m), (bg, n, m)):
            raise ValueError(f"bias must be ({n}, {m}) or ({bg}, {n}, {m}), "
                             f"got {tuple(bias.shape)}")


def knn_mr_reference(x: torch.Tensor, y: torch.Tensor,
                     bias: torch.Tensor | None, k: int,
                     dilation: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``l2_normalize`` + ``knn_topk_reference`` +
    ``dilate_edges`` + ``max_relative``, the path the JAX package takes
    without its kernel (never a kernel, whatever the device)."""
    _check(x, y, bias, k, dilation)
    idx = knn_topk_reference(l2_normalize(x), l2_normalize(y),
                             k=k * dilation, bias=bias)
    idx = dilate_edges(idx, dilation=dilation)
    return idx, max_relative(x, idx, y)


def _check_launch(x: torch.Tensor, y: torch.Tensor,
                  bias: torch.Tensor | None, kd: int) -> bool:
    """The kernel's own limits on inputs that passed ``_check``; returns
    whether y is x."""
    tensors = [x, y] + ([bias] if bias is not None else [])
    for name, t in zip(("x", "y", "bias"), tensors):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kd > MAX_KD:
        raise ValueError(f"k * dilation = {kd} exceeds the kernel's "
                         f"{MAX_KD}")
    if (x.shape[1] + 7) // 8 > 65535:  # the grid's y extent: 8 rows a block
        raise ValueError(f"N = {x.shape[1]} query rows exceed the kernel's "
                         f"grid")
    return y.data_ptr() == x.data_ptr() and y.shape == x.shape


def _scratch(x: torch.Tensor, y: torch.Tensor, bg: int, d: int,
             y_is_x: bool):
    """The normalized rows and their squares, folded: ``(xn, xsq, yn,
    ysq)``, with yn and ysq xn's and xsq's when y is x."""
    n, m = x.shape[1], y.shape[1]
    xn = torch.empty((bg, n, d), dtype=x.dtype, device=x.device)
    xsq = torch.empty((bg, n), dtype=torch.float32, device=x.device)
    if y_is_x:
        return xn, xsq, xn, xsq
    yn = torch.empty((bg, m, d), dtype=y.dtype, device=x.device)
    ysq = torch.empty((bg, m), dtype=torch.float32, device=x.device)
    return xn, xsq, yn, ysq


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.knn_mr_error_string(err).decode()} ({err})")


def launch(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None,
           k: int, dilation: int = 1):
    """Launch the CUDA kernel. Returns ``(idx, mr, xn, yn)``, where xn and
    yn are the normalized rows the kernel computed its distances from (yn
    is xn when y is x)."""
    global launches
    _check(x, y, bias, k, dilation)
    y_is_x = _check_launch(x, y, bias, k * dilation)
    bg, n, d = x.shape
    m = y.shape[1]
    lib = _lib()
    idx = torch.empty((bg, n, k), dtype=torch.int32, device=x.device)
    mr = torch.empty_like(x)
    xn, xsq, yn, ysq = _scratch(x, y, bg, d, y_is_x)
    bias_mode = 0 if bias is None else (1 if bias.dim() == 2 else 2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_mr_forward(
            x.data_ptr(), y.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            xn.data_ptr(), yn.data_ptr(), xsq.data_ptr(), ysq.data_ptr(),
            idx.data_ptr(), mr.data_ptr(), bg, n, m, d, k, dilation,
            bias_mode, int(x.dtype == torch.bfloat16), int(y_is_x),
            int(_FORCE_CHUNKED), *_fp32_block(), stream)
    _raise_on(err, lib, "knn_mr kernel")
    launches += 1
    return idx, mr, xn, yn


def launch_normalize(x: torch.Tensor) -> torch.Tensor:
    """Launch the forward's row normalization alone on a CUDA tensor x
    ``(..., D)``, bfloat16 or float32: its rows L2-normalized in x's type,
    bit for bit the rows ``launch`` computes its distances from."""
    global normalize_launches
    if not x.is_cuda or x.dtype not in _DTYPES:
        raise ValueError(f"launch_normalize takes a bfloat16 or float32 "
                         f"CUDA tensor, got {x.dtype} on {x.device}")
    x = x.contiguous()
    d = x.shape[-1]
    rows = x.numel() // d
    xn = torch.empty_like(x)
    xsq = torch.empty((rows,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_l2norm(x.data_ptr(), xn.data_ptr(), xsq.data_ptr(),
                             rows, d, int(x.dtype == torch.bfloat16),
                             stream)
    _raise_on(err, lib, "knn_mr normalize kernel")
    normalize_launches += 1
    return xn


def _check_grouped(x: torch.Tensor, y: torch.Tensor,
                   bias: torch.Tensor | None, k: int, dilation: int,
                   groups: int) -> None:
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError(f"x and y must be (B, N, g*D) / (B, M, g*D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    b, n, c = x.shape
    if y.shape[0] != b or y.shape[2] != c:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ "
                         f"in batch or channels")
    if groups < 1 or c % groups != 0:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if bias is not None and bias.dim() != 2:
        raise ValueError(f"the grouped route takes a shared (N, M) bias "
                         f"only, got {tuple(bias.shape)}")
    # the folded call's checks, on shapes only
    _check(torch.empty((b * groups, n, c // groups), dtype=x.dtype,
                       device="meta"),
           torch.empty((b * groups, y.shape[1], c // groups), dtype=y.dtype,
                       device="meta"), bias, k, dilation)


def knn_mr_grouped_reference(x: torch.Tensor, y: torch.Tensor,
                             bias: torch.Tensor | None, k: int,
                             dilation: int = 1, groups: int = 2
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the grouped forward: fold, ``knn_mr_reference``,
    unfold. Returns idx ``(B, N, g, k)`` and mr ``(B, N, g*D)``."""
    _check_grouped(x, y, bias, k, dilation, groups)
    idx, mr = knn_mr_reference(fold_groups(x, groups),
                               fold_groups(y, groups), bias, k, dilation)
    b, n = x.shape[:2]
    return (idx.reshape(b, groups, n, k).permute(0, 2, 1, 3).contiguous(),
            unfold_groups(mr, groups))


def launch_grouped(x: torch.Tensor, y: torch.Tensor,
                   bias: torch.Tensor | None, k: int, dilation: int = 1,
                   groups: int = 2):
    """Launch the group-strided CUDA kernel on the unfolded rows. Returns
    ``(idx (B, N, g, k), mr (B, N, g*D), xn, yn)``, where xn and yn are the
    folded normalized rows ``(B*g, N, D)`` / ``(B*g, M, D)`` the kernel
    computed its distances from (yn is xn when y is x)."""
    global grouped_launches
    _check_grouped(x, y, bias, k, dilation, groups)
    y_is_x = _check_launch(x, y, bias, k * dilation)
    b, n, c = x.shape
    m = y.shape[1]
    d = c // groups
    lib = _lib()
    idx = torch.empty((b, n, groups, k), dtype=torch.int32, device=x.device)
    mr = torch.empty_like(x)
    xn, xsq, yn, ysq = _scratch(x, y, b * groups, d, y_is_x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_mr_forward_grouped(
            x.data_ptr(), y.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            xn.data_ptr(), yn.data_ptr(), xsq.data_ptr(), ysq.data_ptr(),
            idx.data_ptr(), mr.data_ptr(), b, groups, n, m, d, k, dilation,
            0 if bias is None else 1, int(x.dtype == torch.bfloat16),
            int(y_is_x), *_fp32_block(), stream)
    _raise_on(err, lib, "knn_mr grouped kernel")
    grouped_launches += 1
    return idx, mr, xn, yn


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("knn_mr_bwd")
    if lib.knn_mr_backward.argtypes is None:
        lib.knn_mr_backward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.knn_mr_backward.restype = ctypes.c_int
        lib.knn_mr_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 7
        lib.knn_mr_bwd_workspace_bytes.restype = ctypes.c_longlong
        lib.knn_mr_bwd_error_string.argtypes = [ctypes.c_int]
        lib.knn_mr_bwd_error_string.restype = ctypes.c_char_p
        lib.gather_backward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.gather_backward.restype = ctypes.c_int
        lib.gather_bwd_small_edges.argtypes = []
        lib.gather_bwd_small_edges.restype = ctypes.c_int
        lib.gather_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 6
        lib.gather_bwd_workspace_bytes.restype = ctypes.c_longlong
    return lib


def _check_backward(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                    g: torch.Tensor) -> None:
    if x.dim() != 3 or y.dim() != 3 or y.shape[0] != x.shape[0] \
            or y.shape[2] != x.shape[2]:
        raise ValueError(f"x and y must be (BG, N, D) / (BG, M, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype or g.dtype != x.dtype:
        raise TypeError(f"x, y and g must share one of {_DTYPES}, got "
                        f"{x.dtype}, {y.dtype} and {g.dtype}")
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 3 \
            or idx.shape[:2] != x.shape[:2] or idx.shape[2] < 1:
        raise ValueError(f"idx must be int32 (BG, N, k) for x "
                         f"{tuple(x.shape)}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def edge_gradients_reference(x: torch.Tensor, y: torch.Tensor,
                             idx: torch.Tensor, g: torch.Tensor
                             ) -> torch.Tensor:
    """The per-edge gradients ``(BG, N, k, D)`` in the input type:
    ``g / cnt`` on the edges whose ``rel_j = y[idx_j] - x`` (in the input
    type) equals the channel's max, 0 elsewhere and on a NaN max."""
    rel = gather_nodes(y, idx) - x[:, :, None, :]
    tie = rel == rel.amax(dim=2, keepdim=True)
    cnt = tie.sum(dim=2, keepdim=True)
    return torch.where(tie, g.float()[:, :, None, :] / cnt, 0.0).to(x.dtype)


def knn_mr_backward_reference(x: torch.Tensor, y: torch.Tensor,
                              idx: torch.Tensor, g: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward: ``(gx, gy)`` for the output gradient g of mr
    (see the module docstring); gy is summed in fp32 and rounded once to
    y's type."""
    _check_backward(x, y, idx, g)
    ge = edge_gradients_reference(x, y, idx, g)
    return -g, gather_backward_reference(ge, idx, y.shape[1])


def knn_mr_backward_ordered_reference(x: torch.Tensor, y: torch.Tensor,
                                      idx: torch.Tensor, g: torch.Tensor
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain backward with the kernel's summation order: ``(gx, gy)``
    as ``knn_mr_backward_reference``, but each target's fp32 sum starts at
    0.0 and runs over its edges in ascending edge id ``(bg*N + n)*k + j``,
    one add per edge (``gather_backward_ordered_reference`` of the edge
    gradients). Slow; a check, never the CPU path."""
    _check_backward(x, y, idx, g)
    ge = edge_gradients_reference(x, y, idx, g)
    return -g, gather_backward_ordered_reference(ge, idx, y.shape[1])


@functools.lru_cache(maxsize=64)
def _bwd_workspace_bytes(b: int, groups: int, n: int, m: int, d: int, k: int,
                         is_bf16: int) -> int:
    return _bwd_lib().knn_mr_bwd_workspace_bytes(b, groups, n, m, d, k,
                                                 is_bf16)


def _check_bwd_launch(tensors: dict, rows: int, d: int, k: int) -> int:
    """The backward kernel's own limits, on inputs that passed the shape
    checks: one CUDA device, contiguous, k <= MAX_BWD_K, fewer than 2**31
    edges, its inverse list's entries ``row << ceil(log2 k) | j`` in 32
    bits, and a row of at most MAX_BWD_CHUNKS 16-byte chunks. Returns the
    device's index."""
    x = tensors["x"]
    dev = x.get_device()  # -1 on the CPU
    for name, t in tensors.items():
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name} must be on {x.device} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    chunks = -(-d * x.element_size() // 16)
    if (k > MAX_BWD_K or rows * k >= 2 ** 31
            or rows << (k - 1).bit_length() >= 2 ** 32
            or chunks > MAX_BWD_CHUNKS):
        raise ValueError(f"the backward kernel takes k <= {MAX_BWD_K}, "
                         f"fewer than 2**31 edges, rows << ceil(log2 k) < "
                         f"2**32 and rows of at most {MAX_BWD_CHUNKS} "
                         f"16-byte chunks, got k={k}, {rows} rows of "
                         f"{chunks} chunks")
    return dev


def _launch_bwd(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                g: torch.Tensor, b: int, groups: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/knn_mr_bwd.cu`` (its group-strided instantiation
    when groups > 1) on checked inputs; returns ``(gx, gy)``."""
    global backward_launches
    n, m, k = x.shape[1], y.shape[1], idx.shape[-1]
    d = x.shape[2] // groups
    dev = _check_bwd_launch(dict(x=x, y=y, idx=idx, g=g), b * groups * n,
                            d, k)
    lib = _bwd_lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    gx = torch.empty_like(x)
    gy = torch.empty_like(y)
    work = torch.empty(_bwd_workspace_bytes(b, groups, n, m, d, k, is_bf16),
                       dtype=torch.uint8, device=x.device)
    # the backward runs between the step's other launches: switch devices
    # only where the caller's current one is another
    with (torch.cuda.device(dev) if dev != torch.cuda.current_device()
          else contextlib.nullcontext()):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_mr_backward(
            x.data_ptr(), y.data_ptr(), idx.data_ptr(), g.data_ptr(),
            gx.data_ptr(), gy.data_ptr(), work.data_ptr(), b, groups, n, m,
            d, k, is_bf16, stream)
    if err != 0:
        raise RuntimeError(f"knn_mr backward kernel launch failed: "
                           f"{lib.knn_mr_bwd_error_string(err).decode()} "
                           f"({err})")
    backward_launches += 1
    return gx, gy


def launch_backward(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                    g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward CUDA kernels on folded rows. ``idx`` is the
    forward's, with every entry in [0, M). Returns ``(gx, gy)``."""
    _check_backward(x, y, idx, g)
    return _launch_bwd(x, y, idx, g, x.shape[0], 1)


@functools.lru_cache(maxsize=64)
def _gather_workspace_bytes(b: int, n: int, m: int, c: int, k: int,
                            is_bf16: int) -> int:
    return _bwd_lib().gather_bwd_workspace_bytes(b, n, m, c, k, is_bf16)


@functools.cache
def _gather_small_edges() -> int:
    return _bwd_lib().gather_bwd_small_edges()


def gather_backward_path(n: int, k: int) -> str:
    """Which path ``launch_gather_backward`` takes for n queries of k edges:
    ``"small"`` (at most the kernel's cap of n*k edges a batch row: one
    launch, no workspace, idx read as it comes) or ``"large"`` (four
    launches and a workspace, idx cast to int32)."""
    return "small" if n * k <= _gather_small_edges() else "large"


def launch_gather_backward(g: torch.Tensor, idx: torch.Tensor,
                           m: int) -> torch.Tensor:
    """Launch ``csrc/knn_mr_bwd.cu``'s ``gather_backward``, the backward of
    ``aggregate.gather_nodes``, on g ``(B, N, k, C)`` bfloat16 or float32
    and idx ``(B, N, k)`` on one card, every entry in [0, m): gy
    ``(B, m, C)``, bitwise ``aggregate.gather_backward_ordered_reference``
    (each target's fp32 sum in ascending edge id, no float atomics). One
    launch where ``gather_backward_path`` says ``"small"``."""
    global gather_backward_launches
    check_gather_backward(g, idx)
    if not g.is_cuda or idx.device != g.device:
        raise ValueError(f"g and idx must be on one CUDA device, got "
                         f"{g.device} and {idx.device}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"the gather backward kernel takes {_DTYPES}, got "
                        f"{g.dtype}")
    b, n, k, c = g.shape
    chunks = -(-c * g.element_size() // 16)
    if chunks > MAX_BWD_CHUNKS or b > MAX_GATHER_BATCH \
            or b * n * k >= 2 ** 31:
        raise ValueError(f"the gather backward kernel takes rows of at most "
                         f"{MAX_BWD_CHUNKS} 16-byte chunks, at most "
                         f"{MAX_GATHER_BATCH} batch rows and fewer than "
                         f"2**31 edges, got {chunks} chunks, {b} rows and "
                         f"{b * n * k} edges")
    g = g.contiguous()
    small = gather_backward_path(n, k) == "small"
    if idx.dtype != torch.int32 and not (small and idx.dtype == torch.int64):
        idx = idx.to(torch.int32)
    idx = idx.contiguous()
    gy = torch.empty((b, m, c), dtype=g.dtype, device=g.device)
    lib = _bwd_lib()
    is_bf16 = int(g.dtype == torch.bfloat16)
    dev = g.get_device()
    work = None if small else torch.empty(
        _gather_workspace_bytes(b, n, m, c, k, is_bf16), dtype=torch.uint8,
        device=g.device)
    with (torch.cuda.device(dev) if dev != torch.cuda.current_device()
          else contextlib.nullcontext()):
        # the stream's handle without a torch.cuda.Stream object, which
        # costs ~5 us of host time a call on an H100 host, half a small
        # call's kernel (the handle PyTorch's own Triton launcher reads)
        stream = torch._C._cuda_getCurrentRawStream(dev)
        err = lib.gather_backward(
            g.data_ptr(), idx.data_ptr(), gy.data_ptr(),
            None if work is None else work.data_ptr(), b, n, m, c, k,
            is_bf16, int(idx.dtype == torch.int64), stream)
    if err != 0:
        raise RuntimeError(f"gather backward kernel launch failed: "
                           f"{lib.knn_mr_bwd_error_string(err).decode()} "
                           f"({err})")
    gather_backward_launches += 1
    return gy


def _check_backward_grouped(x: torch.Tensor, y: torch.Tensor,
                            idx: torch.Tensor, g: torch.Tensor,
                            groups: int) -> None:
    if x.dim() != 3 or y.dim() != 3 or groups < 1 \
            or x.shape[2] % groups != 0:
        raise ValueError(f"x and y must be (B, N, g*D) / (B, M, g*D) with "
                         f"{groups} groups, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    b, n, c = x.shape
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if idx.dim() != 4 or idx.shape[:3] != (b, n, groups):
        raise ValueError(f"idx must be (B, N, g, k) = ({b}, {n}, {groups}, "
                         f"k), got {tuple(idx.shape)}")

    def folded(t, rows):
        return torch.empty((b * groups, rows, t.shape[-1] // groups),
                           dtype=t.dtype, device="meta")

    # the folded call's checks, on shapes only
    _check_backward(folded(x, n), folded(y, y.shape[1]),
                    torch.empty((b * groups, n, idx.shape[3]),
                                dtype=idx.dtype, device="meta"),
                    folded(g, n))


def knn_mr_grouped_backward_reference(x: torch.Tensor, y: torch.Tensor,
                                      idx: torch.Tensor, g: torch.Tensor,
                                      groups: int
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of ``knn_mr_fused_grouped`` on the unfolded
    rows, without fold copies: x ``(B, N, g*D)``, y ``(B, M, g*D)``, idx
    ``(B, N, g, k)``, g like x; returns ``(gx, gy)`` unfolded, the values
    of fold -> ``knn_mr_backward_reference`` -> unfold (each target's
    edges summed in the same order)."""
    _check_backward_grouped(x, y, idx, g, groups)
    b, n, c = x.shape
    m, d = y.shape[1], c // groups
    bi = torch.arange(b, device=x.device)[:, None, None, None]
    gi = torch.arange(groups, device=x.device)[None, None, :, None]
    rel = y.reshape(b, m, groups, d)[bi, idx.long(), gi] \
        - x.reshape(b, n, groups, d)[:, :, :, None, :]
    tie = rel == rel.amax(dim=3, keepdim=True)
    cnt = tie.sum(dim=3, keepdim=True)
    ge = torch.where(tie, g.reshape(b, n, groups, d).float()[:, :, :, None]
                     / cnt, 0.0).to(x.dtype)
    # unfolded target rows (b*M + t)*g + gi, in the order (b, n, gi, j)
    flat = ((bi * m + idx.long()) * groups + gi).reshape(-1)
    gy = torch.zeros((b * m * groups, d), dtype=torch.float32,
                     device=y.device)
    gy.index_add_(0, flat, ge.reshape(-1, d).float())
    return -g, gy.reshape(b, m, c).to(y.dtype)


def launch_backward_grouped(x: torch.Tensor, y: torch.Tensor,
                            idx: torch.Tensor, g: torch.Tensor, groups: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the group-strided backward on the unfolded rows as they are
    (x, g ``(B, N, g*D)``, y ``(B, M, g*D)``, idx ``(B, N, g, k)``); returns
    unfolded ``(gx, gy)``, bitwise fold -> ``launch_backward`` -> unfold."""
    _check_backward_grouped(x, y, idx, g, groups)
    return _launch_bwd(x, y, idx, g, x.shape[0], groups)


# The forwards are registered operators (``torch.library.custom_op``, namespace
# ``gkgnet_tpu_torch``): the dispatcher picks the kernel for CUDA tensors and
# the plain version for CPU tensors when the call runs, not when it is traced,
# so ``torch.export`` keeps one node per call, whatever the export device,
# and a loaded artifact launches the kernels. The implementations look the
# launch functions up at call time (a check may patch them).


@torch.library.custom_op("gkgnet_tpu_torch::knn_mr_fused", mutates_args=(),
                         device_types="cpu")
def _knn_mr_op(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None,
               k: int, dilation: int) -> tuple[torch.Tensor, torch.Tensor]:
    idx, mr = knn_mr_reference(x, y, bias, k, dilation)
    return idx.contiguous(), mr  # the dilation's view of the sort, copied


@_knn_mr_op.register_kernel("cuda")
def _(x, y, bias, k, dilation):
    idx, mr, _, _ = launch(x, y, bias, k, dilation)
    return idx, mr


@_knn_mr_op.register_fake
def _(x, y, bias, k, dilation):
    # shapes and types only: whether y is x is decided at run time
    _check(x, y, bias, k, dilation)
    return (x.new_empty((x.shape[0], x.shape[1], k), dtype=torch.int32),
            torch.empty_like(x))


def _save_rows(ctx, inputs, output) -> None:
    """The autograd context: x, y and the forward's idx."""
    x, y = inputs[:2]
    ctx.save_for_backward(x, y, output[0])


def _knn_mr_backward(ctx, _, g):
    """No gradient for the graph build, the bias, k or the dilation."""
    x, y, idx = ctx.saved_tensors
    with profiling.host_span("knn_mr.bwd"):
        g = g.contiguous()
        if x.device.type == "cpu":
            gx, gy = knn_mr_backward_reference(x, y, idx, g)
        else:
            gx, gy = launch_backward(x, y, idx, g)
    return gx, gy, None, None, None


_knn_mr_op.register_autograd(_knn_mr_backward, setup_context=_save_rows)


def knn_mr_fused(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None,
                 k: int, dilation: int = 1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused kNN graph + max-relative aggregate (see the module docstring),
    differentiable in x and y: the operator
    ``torch.ops.gkgnet_tpu_torch.knn_mr_fused``. Launches the CUDA kernels
    for CUDA tensors and runs the plain versions for CPU tensors."""
    return _knn_mr_op(x, y, bias, k, dilation)


@torch.library.custom_op("gkgnet_tpu_torch::knn_mr_fused_grouped",
                         mutates_args=(), device_types="cpu")
def _knn_mr_grouped_op(x: torch.Tensor, y: torch.Tensor,
                       bias: torch.Tensor | None, k: int, dilation: int,
                       groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    return knn_mr_grouped_reference(x, y, bias, k, dilation, groups)


@_knn_mr_grouped_op.register_kernel("cuda")
def _(x, y, bias, k, dilation, groups):
    idx, mr, _, _ = launch_grouped(x, y, bias, k, dilation, groups)
    return idx, mr


@_knn_mr_grouped_op.register_fake
def _(x, y, bias, k, dilation, groups):
    _check_grouped(x, y, bias, k, dilation, groups)
    return (x.new_empty((x.shape[0], x.shape[1], groups, k),
                        dtype=torch.int32), torch.empty_like(x))


def _knn_mr_grouped_backward(ctx, _, g):
    """On the unfolded rows as they are (the group-strided kernel for CUDA
    tensors, the plain version for CPU tensors): no fold or unfold copy,
    the values of ``_bwd_grouped``'s fold -> folded backward -> unfold."""
    x, y, idx = ctx.saved_tensors
    with profiling.host_span("knn_mr.bwd"):
        g = g.contiguous()
        if x.device.type == "cpu":
            gx, gy = knn_mr_grouped_backward_reference(x, y, idx, g,
                                                       ctx.groups)
        else:
            gx, gy = launch_backward_grouped(x, y, idx, g, ctx.groups)
    return gx, gy, None, None, None, None


def _save_grouped_rows(ctx, inputs, output) -> None:
    """``_save_rows`` and the grouped operator's ``groups``."""
    _save_rows(ctx, inputs, output)
    ctx.groups = inputs[5]


_knn_mr_grouped_op.register_autograd(_knn_mr_grouped_backward,
                                     setup_context=_save_grouped_rows)


def knn_mr_fused_grouped(x: torch.Tensor, y: torch.Tensor,
                         bias: torch.Tensor | None, k: int,
                         dilation: int = 1, groups: int = 2
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold-aware fused kNN graph + max-relative aggregate on unfolded
    ``(B, N, g*D)`` / ``(B, M, g*D)`` rows (see the module docstring),
    differentiable in x and y: idx ``(B, N, g, k)``, mr ``(B, N, g*D)``;
    the operator ``torch.ops.gkgnet_tpu_torch.knn_mr_fused_grouped``.
    Launches the CUDA kernels for CUDA tensors and runs the plain versions
    for CPU tensors."""
    return _knn_mr_grouped_op(x, y, bias, k, dilation, groups)


def ordering_gaps(xn: torch.Tensor, yn: torch.Tensor,
                  bias: torch.Tensor | None, idx: torch.Tensor,
                  dilation: int, rows: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """The kernel's ordering contract, checked in fp64.

    ``xn``/``yn`` are the normalized rows the kernel computed its distances
    from (``launch`` returns them) and ``idx`` its output. For each selected
    query row (flat indices into BG*N, all rows by default) and each output
    slot s, returns ``|d(idx[s]) - d(rank s*dilation)|``, where d are the
    fp64 distances of those rows plus the bias and the ranks are the true
    lexicographic (distance, column) order. A kernel exact with respect to
    its own fp32 distances has gaps at the scale of fp32 rounding.
    """
    bg, n, _ = xn.shape
    m = yn.shape[1]
    k = idx.shape[-1]
    if idx.min() < 0 or idx.max() >= m:
        raise ValueError("idx out of range")
    if (idx.sort(dim=-1).values.diff(dim=-1) == 0).any():
        raise ValueError("idx repeats a column within a row")
    if rows is None:
        rows = torch.arange(bg * n, device=xn.device)
    b_of, n_of = rows // n, rows % n
    ranks = torch.arange(k, device=xn.device) * dilation
    gaps = torch.empty((rows.numel(), k), dtype=torch.float64,
                       device=xn.device)
    for b in torch.unique(b_of).tolist():
        sel = (b_of == b).nonzero().squeeze(1)
        q = xn[b, n_of[sel]].double()
        t = yn[b].double()
        d = (q * q).sum(-1, keepdim=True) - 2.0 * q @ t.T \
            + (t * t).sum(-1)[None]
        if bias is not None:
            d = d + (bias[b] if bias.dim() == 3 else bias)[n_of[sel]].double()
        true = torch.sort(d, dim=-1, stable=True).values[:, ranks]
        got = d.gather(1, idx[b, n_of[sel]].long())
        gaps[sel] = (got - true).abs()
    return gaps


def backward_gy_bound(ge: torch.Tensor, idx: torch.Tensor, m: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's summation contract, checked in fp64.

    From the per-edge gradients ``ge (BG, N, k, D)``
    (``edge_gradients_reference``) and ``idx``, returns ``(exact, bound)``, both
    ``(BG, M, D)`` fp64: each target's exact sum and the bound that
    ``|gy - exact|`` must meet. A sum of n terms taken in fp32 in any order
    is off by at most ``gamma(n - 1) * sum|g_j|``, with
    ``gamma(j) = j u / (1 - j u)`` and u = 2**-24; a bf16 gy adds its one
    rounding: one bf16 spacing at ``|exact|`` and 2**-7 of that bound.
    """
    bg, _, _, d = ge.shape
    flat = _flat_targets(idx, m)
    rows = ge.reshape(-1, d).double()
    exact = torch.zeros((bg * m, d), dtype=torch.float64, device=ge.device)
    total = torch.zeros_like(exact)
    exact.index_add_(0, flat, rows)
    total.index_add_(0, flat, rows.abs())
    ju = (torch.bincount(flat, minlength=bg * m).double()[:, None] - 1
          ).clamp(min=0) * 2.0 ** -24
    bound = ju / (1.0 - ju) * total
    if ge.dtype == torch.bfloat16:
        mag = exact.abs()
        spacing = torch.where(
            mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), 0.0)
        bound = bound * (1.0 + 2.0 ** -7) + spacing
    return exact.reshape(bg, m, d), bound.reshape(bg, m, d)


@register_flop_formula(torch.ops.gkgnet_tpu_torch.knn_mr_fused)
def _knn_mr_flops(x_shape, y_shape, *args, out_shape=None, **kwargs) -> int:
    return distance_flops(x_shape, y_shape)


@register_flop_formula(torch.ops.gkgnet_tpu_torch.knn_mr_fused_grouped)
def _knn_mr_grouped_flops(x_shape, y_shape, *args, out_shape=None,
                          **kwargs) -> int:
    return distance_flops(x_shape, y_shape)
