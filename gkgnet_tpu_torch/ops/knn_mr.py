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

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/knn_mr.cu`` (and raises if it cannot); on a CPU tensor it runs
``knn_mr_reference``, the plain PyTorch version of the same function.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from gkgnet_tpu_torch.ops import _build
from gkgnet_tpu_torch.ops.aggregate import max_relative
from gkgnet_tpu_torch.ops.knn import dilate_edges, knn_graph

# Kernel launches since the last reset; the wrapper adds one per launch.
launches = 0

MAX_KD = 64  # largest k * dilation the kernel's register lists hold
_DTYPES = (torch.bfloat16, torch.float32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_mr")
    if lib.knn_mr_forward.argtypes is None:
        lib.knn_mr_forward.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.knn_mr_forward.restype = ctypes.c_int
        lib.knn_mr_error_string.argtypes = [ctypes.c_int]
        lib.knn_mr_error_string.restype = ctypes.c_char_p
        lib.knn_mr_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.knn_mr_smem_bytes.restype = ctypes.c_longlong
    return lib


def shared_memory_bytes(d: int, kd: int) -> int:
    """Dynamic shared memory of one block of the kernel at row width ``d``
    and ``k * dilation = kd`` (builds the kernel if needed)."""
    return _lib().knn_mr_smem_bytes(d, kd)


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
    """Plain PyTorch version: ``knn_graph`` + ``dilate_edges`` +
    ``max_relative``, the path the JAX package takes without its kernel."""
    _check(x, y, bias, k, dilation)
    idx = knn_graph(x, y, k=k * dilation, bias=bias)
    idx = dilate_edges(idx, dilation=dilation)
    return idx, max_relative(x, idx, y)


def launch(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None,
           k: int, dilation: int = 1):
    """Launch the CUDA kernel. Returns ``(idx, mr, xn, yn)``, where xn and
    yn are the normalized rows the kernel computed its distances from (yn
    is xn when y is x)."""
    global launches
    _check(x, y, bias, k, dilation)
    tensors = [x, y] + ([bias] if bias is not None else [])
    for name, t in zip(("x", "y", "bias"), tensors):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bg, n, d = x.shape
    m = y.shape[1]
    kd = k * dilation
    if kd > MAX_KD:
        raise ValueError(f"k * dilation = {kd} exceeds the kernel's "
                         f"{MAX_KD}")
    if (n + 7) // 8 > 65535:  # the grid's y extent: 8 query rows a block
        raise ValueError(f"N = {n} query rows exceed the kernel's grid")
    y_is_x = y.data_ptr() == x.data_ptr() and y.shape == x.shape
    lib = _lib()
    idx = torch.empty((bg, n, k), dtype=torch.int32, device=x.device)
    mr = torch.empty_like(x)
    xn = torch.empty_like(x)
    xsq = torch.empty((bg, n), dtype=torch.float32, device=x.device)
    yn, ysq = (xn, xsq) if y_is_x else (torch.empty_like(y), torch.empty(
        (bg, m), dtype=torch.float32, device=x.device))
    bias_mode = 0 if bias is None else (1 if bias.dim() == 2 else 2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_mr_forward(
            x.data_ptr(), y.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            xn.data_ptr(), yn.data_ptr(), xsq.data_ptr(), ysq.data_ptr(),
            idx.data_ptr(), mr.data_ptr(), bg, n, m, d, k, dilation,
            bias_mode, int(x.dtype == torch.bfloat16), int(y_is_x), stream)
    if err != 0:
        raise RuntimeError(f"knn_mr kernel launch failed: "
                           f"{lib.knn_mr_error_string(err).decode()} ({err})")
    launches += 1
    return idx, mr, xn, yn


def knn_mr_fused(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None,
                 k: int, dilation: int = 1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused kNN graph + max-relative aggregate (see the module docstring).
    Launches the CUDA kernel for CUDA tensors and runs the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return knn_mr_reference(x, y, bias, k, dilation)
    idx, mr, _, _ = launch(x, y, bias, k, dilation)
    return idx, mr


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
