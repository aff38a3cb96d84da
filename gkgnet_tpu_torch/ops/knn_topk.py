"""Fused squared-distance + top-k: the port of the TPU kernel
``gkgnet_tpu/ops/pallas/knn_topk.py::knn_topk``.

``launch(x, y, k=k, bias=None, return_values=False)``:
  * x ``(BG, N, D)`` queries, y ``(BG, M, D)`` targets, both already
    L2-normalized by the caller, bfloat16 or float32 (any other pair is cast
    to float32, as the JAX kernel casts it);
  * bias: optional fp32 distance bias ``(N, M)`` or ``(BG, N, M)``;
  * returns idx ``(BG, N, k)`` int32, the k targets with the smallest
    ``x_sq - 2 <x, y> + y_sq (+ bias)`` (fp32 sums of exact products) in
    ascending (distance, column) order, NaN distances last in column order;
    with ``return_values`` also their fp32 distances ``(BG, N, k)``.

It launches the hand-written CUDA kernel in ``csrc/knn_topk.cu`` on CUDA
tensors (for bfloat16 rows the tensor-core scan of ``csrc/knn_scan.cuh``,
which knn_mr's bf16 kernel shares, so that ``launch(xn, yn, k=k*d)[...,
::d]`` is bitwise knn_mr's idx; for float32 rows the CUDA-core scan) and
raises on anything else, or when the kernel cannot take the input: the
plain version is ``ops.knn.knn_topk_reference``, and the operator
``torch.ops.gkgnet_tpu_torch.knn_topk`` (``ops.knn``, which
``knn_graph`` calls) picks between the two by the tensors' device.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from gkgnet_tpu_torch.ops import _build

# Kernel launches since the last reset; ``launch`` adds one per launch.
launches = 0

MAX_K = 64                  # largest k the kernel's register lists hold
MAX_SMEM_BYTES = 232448     # dynamic shared memory one block may opt into


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_topk")
    if lib.knn_topk_forward.argtypes is None:
        lib.knn_topk_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.knn_topk_forward.restype = ctypes.c_int
        lib.knn_topk_error_string.argtypes = [ctypes.c_int]
        lib.knn_topk_error_string.restype = ctypes.c_char_p
        lib.knn_topk_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.knn_topk_smem_bytes.restype = ctypes.c_longlong
    return lib


def shared_memory_bytes(d: int, k: int = 1,
                        dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block of the kernel at row width ``d``
    and ``k`` neighbours in ``dtype`` (bfloat16, else the float32 kernel);
    0 where no block fits (builds the kernel if needed)."""
    return _lib().knn_topk_smem_bytes(d, k, int(dtype == torch.bfloat16))


def check_inputs(x: torch.Tensor, y: torch.Tensor,
                 bias: torch.Tensor | None, k: int) -> None:
    """The shapes and types both versions take: raises ValueError or
    TypeError."""
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError(f"x and y must be (BG, N, D) / (BG, M, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    bg, n, d = x.shape
    m = y.shape[1]
    if y.shape[0] != bg or y.shape[2] != d:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ "
                         f"in batch or channels")
    if not (1 <= k <= m):
        raise ValueError(f"need 1 <= k <= M, got k={k}, M={m}")
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError(f"bias must be float32, got {bias.dtype}")
        if tuple(bias.shape) not in ((n, m), (bg, n, m)):
            raise ValueError(f"bias must be ({n}, {m}) or ({bg}, {n}, {m}), "
                             f"got {tuple(bias.shape)}")


def launch(x: torch.Tensor, y: torch.Tensor, *, k: int,
           bias: torch.Tensor | None = None, return_values: bool = False):
    """Launch the CUDA kernel (see the module docstring). Returns idx, or
    ``(idx, vals)`` with ``return_values``."""
    global launches
    check_inputs(x, y, bias, k)
    tensors = [x, y] + ([bias] if bias is not None else [])
    for name, t in zip(("x", "y", "bias"), tensors):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k > MAX_K:
        raise ValueError(f"k = {k} exceeds the kernel's {MAX_K}")
    bg, n, d = x.shape
    m = y.shape[1]
    if (n + 7) // 8 > 65535:  # the grid's y extent: 8 query rows a block
        raise ValueError(f"N = {n} query rows exceed the kernel's grid")
    lib = _lib()
    is_bf16 = x.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    smem = lib.knn_topk_smem_bytes(d, k, int(is_bf16))
    if smem == 0 or smem > MAX_SMEM_BYTES:
        raise ValueError(f"D = {d}: a block would need {smem} bytes of "
                         f"shared memory, over the card's {MAX_SMEM_BYTES}")
    y_is_x = y.data_ptr() == x.data_ptr() and y.shape == x.shape
    if not (x.dtype == torch.bfloat16 and y.dtype == torch.bfloat16):
        x = x.float()
        y = x if y_is_x else y.float()
    idx = torch.empty((bg, n, k), dtype=torch.int32, device=x.device)
    vals = torch.empty((bg, n, k), dtype=torch.float32, device=x.device) \
        if return_values else None
    xsq = torch.empty((bg, n), dtype=torch.float32, device=x.device)
    ysq = xsq if y_is_x else torch.empty((bg, m), dtype=torch.float32,
                                         device=x.device)
    bias_mode = 0 if bias is None else (1 if bias.dim() == 2 else 2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_topk_forward(
            x.data_ptr(), y.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            xsq.data_ptr(), ysq.data_ptr(), idx.data_ptr(),
            vals.data_ptr() if vals is not None else None,
            bg, n, m, d, k, bias_mode, int(x.dtype == torch.bfloat16),
            int(y_is_x), stream)
    if err != 0:
        raise RuntimeError(f"knn_topk kernel launch failed: "
                           f"{lib.knn_topk_error_string(err).decode()} "
                           f"({err})")
    launches += 1
    return (idx, vals) if return_values else idx
