"""Phase isolation of the knn_mr forward at stage-1 geometry, and an fp64
ordering oracle of its selection (counterpart: ``tools/exp_kernel_phases.py``
of the JAX package).

Each phase is an instantiation of the knn_mr forward kernel itself
(``csrc/knn_mr.cu``, its ``kPhase`` template parameter; entry ``knn_phase``;
for the tool's bf16 rows the tensor-core kernel on ``csrc/knn_scan.cuh``)
after the row normalization, so the split times the scan, the selection and
the gather the model runs. Each writes one fp32 checksum per query row,
``(BG, N, 1)``, as the TPU tool's kernels define it:

  dist   the distances only: the row sum of the fp32 distances;
  sel    distances + the k merge rounds, no gather: sum(acc) + sum(idx)
         with acc left at -inf, so the checksum is -inf;
  gfix   distances + the gathers of the fixed columns 7 .. 6 + k, no
         selection: sum_D max_j(y[7 + j] - x) + sum_j (7 + j);
  selg   the whole forward (no bias, no dilation): sum_D(mr) + sum(idx),
         mr the fp32 max-relative before rounding.

The gaps between the phases' times split the forward's time into its
target scan (dist), its selection (sel - dist) and its gather (gfix -
dist). Run on the card, from the repository root:

    python -m gkgnet_tpu_torch.tools.exp_kernel_phases

It prints each phase's ms and ns per query row, at BG 16, N 20736, M 1296,
D 40, K 9 in bf16 on seeded standard-normal input, then the oracle: on
2 x 2048 query rows, the kernel's idx (``knn_mr.launch``) and the plain
version's, each against the fp64 order.

``launch(phase, x, y, k)`` runs a phase's kernel (CUDA tensors only; it
counts its launches in ``launches``); ``phase_reference(phase, x, y, k)``
is its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gkgnet_tpu_torch.ops import knn_mr
from gkgnet_tpu_torch.ops.aggregate import gather_nodes
from gkgnet_tpu_torch.ops.knn import knn_topk_reference, l2_normalize

BG, N, D, M, K = 16, 20736, 40, 1296, 9
ROWS_PER_BLOCK = 8  # the fp32 kernel's fewest query rows a block (its
                    # blocks take 8-64 by shape): the grid limit
PHASES = ("dist", "sel", "gfix", "selg")
FIXED_COLUMN = 7   # gfix gathers columns 7, 8, ..., 6 + k
MAX_K = 16         # the phase instantiations' lists hold 16
_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches since the last reset; ``launch`` adds one per launch.
launches = 0


def _lib() -> ctypes.CDLL:
    lib = knn_mr._lib()  # the forward's library: its types set, error strings
    if lib.knn_phase.argtypes is None:
        lib.knn_phase.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.knn_phase.restype = ctypes.c_int
    return lib


def _check(phase: str, x: torch.Tensor, y: torch.Tensor, k: int) -> None:
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    if x.dim() != 3 or y.dim() != 3 or y.shape[0] != x.shape[0] \
            or y.shape[2] != x.shape[2]:
        raise ValueError(f"x and y must be (BG, N, D) / (BG, M, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"x and y must share one of {_DTYPES}, got "
                        f"{x.dtype} and {y.dtype}")
    m = y.shape[1]
    if not 1 <= k <= min(m, MAX_K):
        raise ValueError(f"need 1 <= k <= min(M, {MAX_K}), got k={k}, M={m}")
    if phase == "gfix" and m < FIXED_COLUMN + k:
        raise ValueError(f"gfix gathers columns {FIXED_COLUMN}.."
                         f"{FIXED_COLUMN + k - 1}: needs M >= "
                         f"{FIXED_COLUMN + k}, got {m}")


def launch(phase: str, x: torch.Tensor, y: torch.Tensor,
           k: int) -> torch.Tensor:
    """Run one phase's kernel on raw rows x ``(BG, N, D)`` and y
    ``(BG, M, D)`` (CUDA, contiguous). Returns the checksums ``(BG, N, 1)``
    fp32."""
    global launches
    _check(phase, x, y, k)
    for name, t in (("x", x), ("y", y)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bg, n, d = x.shape
    m = y.shape[1]
    if (n + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK > 65535:
        raise ValueError(f"N = {n} query rows exceed the kernel's grid")
    lib = _lib()
    xn, yn = torch.empty_like(x), torch.empty_like(y)
    xsq = torch.empty((bg, n), dtype=torch.float32, device=x.device)
    ysq = torch.empty((bg, m), dtype=torch.float32, device=x.device)
    out = torch.empty((bg, n, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_phase(
            PHASES.index(phase), x.data_ptr(), y.data_ptr(), xn.data_ptr(),
            yn.data_ptr(), xsq.data_ptr(), ysq.data_ptr(), out.data_ptr(),
            bg, n, m, d, k, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"knn_mr phase kernel launch failed: "
                           f"{lib.knn_mr_error_string(err).decode()} "
                           f"({err})")
    launches += 1
    return out


def distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The fp32 distances ``x_sq - 2 <x, y> + y_sq`` ``(BG, N, M)`` of the
    L2-normalized rows, rounded to the input type (``_dist``'s contract)."""
    xn, yn = l2_normalize(x).float(), l2_normalize(y).float()
    return ((xn * xn).sum(-1)[:, :, None]
            - 2.0 * torch.bmm(xn, yn.transpose(1, 2))
            + (yn * yn).sum(-1)[:, None, :])


def fixed_columns(x: torch.Tensor, k: int) -> torch.Tensor:
    """gfix's idx: columns 7 .. 6 + k for every query row, int32."""
    cols = torch.arange(FIXED_COLUMN, FIXED_COLUMN + k, dtype=torch.int32,
                        device=x.device)
    return cols.expand(x.shape[0], x.shape[1], k)


def max_relative_fp32(x: torch.Tensor, y: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """``max_j(y[idx_j] - x)`` in fp32, not rounded: ``(BG, N, D)``."""
    return (gather_nodes(y.float(), idx) - x.float()[:, :, None, :]).amax(2)


def phase_reference(phase: str, x: torch.Tensor, y: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Plain PyTorch version of one phase's checksums ``(BG, N, 1)``."""
    _check(phase, x, y, k)
    if phase == "dist":
        return distances(x, y).sum(-1, keepdim=True)
    if phase == "gfix":
        idx = fixed_columns(x, k)
    else:
        idx = knn_topk_reference(l2_normalize(x), l2_normalize(y), k=k)
    if phase == "sel":
        acc = torch.full(x.shape, -math.inf, device=x.device)
    else:
        acc = max_relative_fp32(x, y, idx)
    return (acc.sum(-1) + idx.sum(-1).float())[..., None]


def _gamma(j: int) -> float:
    u = 2.0 ** -24
    return j * u / (1.0 - j * u)


def dist_bound(x: torch.Tensor, y: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """dist's checksums in fp64 on the normalized rows, and the bound an
    fp32 computation of them meets in any summation order, both
    ``(BG, N, 1)``: each distance within gamma(D + 3) * (x_sq +
    2 sum|x_e y_e| + y_sq) of its fp64 value (D products summed, three
    more roundings), then M of them summed: gamma(M - 1) * sum|d_j|."""
    m, d = y.shape[1], x.shape[2]
    xn, yn = l2_normalize(x).double(), l2_normalize(y).double()
    exact, bound = [], []
    for b in range(x.shape[0]):
        xs = (xn[b] * xn[b]).sum(-1)[:, None]
        ys = (yn[b] * yn[b]).sum(-1)[None, :]
        dist = xs - 2.0 * xn[b] @ yn[b].T + ys
        each = _gamma(d + 3) * (xs + 2.0 * xn[b].abs() @ yn[b].abs().T + ys)
        exact.append(dist.sum(-1))
        bound.append(each.sum(-1)
                     + _gamma(m - 1) * (dist.abs() + each).sum(-1))
    return torch.stack(exact)[..., None], torch.stack(bound)[..., None]


def gather_bound(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The checksum ``sum_D max_j(y[idx_j] - x) + sum(idx)`` in fp64 of the
    fp32 maxima (computed alike by any version: one rounding each), and the
    bound an fp32 sum of them in any order meets, both ``(BG, N, 1)``:
    gamma(D) * (sum|acc| + sum(idx))."""
    acc = max_relative_fp32(x, y, idx).double()
    isum = idx.double().sum(-1)
    exact = acc.sum(-1) + isum
    bound = _gamma(x.shape[2]) * (acc.abs().sum(-1) + isum)
    return exact[..., None], bound[..., None]


def seeded_inputs(device: torch.device | str, seed: int = 0,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal x ``(BG, N, D)`` and y ``(BG, M, D)`` from numpy's
    generator, as the TPU tool's ``main`` makes them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((BG, N, D), dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal((BG, M, D), dtype=np.float32))
    return x.to(device=device, dtype=dtype), y.to(device=device, dtype=dtype)


def time_phases(x: torch.Tensor, y: torch.Tensor, k: int, iters: int = 20,
                warmup: int = 3) -> dict[str, float]:
    """ms per launch of each phase (CUDA events around ``iters`` launches,
    after ``warmup``)."""
    times = {}
    for phase in PHASES:
        for _ in range(warmup):
            launch(phase, x, y, k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch(phase, x, y, k)
        end.record()
        torch.cuda.synchronize()
        times[phase] = start.elapsed_time(end) / iters
    return times


def oracle(x: torch.Tensor, y: torch.Tensor, k: int) -> dict[str, tuple]:
    """The kernel's idx (``knn_mr.launch``) and the plain version's against
    the fp64 order: per implementation (rows whose idx differs from the
    fp64 top-k, rows, the largest fp64 gap between a slot and its true
    rank's distance)."""
    results = {}
    xn, yn = l2_normalize(x), l2_normalize(y)
    d64 = (xn.double() * xn.double()).sum(-1)[:, :, None] - 2.0 * torch.bmm(
        xn.double(), yn.double().transpose(1, 2)) + (
        yn.double() * yn.double()).sum(-1)[:, None, :]
    true_idx = torch.sort(d64, dim=-1, stable=True).indices[..., :k]
    kernel_idx, _, kxn, kyn = knn_mr.launch(x, y, None, k, 1)
    plain_idx, _ = knn_mr.knn_mr_reference(x, y, None, k, 1)
    for name, idx, a, b in (("kernel", kernel_idx, kxn, kyn),
                            ("plain", plain_idx, xn, yn)):
        differ = int((idx.long() != true_idx).any(-1).sum())
        gap = knn_mr.ordering_gaps(a, b, None, idx, 1).max().item()
        results[name] = (differ, idx.shape[0] * idx.shape[1], gap)
    return results


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("exp_kernel_phases: needs a CUDA device")
    x, y = seeded_inputs("cuda")
    print(f"{torch.cuda.get_device_name(0)}; BG {BG}, N {N}, M {M}, D {D}, "
          f"K {K}, bf16", flush=True)
    for phase, ms in time_phases(x, y, K).items():
        print(f"{phase:5s}: {ms:8.3f} ms ({ms / (BG * N) * 1e6:.3f} ns per "
              f"query row)", flush=True)
    xs, ys = x[:2, :2048].contiguous(), y[:2].contiguous()
    for name, (differ, rows, gap) in oracle(xs, ys, K).items():
        print(f"oracle[{name}]: order-mismatch rows {differ}/{rows}, max "
              f"fp64 gap {gap:.3e}", flush=True)


if __name__ == "__main__":
    main()
