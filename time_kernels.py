"""Time the knn_mr forward and knn_topk kernels of one checkout at the main
paths' shapes, to compare two checkouts on one card.

    python3 time_kernels.py [--tag NAME] [--iters 20] [--sweep]

Run a copy of it from the root of each checkout, in turns (parent, change,
change, parent), on the same card: it takes ``cuda_ms``, ``BG`` and the
s@576 calls (``ROWS``) from that checkout's ``chip_smoke.py`` and calls only
``knn_mr.launch`` and ``knn_topk.launch``, so it runs in older checkouts
too (a shape whose kernel a checkout lacks prints its error). The inputs
are seeded, so the printed SHA-1 of each call's outputs (knn_mr's idx and
mr, then knn_topk's idx and distances on knn_mr's normalized rows) shows
whether two checkouts compute the same bits. One ``time_row`` JSON line per
shape: its name, dtype, BG, N, M, D, k*d, knn_mr's and knn_topk's ms (CUDA
events, the mean of ``--iters`` launches after 3 warmup), the digest, or
the error. ``--sweep`` instead times the fp32 kernels (whose D = 1024
calls are slower than their plain versions) at BG 8, N = M = 324 with the
stage-4 bias over D and k*d, on the layout each width takes and on the
D-chunked scan forced (``sweep_row``), and profiles one D = 1024 call of
each kernel and of its plain version by kernel (``chip_smoke.profile_device``).
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys

import torch

import chip_smoke
from gkgnet_tpu_torch.ops import knn_mr, knn_topk
from gkgnet_tpu_torch.ops.knn import knn_topk_reference
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table

# (name, BG, N, M or None for self-kNN, D, k, dilation, bias table or None,
# dtype): arch b@576's distinct calls at batch 8 that s@576's do not cover
# (phase 12 of chip_smoke.py), then its ungrouped backbone's D = 1024 calls
B_SHAPES = [
    ("b_stage1_d1", 16, 20736, 1296, 64, 9, 1, (128, 20736, 4), "bf16"),
    ("b_stage3_d5", 16, 1296, None, 256, 9, 5, (512, 1296, 1), "bf16"),
    ("b_stage4_d5", 16, 324, None, 512, 9, 5, (1024, 324, 1), "bf16"),
    ("b_label4", 16, 80, 324, 512, 9, 1, None, "bf16"),
    ("b_stage4_d5_fp32", 16, 324, None, 512, 9, 5, (1024, 324, 1), "fp32"),
    ("b_ungrouped_stage4_d5", 8, 324, None, 1024, 9, 5, (1024, 324, 1),
     "bf16"),
    ("b_ungrouped_label4", 8, 80, 324, 1024, 9, 1, None, "bf16"),
    ("b_ungrouped_stage4_d5_fp32", 8, 324, None, 1024, 9, 5,
     (1024, 324, 1), "fp32"),
]


def shapes() -> list[tuple]:
    """chip_smoke.ROWS at its BG (self-kNN where the targets are the
    queries), then B_SHAPES."""
    s = [(f"s_{name}", chip_smoke.BG, n, None if targets == "self" else m,
          d, k, dil, table, dt)
         for (name, n, m, d, k, dil, table, _, dt, targets) in chip_smoke.ROWS]
    return s + B_SHAPES


# --sweep: the widths and (k, dilation) pairs of the fp32 sweep
SWEEP_D = (128, 256, 512, 768, 1024)
SWEEP_KD = ((9, 1), (9, 5))


def sweep(iters: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bias = torch.from_numpy(get_relative_pos_table(1024, 324, 1)).cuda()
    for d in SWEEP_D:
        x = torch.randn((8, 324, d), generator=gen, device="cuda")
        xn = knn_mr.l2_normalize(x)
        for k, dil in SWEEP_KD:
            row = dict(D=d, kd=k * dil,
                       chunked=knn_mr.block_layout(d, k * dil)[1])
            for forced in (False, True):
                with (chip_smoke.forced_chunked() if forced
                      else contextlib.nullcontext()):
                    key = "forced_" if forced else ""
                    row[key + "ms"] = chip_smoke.cuda_ms(
                        lambda: knn_mr.launch(x, x, bias, k, dil), iters, 3)
                    row[key + "topk_ms"] = chip_smoke.cuda_ms(
                        lambda: knn_topk.launch(xn, xn, k=k * dil,
                                                bias=bias), iters, 3)
            fmas = 8 * 324 * 324 * d
            row["tflops"] = 2 * fmas / row["ms"] / 1e9
            row["topk_tflops"] = 2 * fmas / row["topk_ms"] / 1e9
            print("sweep_row " + json.dumps(row), flush=True)
    for name, run in (
            ("knn_mr", lambda: knn_mr.launch(x, x, bias, 9, 5)),
            ("knn_mr plain", lambda: knn_mr.knn_mr_reference(x, x, bias, 9,
                                                             5)),
            ("knn_topk", lambda: knn_topk.launch(xn, xn, k=45, bias=bias)),
            ("knn_topk plain", lambda: knn_topk_reference(xn, xn, k=45,
                                                          bias=bias))):
        run()
        print(f"profile of one fp32 D = 1024 {name} call (BG 8, N = M = "
              f"324, k*d 45):", flush=True)
        chip_smoke.profile_device(run, "call", iters=5)


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_shape(shape: tuple, iters: int) -> dict:
    name, bg, n, m, d, k, dil, table, dt = shape
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((bg, n, d), generator=gen, device="cuda").to(dtype)
    y = x if m is None else torch.randn((bg, m, d), generator=gen,
                                        device="cuda").to(dtype)
    bias = None if table is None else torch.from_numpy(
        get_relative_pos_table(*table)).cuda()
    row = dict(name=name, dtype=dt, BG=bg, N=n, M=y.shape[1], D=d,
               kd=k * dil)
    try:
        idx, mr, xn, yn = knn_mr.launch(x, y, bias, k, dil)
        t_idx, t_vals = knn_topk.launch(xn, yn, k=k * dil, bias=bias,
                                        return_values=True)
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        return dict(row, error=str(e).splitlines()[0])
    row["ms"] = chip_smoke.cuda_ms(
        lambda: knn_mr.launch(x, y, bias, k, dil), iters, 3)
    row["topk_ms"] = chip_smoke.cuda_ms(
        lambda: knn_topk.launch(xn, yn, k=k * dil, bias=bias), iters, 3)
    row["digest"] = digest(idx, mr, t_idx, t_vals)
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="", help="printed on every row")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--sweep", action="store_true",
                        help="the fp32 sweep and profiles instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.sweep:
        sweep(args.iters)
        return 0
    for shape in shapes():
        row = dict(tag=args.tag, **time_shape(shape, args.iters))
        print("time_row " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
