#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  1. device: the card's name, count, and name + power limit from nvidia-smi;
  2. build: nvcc builds every kernel of the path from csrc/ (seconds, and
     the -Xptxas -v register and spill summary; each row below adds the
     block's dynamic shared memory);
  3. kernels: each kernel against its plain PyTorch version at every shape
     the main path gives it (bf16, BG=16, i.e. batch 8), plus one fp32 row:
     (a) mr bitwise equal to the plain max-relative of the kernel's own idx,
     (b) fp64 ordering oracle: each kernel column's fp64 distance within
         ORACLE_TOL of the true rank-(s*d) candidate's,
     (c) the share of rows whose idx equals the plain version's (printed,
         not asserted: near-ties may order differently in fp32),
     (d) kernel and plain times with CUDA events after warmup;
  4. model: entry(device="cuda", batch=8) in bf16: 16 kernel launches per
     forward, finite (8, 80) logits; 3 requests through predict(); then
     ms/forward and a profile of device time by kernel; then batch 1 in
     fp32 (TF32 off): each of the 16 calls held against the plain version on
     the forward's own activations, and the logits of the kernel path and
     the plain paths printed (see compare_fp32_paths for why they are not
     held to a tolerance);
  5. the kernels line, nvidia-smi's line, and the result line.

Any failed check raises: the script exits non-zero and prints no result
line. It needs a CUDA device and the gkgnet_tpu_torch package beside it.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import time

T0 = time.perf_counter()

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gkgnet_tpu_torch.entry import entry, predict  # noqa: E402
from gkgnet_tpu_torch.nn import grapher  # noqa: E402
from gkgnet_tpu_torch.ops import _build, knn_mr  # noqa: E402
from gkgnet_tpu_torch.ops.aggregate import max_relative  # noqa: E402
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table  # noqa: E402

BG = 16                   # batch 8 x 2 channel groups
ORACLE_TOL = 1e-4         # ~2x the worst fp32 accumulation error at D=320
ORACLE_ROWS = 4096
FLIP_SHARE = 1e-3         # fp32: rows of a call whose idx may differ from
                          # the plain version's (near-ties, checked in fp64)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense; fp32 without TF32

# (name, N, M, D, k, dilation, bias table (channels, nodes, r) or None,
#  calls per forward, dtype, targets: "pooled" / "self" / "labels")
ROWS = [
    ("stage1", 20736, 1296, 40, 9, 1, (80, 20736, 4), 2, "bf16", "pooled"),
    ("stage2", 5184, 1296, 80, 9, 1, (160, 5184, 2), 2, "bf16", "pooled"),
    ("stage3_d2", 1296, 1296, 200, 9, 2, (400, 1296, 1), 4, "bf16", "self"),
    ("stage3_d3", 1296, 1296, 200, 9, 3, (400, 1296, 1), 2, "bf16", "self"),
    ("stage4_d3", 324, 324, 320, 9, 3, (640, 324, 1), 2, "bf16", "self"),
    ("label1", 80, 20736, 40, 9, 1, None, 1, "bf16", "labels"),
    ("label2", 80, 5184, 80, 9, 1, None, 1, "bf16", "labels"),
    ("label3", 80, 1296, 200, 9, 1, None, 1, "bf16", "labels"),
    ("label4", 80, 324, 320, 9, 1, None, 1, "bf16", "labels"),
    ("stage3_d2_fp32", 1296, 1296, 200, 9, 2, (400, 1296, 1), 0, "fp32",
     "self"),
]


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return proc.stdout.strip().splitlines()[0]


def print_ptxas_summary(compiler_log: str) -> None:
    """One line per compiled kernel from nvcc's -Xptxas -v output."""
    lines: dict[str, list[str]] = {}
    name = None
    for line in compiler_log.splitlines():
        fn = re.search(r"Compiling entry function '_Z\w*?(knn_mr_kernel|"
                       r"l2norm_rows)I(13__nv_bfloat16|f)(?:Li(\d+))?", line)
        if fn:
            dtype = "bf16" if fn.group(2) != "f" else "fp32"
            name = f"{fn.group(1)}<{dtype}" + (
                f", KDM={fn.group(3)}>" if fn.group(3) else ">")
        elif name and ("spill" in line or "registers" in line):
            lines.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    for name, parts in lines.items():
        print(f"  ptxas {name}: {'; '.join(parts)}", flush=True)


def profile_forward(fn, model, x, iters: int = 3) -> None:
    """Device time by kernel over a few forwards (torch.profiler), the share
    of it in the port's kernels, and the device's busy share of the host
    wall time under the profiler (one stream: kernels do not overlap)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            fn(model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    ours_ms = sum(e.self_device_time_total for e in kernels
                  if "knn_mr_kernel" in e.key or "l2norm_rows" in e.key
                  ) / 1e3 / iters
    log(f"profile: {wall_ms:.2f} ms/forward host wall under the profiler; "
        f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
        f"of which knn_mr {ours_ms:.2f} ms "
        f"({100 * ours_ms / max(busy_ms, 1e-9):.1f} %)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / iters:8.3f} ms "
              f"{e.count // iters:4d}x  {e.key[:100]}", flush=True)


def compare_fp32_paths() -> None:
    """GKGNet-S@576 at batch 1 in fp32 (TF32 off): the kernel path against
    the plain path.

    The logits are not held to a tolerance. The model at its seeded init is
    chaotic: two plain paths (on the card and on the CPU, whose convolutions
    round differently) already differ by a fifth of max|logit|, from a few
    near-tie neighbour flips per forward. The check that tells a right
    kernel from a wrong one is made per call on the forward's own
    activations instead: for each of the 16 calls, the kernel's idx must
    equal the plain version's on all but FLIP_SHARE of the rows; where they
    differ the fp64 oracle must hold (the flips are near-ties), and mr must
    be bitwise equal on every row whose idx agrees."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    fn, (model, x) = entry(device="cuda", batch=1, dtype=torch.float32)
    calls = []
    kernel_op = grapher.knn_mr_fused

    def recording(*args):
        out = kernel_op(*args)
        calls.append((args, out))
        return out

    grapher.knn_mr_fused = recording
    try:
        got = fn(model, x).cpu()
        grapher.knn_mr_fused = knn_mr.knn_mr_reference
        plain_card = fn(model, x).cpu()
    finally:
        grapher.knn_mr_fused = kernel_op
    plain_cpu = fn(copy.deepcopy(model).cpu(), x.cpu())
    check(len(calls) == 16, f"{len(calls)} graph-conv calls, expected 16")
    for i, ((xx, yy, bias, k, dil), (idx, mr)) in enumerate(calls):
        idx_p, mr_p = knn_mr.knn_mr_reference(xx, yy, bias, k, dil)
        same = (idx_p == idx).all(-1)
        flips = int((~same).sum())
        _, _, xn, yn = knn_mr.launch(xx, yy, bias, k, dil)
        gap = knn_mr.ordering_gaps(xn, yn, bias, idx, dil).max().item()
        print(f"  fp32 call {i:2d}: N={xx.shape[1]:5d} M={yy.shape[1]:5d} "
              f"D={xx.shape[2]:3d} k*d={k * dil:2d}: idx differs from the "
              f"plain version's on {flips}/{same.numel()} rows; worst fp64 "
              f"gap {gap:.2e}", flush=True)
        check(flips <= FLIP_SHARE * same.numel(), f"fp32 call {i}: {flips} "
              f"rows differ from the plain idx")
        check(gap <= ORACLE_TOL, f"fp32 call {i}: fp64 gap {gap:.2e}")
        check(torch.equal(mr[same], mr_p[same]), f"fp32 call {i}: mr differs "
              f"on rows whose idx agrees")
    scale = float(plain_cpu.abs().max())

    def rel(a, b):
        return float((a - b).abs().max()) / scale

    log(f"model fp32 batch 1: max|logit| {scale:.3e}; max|diff| / max|logit|:"
        f" kernel vs plain (card) {rel(got, plain_card):.3e}, kernel vs plain"
        f" (CPU) {rel(got, plain_cpu):.3e}, plain (card) vs plain (CPU) "
        f"{rel(plain_card, plain_cpu):.3e}")


def kernel_rows() -> list[dict]:
    """Phase 3: every main-path shape of the kernel against its plain
    version. Returns one dict per row."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (name, n, m, d, k, dil, table, calls, dt, targets) in ROWS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((BG, n, d), generator=gen, device="cuda").to(dtype)
        y = x if targets == "self" else torch.randn(
            (BG, m, d), generator=gen, device="cuda").to(dtype)
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
        check(bias is None or tuple(bias.shape) == (n, m), f"{name} bias")

        idx, mr, xn, yn = knn_mr.launch(x, y, bias, k, dil)
        torch.cuda.synchronize()
        check(idx.shape == (BG, n, k) and mr.shape == x.shape
              and mr.dtype == dtype, f"{name}: output shapes")
        # (a) mr against the plain max-relative of the kernel's own idx
        mr_plain = max_relative(x, idx, y)
        max_abs_err = (mr.float() - mr_plain.float()).abs().max().item()
        check(torch.equal(mr, mr_plain), f"{name}: mr not bitwise equal to "
              f"the plain max-relative of the kernel's idx "
              f"(max |diff| {max_abs_err})")
        # (b) fp64 ordering oracle on ORACLE_ROWS rows (all if fewer)
        total = BG * n
        rows = None if total <= ORACLE_ROWS else torch.randperm(
            total, generator=gen, device="cuda")[:ORACLE_ROWS]
        gaps = knn_mr.ordering_gaps(xn, yn, bias, idx, dil, rows)
        n_checked = gaps.shape[0]
        violations = int((gaps > ORACLE_TOL).sum().item())
        worst = gaps.max().item()
        check(violations == 0, f"{name}: {violations} slots off the fp64 "
              f"order by more than {ORACLE_TOL} (worst {worst:.3e})")
        # (c) agreement with the plain version's own idx (not asserted)
        idx_p, _ = knn_mr.knn_mr_reference(x, y, bias, k, dil)
        same = (idx_p == idx).all(-1).float().mean().item()
        del idx_p
        # (d) times
        iters = 20 if n * m < 10**7 else 10
        ms = cuda_ms(lambda: knn_mr.launch(x, y, bias, k, dil), iters, 3)
        plain_ms = cuda_ms(
            lambda: knn_mr.knn_mr_reference(x, y, bias, k, dil), 3, 1)
        # least time for the same work: inputs read once, outputs written
        # once; the distance products at the dense peak of the input type
        nbytes = (x.nbytes + (0 if targets == "self" else y.nbytes)
                  + (0 if bias is None else bias.nbytes)
                  + idx.nbytes + mr.nbytes)
        flops = 2.0 * BG * n * m * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        row = dict(name=name, dtype=dt, N=n, M=m, D=d, kd=k * dil,
                   smem_bytes=knn_mr.shared_memory_bytes(d, k * dil),
                   calls_per_forward=calls, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max_abs_err, oracle_rows=n_checked,
                   oracle_violations=violations, oracle_worst_gap=worst,
                   idx_rows_equal_plain=same)
        print("row " + json.dumps(row), flush=True)
        results.append(row)
        del x, y, bias, idx, mr, xn, yn, mr_plain, gaps
        torch.cuda.empty_cache()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    # 2. build
    t = time.perf_counter()
    knn_mr._lib()
    seconds, compiler_log = _build.build_info["knn_mr"]
    log(f"build: knn_mr.cu in {seconds:.1f} s (load {time.perf_counter() - t:.1f} s)")
    print_ptxas_summary(compiler_log)

    # 3. kernel vs plain at every main-path shape
    rows = kernel_rows()
    log("kernels: every row passed (a) bitwise mr and (b) the fp64 oracle")

    # 4. model: the main path, then requests
    fn, (model, x) = entry(device="cuda", batch=8)
    log("model: GKGNet-S@576 bf16, batch 8, built")
    knn_mr.launches = 0
    logits = fn(model, x)
    torch.cuda.synchronize()
    check(knn_mr.launches == 16,
          f"{knn_mr.launches} kernel launches in one forward, expected 16")
    check(logits.shape == (8, 80) and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} finite={torch.isfinite(logits).all()}")
    for i in range(3):
        images = torch.randn((8, 576, 576, 3),
                             generator=torch.Generator().manual_seed(100 + i))
        scores = predict(model, images.to(torch.bfloat16))
        torch.cuda.synchronize()
        check(scores.shape == (8, 80) and bool(torch.isfinite(scores).all())
              and float(scores.min()) >= 0.0 and float(scores.max()) <= 1.0,
              f"request {i}: scores {tuple(scores.shape)}")
        log(f"request {i}: scores {tuple(scores.shape)} in "
            f"[{float(scores.min()):.4f}, {float(scores.max()):.4f}]")
    main_path_launches = knn_mr.launches
    check(main_path_launches == 64, f"{main_path_launches} launches over "
          f"one forward and 3 requests, expected 64")
    fwd_ms = cuda_ms(lambda: fn(model, x), 10, 2)
    log(f"model: {fwd_ms:.2f} ms/forward at batch 8, "
        f"{8e3 / fwd_ms:.1f} img/s (bf16)")
    profile_forward(fn, model, x)
    del model, x, logits
    torch.cuda.empty_cache()

    compare_fp32_paths()

    # 5. result lines
    main_rows = [r for r in rows if r["calls_per_forward"]]
    per_fwd = {key: sum(r[key] * r["calls_per_forward"] for r in main_rows)
               for key in ("ms", "plain_ms", "bound_ms")}
    # the bound that holds for the larger part of the forward's bound_ms
    by_ops = sum(r["bound_ms"] * r["calls_per_forward"] for r in main_rows
                 if r["bound_by"] == "operations")
    kernels = [{
        "name": "knn_mr_fused",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_mr.py:874",
        "launches": main_path_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per forward at batch 8: the sum over the 16 calls' shapes
        "ms": per_fwd["ms"],
        "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"],
        "bound_by": "operations" if by_ops > per_fwd["bound_ms"] / 2
        else "bytes",
        "library_ms": None,  # no single PyTorch call computes kNN + mr
    }]
    log(f"kernel knn_mr_fused: {main_path_launches} launches on the main "
        f"path (one forward + 3 requests); checks passed: mr bitwise and "
        f"fp64 order at {len(rows)} shapes, 16 fp32 calls on the model's "
        f"own activations")
    log(f"done: {time.perf_counter() - T0:.1f} s in all")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
