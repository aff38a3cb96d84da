#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  1. device: the card's name, count, and name + power limit from nvidia-smi;
  2. build: nvcc builds every kernel of the paths from csrc/, one process
     per source, all at once (seconds, and the -Xptxas -v register and
     spill summary; each row below adds the block's dynamic shared memory);
  3. kernels: each kernel against its plain PyTorch version at every shape
     the main paths give it (bf16, BG=16, i.e. batch 8), plus one fp32 row.
     The forward (knn_mr_fused):
     (a) mr bitwise equal to the plain max-relative of the kernel's own idx,
     (b) fp64 ordering oracle: each kernel column's fp64 distance within
         ORACLE_TOL of the true rank-(s*d) candidate's,
     (c) the share of rows whose idx equals the plain version's (printed,
         not asserted: near-ties may order differently in fp32),
     (d) kernel and plain times with CUDA events after warmup;
     the backward (knn_mr_backward), on inputs with exact ties in the max
     (tie_fixture) and the forward kernel's idx:
     (e) gx bitwise -g;
     (f) gy bitwise knn_mr_backward_ordered_reference (each target's fp32
         sum from 0.0 in ascending edge id, the kernel's order, which also
         holds the tie sets), and within backward_gy_bound of the fp64 sum;
         every group has a row with a tie;
     (g) a second launch bitwise equal (no atomics), the times, and each
         call's largest and 99th-percentile in-degree;
     the forward rows also hold knn_topk(xn, yn, k*d)[..., ::d] bitwise to
     knn_mr's idx on knn_mr's own normalized rows (the same selection
     helpers and arithmetic). knn_topk (knn_graph's kernel) at every shape of this slice's
     path (bf16, BG=8 for the 9 blocks without groups, BG=16 for the 3
     stochastic 'mr' blocks, plus one fp32 row): the fp64 ordering oracle,
     every returned distance within its fp32 bound of the fp64 one, idx
     equal to the plain version's except at oracle near-ties (counted), two
     launches bitwise equal, tie and NaN fixtures bitwise the plain
     version's; kernel, plain and the two-call PyTorch route's times;
  4. eval: entry(device="cuda", batch=8) in bf16: 16 kernel launches per
     forward, finite (8, 80) logits; 3 requests through predict(); then
     ms/forward and a profile of device time by kernel; then batch 1 in
     fp32 (TF32 off): each of the 16 calls held against the plain version on
     the forward's own activations, and the logits of the kernel path and
     the plain paths printed (see compare_fp32_paths for why they are not
     held to a tolerance);
  5. train: train_entry(device="cuda", batch=8) in bf16 for 3 steps: 16
     forward and 16 backward launches per step, finite losses and gradient
     norm, parameters and BatchNorm statistics moved, the EMA between the
     initial and the new parameters; then ms/step, img/s, peak memory and
     a profile; then one step at batch 2 in fp32: each of the 16 backward
     calls held against the plain version on the step's own activations,
     and the kernel path's loss printed beside the plain path's and beside
     the kernel path's on images moved by one ulp; neither path launches
     knn_topk;
  6. the Grapher path (this slice): per aggregator (edge, sage, gin, gat)
     the 5 Grapher and 4 GrapherLabel blocks of GKGNet-S@576 without
     channel groups, at batch 8 in bf16, in eval and in a train-mode
     forward + backward: 9 knn_topk launches and no knn_mr launch each,
     finite outputs and gradients, ms per block; the 3 'mr' Graphers with
     stochastic dilation (epsilon 0.2) in train (3 knn_topk launches, no
     knn_mr) and eval (the fused knn_mr route); then at batch 2 in fp32
     every knn_topk call held to the plain version on the blocks' own
     activations;
  7. the grouped path (GKGNET_GROUPED=1 for this phase only): entry() at
     batch 8 in bf16 with phase 4's seed: 16 grouped knn_mr launches and no
     folded one per forward, logits bitwise phase 4's; 3 requests (64
     grouped launches in all); ms/forward beside the default route's in
     turns (default, grouped, grouped, default) and a profile; at each of
     the forward's 16 calls, on its own activations at batch 8 in bf16 and
     at batch 2 in fp32, the grouped kernel's idx and mr bitwise fold ->
     the folded kernel -> unfold, and held to the plain version
     (knn_mr_grouped_reference): mr bitwise where idx agrees, every idx
     difference a near-tie by the fp64 oracle on both sides, at most
     FLIP_SHARE of the forward's (row, group) pairs; per bf16 call the
     grouped, folded-route and plain ms and the bound; then 3 train steps
     at batch 8 (16 grouped forward and 16 backward launches each, no
     folded one), each step's 16 grouped backward calls (the group-strided
     kernel, no fold copy) bitwise fold -> the folded backward -> unfold on
     their own inputs, the step-1 loss bitwise phase 5's and the step-1
     gradients held to phase 5's per parameter, ms/step and peak memory;
  8. the phases (gkgnet_tpu_torch/tools/exp_kernel_phases.py) at the
     tool's geometry (BG 16, N 20736, M 1296, D 40, K 9, bf16): the four
     phase kernels timed (each launched on that run), then each checksum
     held to its plain version: dist and gfix within the fp32 summation
     bound, sel -inf, selg within its bound of the fp64 checksum of
     knn_mr.launch's own idx on the same rows; ms, plain ms and bound per
     phase, and the fp64 ordering oracle of the kernel's and the plain
     version's idx;
  9. the kernels line, nvidia-smi's line, and the result line.

Any failed check raises: the script exits non-zero and prints no result
line. It needs a CUDA device and the gkgnet_tpu_torch package beside it.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T0 = time.perf_counter()

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gkgnet_tpu_torch.entry import entry, predict, train_entry  # noqa: E402
from gkgnet_tpu_torch.nn import grapher  # noqa: E402
from gkgnet_tpu_torch.ops import _build, knn_mr, knn_topk  # noqa: E402
from gkgnet_tpu_torch.ops.aggregate import (fold_groups,  # noqa: E402
                                            max_relative, unfold_groups)
from gkgnet_tpu_torch.ops.knn import (knn_topk_reference,  # noqa: E402
                                      l2_normalize)
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table  # noqa: E402
from gkgnet_tpu_torch.tools import exp_kernel_phases as phases  # noqa: E402
from gkgnet_tpu_torch.utils.weights import init_block_parameters  # noqa: E402

BG = 16                   # batch 8 x 2 channel groups
ORACLE_TOL = 1e-4         # ~2x the worst fp32 accumulation error at D=320
ORACLE_ROWS = 4096
FLIP_SHARE = 1e-3         # fp32: rows of a call whose idx may differ from
                          # the plain version's (near-ties, checked in fp64)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense; fp32 without TF32

# (name, N, M, D, k, dilation, bias table (channels, nodes, r) or None,
#  calls per forward (and per train step), dtype, targets: "pooled" /
#  "self" / "labels")
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


# knn_topk at the shapes of this slice's path: (name, N, M, D, k, bias table
#  or None, BG, calls per aggregator pass (the 9 g=1 blocks of one
#  aggregator) or per stochastic pass (3 'mr' blocks, 2 groups), dtype,
#  targets). k is the graph conv's k * dilation.
TOPK_ROWS = [
    ("grapher1", 20736, 1296, 80, 9, (80, 20736, 4), 8, "agg", "bf16",
     "pooled"),
    ("grapher2", 5184, 1296, 160, 9, (160, 5184, 2), 8, "agg", "bf16",
     "pooled"),
    ("grapher3_d2", 1296, 1296, 400, 18, (400, 1296, 1), 8, "agg", "bf16",
     "self"),
    ("grapher3_d3", 1296, 1296, 400, 27, (400, 1296, 1), 8, "agg", "bf16",
     "self"),
    ("grapher4_d3", 324, 324, 640, 27, (640, 324, 1), 8, "agg", "bf16",
     "self"),
    ("label1", 80, 20736, 80, 9, None, 8, "agg", "bf16", "labels"),
    ("label2", 80, 5184, 160, 9, None, 8, "agg", "bf16", "labels"),
    ("label3", 80, 1296, 400, 9, None, 8, "agg", "bf16", "labels"),
    ("label4", 80, 324, 640, 9, None, 8, "agg", "bf16", "labels"),
    ("stochastic3_d2", 1296, 1296, 200, 18, (400, 1296, 1), 16, "stoch",
     "bf16", "self"),
    ("stochastic3_d3", 1296, 1296, 200, 27, (400, 1296, 1), 16, "stoch",
     "bf16", "self"),
    ("stochastic4_d3", 324, 324, 320, 27, (640, 324, 1), 16, "stoch",
     "bf16", "self"),
    ("grapher3_d2_fp32", 1296, 1296, 400, 18, (400, 1296, 1), 8, None,
     "fp32", "self"),
]
# The slice's path at GKGNet-S@576 widths, batch 8: (stage, C, grid side,
# r, dilation) of the Grapher blocks, (stage, C, grid side) of the
# GrapherLabel blocks, and the stochastic 'mr' Graphers.
GRAPHER_BLOCKS = [(1, 80, 144, 4, 1), (2, 160, 72, 2, 1), (3, 400, 36, 1, 2),
                  (3, 400, 36, 1, 3), (4, 640, 18, 1, 3)]
LABEL_BLOCKS = [(1, 80, 144), (2, 160, 72), (3, 400, 36), (4, 640, 18)]
STOCHASTIC_BLOCKS = [(3, 400, 36, 1, 2), (3, 400, 36, 1, 3),
                     (4, 640, 18, 1, 3)]
AGGREGATORS = ("edge", "sage", "gin", "gat")


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
                       r"knn_topk_kernel|l2norm_rows|row_sq|"
                       r"knn_mr_tc_kernel|knn_topk_tc_kernel)"
                       r"I(13__nv_bfloat16|f)?(?:Li(\d+)E)?(?:Lb([01])E)?"
                       r"(?:Li(\d+)E)?", line)
        bwd = re.search(r"Compiling entry function '_Z\w*?(rank_edges|"
                        r"target_offsets|row_split|target_sum)(\w*)'", line)
        if bwd:  # the backward's: type, folded or grouped, and its flags
            args = re.match(r"I(13__nv_bfloat16|f)?((?:Lb[01]E)*)(t|m)?"
                            r"(?:Li(\d+)E)?", bwd.group(2))
            parts = []
            if args:
                if args.group(1):
                    parts.append("fp32" if args.group(1) == "f" else "bf16")
                flags = re.findall(r"Lb([01])E", args.group(2))
                names = (("grouped", "folded"),
                         ("smem counts", "global counts")
                         if bwd.group(1) == "rank_edges"
                         else ("16-byte rows", "scalar rows"))
                parts += [on if flag == "1" else off
                          for flag, (on, off) in zip(flags, names)]
                if args.group(3):  # the tie masks' words
                    parts.append("k<=16" if args.group(3) == "t" else "k<=64")
                if args.group(4):
                    parts.append(f"{args.group(4)} edges in flight")
            name = bwd.group(1) + (f"<{', '.join(parts)}>" if parts else "")
        elif fn:
            # the tensor-core kernels are bf16 only: no type argument
            dtype = "fp32" if fn.group(2) == "f" else "bf16"
            phase = int(fn.group(5) or 0)  # knn_mr_kernel's: 0 the forward
            name = f"{fn.group(1)}<{dtype}" + "".join(
                part for part, on in (
                    (f", KDM={fn.group(3)}", fn.group(3)),
                    (", grouped", fn.group(4) == "1"),
                    (f", {phases.PHASES[phase - 1]}", phase)) if on) + ">"
        elif name and ("spill" in line or "registers" in line):
            lines.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    for name, parts in lines.items():
        print(f"  ptxas {name}: {'; '.join(parts)}", flush=True)


OUR_KERNELS = ("knn_mr_kernel", "knn_mr_tc_kernel", "l2norm_rows",
               "rank_edges", "target_offsets", "row_split", "target_sum",
               "knn_topk_kernel", "knn_topk_tc_kernel", "row_sq")


def profile_device(run, unit: str, iters: int = 3) -> None:
    """Device time by kernel over a few calls of ``run`` (torch.profiler),
    the share of it in the port's kernels, and the device's busy share of
    the host wall time under the profiler (one stream: kernels do not
    overlap)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    ours = {}
    for e in kernels:
        for name in OUR_KERNELS:
            if name in e.key:
                ours[name] = ours.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / iters
    ours_ms = sum(ours.values())
    log(f"profile: {wall_ms:.2f} ms/{unit} host wall under the profiler; "
        f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
        f"of which the port's kernels {ours_ms:.2f} ms "
        f"({100 * ours_ms / max(busy_ms, 1e-9):.1f} %: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ours.items()) + ")")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
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
        # knn_topk on the kernel's own normalized rows, every d-th: the
        # same selection and arithmetic give bitwise knn_mr's idx
        t_idx = knn_topk.launch(xn, yn, k=k * dil, bias=bias)[..., ::dil]
        check(torch.equal(t_idx, idx), f"{name}: knn_topk(xn, yn, k*d)"
              f"[..., ::d] differs from knn_mr's idx")
        del t_idx
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
                   smem_bytes=knn_mr.shared_memory_bytes(d, k * dil, dtype),
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


def tie_fixture(x: torch.Tensor, y: torch.Tensor) -> None:
    """Make query row 0 of every group tie exactly in its max on every
    channel: four equal target rows along its own direction (y rows 0-3 =
    3 x_0; with y = x, rows 0-3 equal) are its nearest targets, so the
    kept slots 0 and d hold two of them for a dilation d <= 3, and x_0 is
    large enough that every other rel is below theirs."""
    gen = torch.Generator().manual_seed(99)
    base = 5.0 * (1.0 + 0.1 * torch.randn(x.shape[-1], generator=gen))
    base = base.to(x.device)
    if y is x:
        x[:, :4] = base
    else:
        x[:, 0] = base
        y[:, :4] = 3.0 * base


def bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of a float tensor: bitwise comparisons that tell
    -0.0 from 0.0."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_backward(name: str, x, y, idx, g, out) -> tuple[float, float, int]:
    """(e) and (f) for one backward launch ``out = (gx, gy)``. Returns the
    largest |gy - the ordered plain gy| (0: bitwise), the largest
    |gy - exact fp64 sum| and the number of rows with a tie."""
    gx, gy = out
    check(gx.dtype == x.dtype and gy.shape == y.shape and gy.dtype == y.dtype,
          f"{name}: backward output shapes")
    check(torch.equal(gx, -g), f"{name}: gx is not -g")
    _, want = knn_mr.knn_mr_backward_ordered_reference(x, y, idx, g)
    err = (gy.float() - want.float()).abs().max().item()
    check(torch.equal(bits(gy), bits(want)), f"{name}: gy not bitwise the "
          f"ordered plain version's (max |diff| {err:.3e})")
    del want
    ge_ref = knn_mr.edge_gradients_reference(x, y, idx, g)
    tie_rows = int(((ge_ref != 0).sum(dim=2) > 1).any(dim=-1).sum())
    exact, bound = knn_mr.backward_gy_bound(ge_ref, idx, y.shape[1])
    del ge_ref
    gap = (gy.double() - exact).abs()
    over = int((gap > bound).sum())
    check(over == 0, f"{name}: gy off the fp64 sum beyond the bound at "
          f"{over} entries (worst {gap.max().item():.3e})")
    return err, gap.max().item(), tie_rows


def in_degrees(idx: torch.Tensor, m: int) -> tuple[int, float]:
    """The largest and the 99th-percentile number of edges into a target."""
    deg = torch.bincount(knn_mr._flat_targets(idx, m),
                         minlength=idx.shape[0] * m).float()
    return int(deg.max()), float(deg.quantile(0.99))


def backward_rows() -> list[dict]:
    """Phase 3, backward: every main-path shape of the backward kernel
    against its plain version, on tie fixtures. Returns one dict per row."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (name, n, m, d, k, dil, table, calls, dt, targets) in ROWS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((BG, n, d), generator=gen, device="cuda")
        y = x if targets == "self" else torch.randn(
            (BG, m, d), generator=gen, device="cuda")
        tie_fixture(x, y)
        x = x.to(dtype)
        y = x if targets == "self" else y.to(dtype)
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
        idx, _, _, _ = knn_mr.launch(x, y, bias, k, dil)
        del bias
        g = torch.randn((BG, n, d), generator=gen, device="cuda").to(dtype)
        out = knn_mr.launch_backward(x, y, idx, g)
        torch.cuda.synchronize()
        max_abs_err, fp64_err, tie_rows = check_backward(name, x, y, idx, g,
                                                         out)
        check(tie_rows >= BG, f"{name}: the tie fixture gave {tie_rows} "
              f"rows with a tie")
        # (g) determinism, then times
        again = knn_mr.launch_backward(x, y, idx, g)
        check(torch.equal(bits(out[0]), bits(again[0]))
              and torch.equal(bits(out[1]), bits(again[1])),
              f"{name}: two launches differ")
        del again
        iters = 20 if n * m < 10**7 else 10
        ms = cuda_ms(lambda: knn_mr.launch_backward(x, y, idx, g), iters, 3)
        plain_ms = cuda_ms(
            lambda: knn_mr.knn_mr_backward_reference(x, y, idx, g), 3, 1)
        # least time: x, y, idx, g read once, gx and gy written once; per
        # edge and channel a subtraction, a comparison, a split and an add
        gx, gy = out
        nbytes = (x.nbytes + (0 if targets == "self" else y.nbytes)
                  + idx.nbytes + g.nbytes + gx.nbytes + gy.nbytes)
        flops = 4.0 * BG * n * k * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["fp32"] * 1e3
        max_deg, p99_deg = in_degrees(idx, m)
        row = dict(name=name, dtype=dt, N=n, M=m, D=d, k=k,
                   calls_per_step=calls, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max_abs_err, fp64_err=fp64_err,
                   tie_rows=tie_rows, max_in_degree=max_deg,
                   p99_in_degree=p99_deg)
        print("bwd_row " + json.dumps(row), flush=True)
        results.append(row)
        del x, y, idx, g, out, gx, gy
        torch.cuda.empty_cache()
    return results


def topk_value_bounds(xn: torch.Tensor, yn: torch.Tensor,
                      bias: torch.Tensor | None, idx: torch.Tensor,
                      rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For the flat query ``rows`` (into BG*N) and their selected columns
    ``idx``: the fp64 distances (bias included) and the bound the kernel's
    computation of them meets, gamma(j) * (x_sq + 2 sum|x_e y_e| + y_sq +
    |bias|) with gamma(j) = j u / (1 - j u), u = 2**-24. Both (rows, k)
    fp64.

    fp32 rows (the CUDA-core kernel): j = D + 3, D products summed by fmaf
    in fp32, then three more roundings.

    bf16 rows (the tensor-core kernel, csrc/knn_scan.cuh): each product of
    two bf16 values is exact in fp32, and one mma.m16n8k16 step adds 16 of
    them to the fp32 accumulator. Taking the step as tensor cores are
    measured to add (the 17 terms aligned to the largest exponent and cut
    to fp32's 24 bits, summed, the sum cut to 24 bits again: truncation, no
    extra bits, the least precise of the reported behaviours), each of the
    16 cut terms loses less than 2u max|term| and the sum less than
    2u |sum|, so a step is off by less than 34u sum|x_e y_e|, and the
    ceil(D/16) steps' dot product by 34 ceil(D/16) u sum|x_e y_e|. The
    distance doubles it (exactly), then takes the three IEEE roundings of
    x_sq - 2 dot + y_sq (+ bias); x_sq and y_sq are fp32 sums of D exact
    squares, off by gamma(D - 1) < 34 ceil(D/16) u of themselves. So
    j = 34 ceil(D/16) + 3 (D = 80: 173 against the fp32 kernel's 83)."""
    bg, n, d = xn.shape
    k = idx.shape[-1]
    b_of, n_of = rows // n, rows % n
    q = xn.reshape(bg * n, d)[rows].double()                    # (R, D)
    cols = idx.reshape(bg * n, k)[rows].long()                  # (R, k)
    t = yn.double()[b_of[:, None], cols]                        # (R, k, D)
    prod = q[:, None, :] * t
    exact = (q * q).sum(-1)[:, None] - 2.0 * prod.sum(-1) + (t * t).sum(-1)
    scale = (q * q).sum(-1)[:, None] + 2.0 * prod.abs().sum(-1) \
        + (t * t).sum(-1)
    if bias is not None:
        b = (bias[b_of, n_of] if bias.dim() == 3 else bias[n_of]).double()
        bsel = b.gather(1, cols)
        exact = exact + bsel
        scale = scale + bsel.abs()
    j = 34 * ((d + 15) // 16) + 3 if xn.dtype == torch.bfloat16 else d + 3
    ju = j * 2.0 ** -24
    return exact, ju / (1.0 - ju) * scale


def check_topk(name: str, xn, yn, bias, idx, vals, rows=None,
               max_flip_share: float | None = None) -> dict:
    """A knn_topk result held to its contract on finite inputs: (1) the
    fp64 ordering oracle (each slot's fp64 distance within ORACLE_TOL of
    the true rank's) on ``rows`` (all by default) and on every row whose
    idx differs from the plain version's, where the plain idx must pass it
    too: a row may differ only at a near-tie, which fp32 sums taken in
    another order decide otherwise (with ``max_flip_share``, at most that
    share of the rows); (2) each returned distance within its fp32 bound of
    the fp64 distance. Returns the counts."""
    bg, n, _ = xn.shape
    plain = knn_topk_reference(xn, yn, k=idx.shape[-1], bias=bias)
    diff = (plain != idx).any(-1).reshape(-1).nonzero().squeeze(1)
    flips = diff.numel()
    check(max_flip_share is None or flips <= max_flip_share * bg * n,
          f"{name}: idx differs from the plain version's on {flips} of "
          f"{bg * n} rows")
    if rows is None:
        rows = torch.arange(bg * n, device=xn.device)
    rows = torch.unique(torch.cat([rows, diff]))
    worst = 0.0
    for got in (idx, plain):
        gaps = knn_mr.ordering_gaps(xn, yn, bias, got, 1, rows)
        worst = max(worst, gaps.max().item())
        check(worst <= ORACLE_TOL, f"{name}: a slot off the fp64 order by "
              f"{worst:.3e} (> {ORACLE_TOL})")
        if not flips:
            break
    max_err = 0.0
    if vals is not None:
        for part in rows.split(8192):
            exact, bound = topk_value_bounds(
                xn, yn, bias, idx, part)
            err = (vals.reshape(bg * n, -1)[part].double() - exact).abs()
            over = int((err > bound).sum())
            check(over == 0, f"{name}: {over} distances off the fp64 ones "
                  f"beyond the fp32 bound (worst {err.max().item():.3e})")
            max_err = max(max_err, err.max().item())
    return dict(flips=flips, oracle_rows=rows.numel(), oracle_worst_gap=worst,
                max_abs_err=max_err)


def topk_fixture(x: torch.Tensor, y: torch.Tensor, self_knn: bool
                 ) -> list[tuple[int, int]]:
    """Exact ties and NaN rows for a knn_topk call without bias, on fp32
    x and y: ``tie_fixture``'s tied targets (rows 0-3 of y equal along
    query 0's direction, or rows 0-3 of x equal when y is x), a NaN query
    row (group 0, row 10) and a NaN target row (group 1, row 5; with y = x
    a NaN query row as well). Returns the (group, row) of the queries whose
    idx must equal the plain version's bitwise."""
    tie_fixture(x, y if not self_knn else x)
    x[0, 10] = float("nan")
    (x if self_knn else y)[1, 5] = float("nan")
    rows = [(0, 0), (0, 10)] + ([(0, 1), (0, 2), (0, 3), (1, 5)]
                                if self_knn else [])
    return rows


def topk_rows() -> list[dict]:
    """Phase 3, knn_topk: every shape of this slice's path against the plain
    version. Returns one dict per row."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for (name, n, m, d, k, table, bg, pass_, dt, targets) in TOPK_ROWS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        self_knn = targets == "self"
        x = torch.randn((bg, n, d), generator=gen, device="cuda")
        y = x if self_knn else torch.randn((bg, m, d), generator=gen,
                                           device="cuda")
        xn = l2_normalize(x.to(dtype))
        yn = xn if self_knn else l2_normalize(y.to(dtype))
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
        check(bias is None or tuple(bias.shape) == (n, m), f"{name} bias")

        idx, vals = knn_topk.launch(xn, yn, k=k, bias=bias,
                                    return_values=True)
        torch.cuda.synchronize()
        check(idx.shape == (bg, n, k) and idx.dtype == torch.int32
              and vals.shape == (bg, n, k), f"{name}: output shapes")
        total = bg * n
        rows = None if total <= ORACLE_ROWS else torch.randperm(
            total, generator=gen, device="cuda")[:ORACLE_ROWS]
        stats = check_topk(name, xn, yn, bias, idx, vals, rows)
        again = knn_topk.launch(xn, yn, k=k, bias=bias, return_values=True)
        check(torch.equal(again[0], idx) and torch.equal(again[1], vals),
              f"{name}: two launches differ")
        del again
        # exact ties and NaN rows (no bias: a bias would break the ties)
        fx = x.clone()
        fy = fx if self_knn else y.clone()
        fixed = topk_fixture(fx, fy, self_knn)
        fxn = l2_normalize(fx.to(dtype))
        fyn = fxn if self_knn else l2_normalize(fy.to(dtype))
        f_idx, f_vals = knn_topk.launch(fxn, fyn, k=k, return_values=True)
        p_idx, p_vals = knn_topk_reference(fxn, fyn, k=k,
                                           return_values=True)
        for g_, r_ in fixed:
            check(torch.equal(f_idx[g_, r_], p_idx[g_, r_]), f"{name}: "
                  f"fixture row ({g_}, {r_}): {f_idx[g_, r_].tolist()} vs "
                  f"plain {p_idx[g_, r_].tolist()}")
        check(f_idx[0, 0, :4].tolist() == [0, 1, 2, 3],
              f"{name}: tied targets not in column order")
        check(bool(torch.isnan(f_vals[0, 10]).all())
              and f_idx[0, 10].tolist() == list(range(k)),
              f"{name}: the NaN query row")
        finite = torch.isfinite(fxn[1]).all(-1)
        check(not bool((f_idx[1][finite] == 5).any()), f"{name}: the NaN "
              f"target row was chosen")
        del fx, fy, fxn, fyn, f_idx, f_vals, p_idx, p_vals
        # times: the kernel, the plain version, and the two-call PyTorch
        # route (fp32 baddbmm + topk: no single PyTorch call computes it)
        iters = 20 if n * m < 10**7 else 10
        ms = cuda_ms(lambda: knn_topk.launch(xn, yn, k=k, bias=bias), iters,
                     3)
        plain_ms = cuda_ms(
            lambda: knn_topk_reference(xn, yn, k=k, bias=bias), 3, 1)
        x32, y32 = xn.float(), yn.float()
        base = (x32 * x32).sum(-1)[:, :, None] \
            + (y32 * y32).sum(-1)[:, None, :]
        if bias is not None:
            base = base + bias
        two_call_ms = cuda_ms(lambda: torch.topk(torch.baddbmm(
            base, x32, y32.transpose(1, 2), alpha=-2.0), k, largest=False),
            3, 1)
        del x32, y32, base
        nbytes = (xn.nbytes + (0 if self_knn else yn.nbytes)
                  + (0 if bias is None else bias.nbytes) + idx.nbytes)
        flops = 2.0 * bg * n * m * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        row = dict(name=name, dtype=dt, BG=bg, N=n, M=m, D=d, k=k,
                   smem_bytes=knn_topk.shared_memory_bytes(d, k, dtype),
                   calls_per_pass=1 if pass_ == "agg" else 0,
                   calls_per_stochastic_pass=1 if pass_ == "stoch" else 0,
                   ms=ms, plain_ms=plain_ms, two_call_ms=two_call_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   **stats)
        print("topk_row " + json.dumps(row), flush=True)
        results.append(row)
        del x, y, xn, yn, bias, idx, vals
        torch.cuda.empty_cache()
    return results


def make_blocks(conv: str, dtype: torch.dtype, batch: int, seed: int
                ) -> list[tuple[str, torch.nn.Module, tuple]]:
    """This slice's blocks for one aggregator at GKGNet-S@576 widths: the 5
    Graphers and 4 GrapherLabels without channel groups (drop_path 0.1,
    seeded weights and inputs, each Grapher with its stage's relative-
    position table), or, for conv 'stochastic', the 3 'mr' Graphers with
    stochastic dilation (epsilon 0.2, 2 groups). Returns (name, module,
    inputs) on the card."""
    wgen = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks = []
    specs = STOCHASTIC_BLOCKS if conv == "stochastic" else GRAPHER_BLOCKS
    for stage, c, side, r, dil in specs:
        if conv == "stochastic":
            m = grapher.Grapher(c, 9, dil, "mr", "gelu", r=r, stochastic=True,
                                epsilon=0.2, num_group=2, drop_path=0.1,
                                dtype=dtype)
        else:
            m = grapher.Grapher(c, 9, dil, conv, "gelu", r=r, drop_path=0.1,
                                use_multi_group=False, dtype=dtype)
        x = torch.randn((batch, side, side, c), generator=gen,
                        device="cuda").to(dtype)
        bias = torch.from_numpy(get_relative_pos_table(
            c, side * side, r)).cuda()
        blocks.append((f"grapher{stage}_d{dil}", m, (x, bias)))
    if conv != "stochastic":
        for stage, c, side in LABEL_BLOCKS:
            m = grapher.GrapherLabel(c, 9, conv=conv, act="gelu",
                                     drop_path=0.1, use_multi_group=False,
                                     dtype=dtype)
            labels = torch.randn((batch, 80, c), generator=gen,
                                 device="cuda").to(dtype)
            feats = torch.randn((batch, side, side, c), generator=gen,
                                device="cuda").to(dtype)
            blocks.append((f"label{stage}", m, (labels, feats)))
    for _, m, _ in blocks:
        init_block_parameters(m, wgen)
        m.cuda()
    return blocks


def run_block(module, inputs, train: bool, gen) -> torch.Tensor:
    """One pass of a block: the eval forward, or a train-mode forward and
    the backward of a scalar loss. Returns the output."""
    module.train(train)
    with torch.set_grad_enabled(train):
        out = module(*inputs, gen)
        out = out[0] if isinstance(out, tuple) else out
        if train:
            module.zero_grad(set_to_none=True)
            out.float().square().mean().backward()
    return out


def counted_pass(blocks, train: bool, gen) -> tuple[int, int, int]:
    """Every block once with the launch counts set to 0 just before; checks
    finite outputs and gradients; returns the counts read just after:
    (knn_topk, knn_mr forward, knn_mr backward)."""
    knn_topk.launches = 0
    knn_mr.launches = 0
    knn_mr.backward_launches = 0
    for name, m, inputs in blocks:
        out = run_block(m, inputs, train, gen)
        check(bool(torch.isfinite(out).all()), f"{name}: output not finite")
        if train:
            bad = [k for k, p in m.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            check(not bad, f"{name}: missing or non-finite gradients "
                  f"{bad[:4]}")
    torch.cuda.synchronize()
    return knn_topk.launches, knn_mr.launches, knn_mr.backward_launches


def grapher_phase() -> dict:
    """Phase 6: this slice's path. Per aggregator, the 9 blocks in eval and
    in train (9 knn_topk launches and no knn_mr launch each), then ms per
    block; then the stochastic 'mr' blocks in train (3 knn_topk, no knn_mr)
    and in eval (the fused route: 3 knn_mr, no knn_topk). Returns the
    launches and the times."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    launches = 0
    times = {}
    for conv in AGGREGATORS + ("stochastic",):
        blocks = make_blocks(conv, torch.bfloat16, 8, seed=10)
        n = len(blocks)
        for train in (False, True):
            counts = counted_pass(blocks, train, gen)
            if conv == "stochastic" and not train:
                want = (0, n, 0)
            else:
                want = (n, 0, 0)
            check(counts == want, f"{conv} {'train' if train else 'eval'}: "
                  f"launches (knn_topk, knn_mr, knn_mr backward) {counts}, "
                  f"expected {want}")
            if conv != "stochastic" or train:
                launches += counts[0]
        for name, m, inputs in blocks:
            eval_ms = cuda_ms(lambda: run_block(m, inputs, False, gen), 3, 1)
            train_ms = cuda_ms(lambda: run_block(m, inputs, True, gen), 2, 1)
            times[f"{conv}/{name}"] = (eval_ms, train_ms)
            print(f"  block {conv:10s} {name:12s}: eval {eval_ms:8.3f} ms, "
                  f"train fwd+bwd {train_ms:8.3f} ms", flush=True)
        mine = [t for key, t in times.items() if key.startswith(conv + "/")]
        route = ("train: knn_topk; eval: the fused knn_mr route"
                 if conv == "stochastic" else "knn_topk in eval and train")
        log(f"grapher path {conv}: passed, {n} blocks ({route}); "
            f"{sum(t[0] for t in mine):.2f} ms eval, "
            f"{sum(t[1] for t in mine):.2f} ms train fwd+bwd in all")
        del blocks
        torch.cuda.empty_cache()
    return dict(launches=launches, times=times)


def compare_fp32_grapher() -> None:
    """This slice's blocks at batch 2 in fp32 (TF32 off): every knn_topk
    call held to the plain version on the block's own activations
    (check_topk), by patching ``knn_topk.launch``, which ``knn_graph`` looks
    up at call time: the 9 blocks of each aggregator in eval, and the 3
    stochastic 'mr' blocks in train."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = []
    kernel = knn_topk.launch

    def recording(x, y, *, k, bias=None, return_values=False):
        out = kernel(x, y, k=k, bias=bias, return_values=True)
        calls.append((x, y, bias, out))
        return out if return_values else out[0]

    gen = torch.Generator(device="cuda").manual_seed(8)
    knn_topk.launch = recording
    try:
        for conv in AGGREGATORS + ("stochastic",):
            for _, m, inputs in make_blocks(conv, torch.float32, 2, seed=11):
                with torch.no_grad():
                    m.train(conv == "stochastic")
                    m(*inputs, gen)
    finally:
        knn_topk.launch = kernel
    check(len(calls) == 9 * len(AGGREGATORS) + 3,
          f"{len(calls)} knn_topk calls, expected {9 * len(AGGREGATORS) + 3}")
    flips = worst = 0
    for i, (x, y, bias, (idx, vals)) in enumerate(calls):
        stats = check_topk(f"fp32 call {i}", x, y, bias, idx, vals,
                           max_flip_share=FLIP_SHARE)
        flips += stats["flips"]
        worst = max(worst, stats["oracle_worst_gap"])
    log(f"grapher fp32 batch 2: {len(calls)} knn_topk calls held to the plain "
        f"version on the blocks' own activations: {flips} rows differ in all "
        f"(near-ties, each within the fp64 oracle), worst fp64 gap "
        f"{worst:.2e}")


def train_phase() -> dict:
    """Phase 5: the training step's main path, 3 steps at batch 8 in bf16,
    then its time, memory and profile. Returns its launch counts and
    numbers."""
    fn, (state, batch) = train_entry(device="cuda", batch=8)
    model = state.model
    log("train: GKGNet-S@576 bf16, batch 8, drop_path 0.1, AdamW + EMA, "
        "built")
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    knn_mr.launches = 0
    knn_mr.grouped_launches = 0
    knn_mr.backward_launches = 0
    knn_topk.launches = 0
    for i in range(3):
        f0, b0 = knn_mr.launches, knn_mr.backward_launches
        t = time.perf_counter()
        state, logs = fn(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        fwd, bwd = knn_mr.launches - f0, knn_mr.backward_launches - b0
        check(fwd == 16 and bwd == 16, f"train step {i}: {fwd} forward and "
              f"{bwd} backward launches, expected 16 and 16")
        values = {k: float(v) for k, v in logs.items()}
        if i == 0:  # phase 7 holds the grouped route's first step to these
            step1 = (values["loss"], {k: p.grad.detach().clone() for k, p in
                                      model.named_parameters()})
        for key in ("loss", "bce_loss", "asy_loss", "grad_norm"):
            check(math.isfinite(values[key]),
                  f"train step {i}: {key} = {values[key]}")
        log(f"train step {i}: {step_s * 1e3:.1f} ms host wall; " + ", ".join(
            f"{k} {v:.6g}" for k, v in values.items()))
    launches = (knn_mr.launches, knn_mr.backward_launches)
    check(knn_topk.launches == 0 and knn_mr.grouped_launches == 0,
          f"{knn_topk.launches} knn_topk and {knn_mr.grouped_launches} "
          f"grouped launches in 3 train steps, expected 0")
    unmoved = [k for k, v in model.named_parameters()
               if torch.equal(v.detach(), p0[k])]
    check(not unmoved, f"parameters that did not move: {unmoved[:5]}")
    sd = model.state_dict()
    still = [k for k, v in stats0.items() if torch.equal(sd[k], v)]
    check(not still, f"BatchNorm statistics that did not move: {still[:5]}")
    key = "backbone.stem.convs.0.weight"
    ema, p3 = state.ema_params[key], sd[key]
    check(not torch.equal(ema, p3) and not torch.equal(ema, p0[key])
          and (ema - p0[key]).abs().max() < (p3 - p0[key]).abs().max(),
          "the EMA is not between the initial and the new parameters")
    log(f"train: 3 steps passed: {launches[0]} forward and {launches[1]} "
        f"backward launches, every parameter and BatchNorm statistic moved, "
        f"the EMA between")

    torch.cuda.reset_peak_memory_stats()
    iters = 5
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    log(f"train: {step_ms:.2f} ms/step at batch 8, {8e3 / step_ms:.1f} img/s "
        f"(bf16, mean of {iters} steps, host clock with synchronize); peak "
        f"memory {peak / 2**30:.2f} GiB")
    profile_device(lambda: fn(state, batch), "step", iters=2)
    del fn, state, batch, model, p0, stats0, sd
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, peak_bytes=peak,
                step1=step1)


def compare_fp32_train() -> None:
    """One training step of GKGNet-S@576 at batch 2 in fp32 (TF32 off): each
    of the 16 backward calls held to the plain version on the step's own
    activations ((e) and (f)); then the same step from the same start on
    the plain path (both kernels replaced by their plain versions), and on
    the kernel path with every image value moved by one fp32 ulp. The
    losses and gradient norms are printed, not asserted: a near-tie
    neighbour flip in the forward changes the step (see
    compare_fp32_paths), and the one-ulp run shows how far the model
    itself moves the step for a change below any kernel's error."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = []
    kernel_bwd = knn_mr.launch_backward
    kernel_fwd = knn_mr.launch

    def recording(x, y, idx, g):
        out = kernel_bwd(x, y, idx, g)
        calls.append(((x, y, idx, g), out))
        return out

    def plain_fwd(x, y, bias, k, dilation):
        idx, mr = knn_mr.knn_mr_reference(x, y, bias, k, dilation)
        return idx, mr, l2_normalize(x), l2_normalize(y)

    def plain_bwd(x, y, idx, g):
        return knn_mr.knn_mr_backward_reference(x, y, idx, g)

    results = []
    for fwd, bwd, ulp in ((kernel_fwd, recording, False),
                          (plain_fwd, plain_bwd, False),
                          (kernel_fwd, kernel_bwd, True)):
        fn, (state, batch) = train_entry(device="cuda", batch=2,
                                         dtype=torch.float32)
        if ulp:
            batch["img"] = torch.nextafter(batch["img"],
                                           torch.full_like(batch["img"], 1e9))
        knn_mr.launch, knn_mr.launch_backward = fwd, bwd
        try:
            state, logs = fn(state, batch)
            torch.cuda.synchronize()
        finally:
            knn_mr.launch, knn_mr.launch_backward = kernel_fwd, kernel_bwd
        results.append({k: float(v) for k, v in logs.items()})
        del fn, state, batch
    check(len(calls) == 16, f"{len(calls)} backward calls, expected 16")
    worst = 0.0
    for i, ((x, y, idx, g), out) in enumerate(calls):
        _, err, tie_rows = check_backward(f"fp32 backward call {i}", x, y,
                                          idx, g, out)
        worst = max(worst, err)
        max_deg, p99_deg = in_degrees(idx, y.shape[1])
        print(f"  fp32 backward call {i:2d}: N={x.shape[1]:5d} "
              f"M={y.shape[1]:5d} D={x.shape[2]:3d} k={idx.shape[2]}: gy "
              f"bitwise the ordered plain version; {tie_rows} rows with a "
              f"tie; max |gy - fp64| {err:.3e}; in-degree max {max_deg}, "
              f"p99 {p99_deg:.0f}", flush=True)
    del calls
    torch.cuda.empty_cache()
    kernel, plain, moved = results

    def rel(key, other):
        return abs(kernel[key] - other[key]) / abs(kernel[key])

    log(f"train fp32 batch 2: 16 backward calls passed, gx bitwise -g and "
        f"gy bitwise the ordered plain version (worst |gy - fp64| "
        f"{worst:.3e}); loss: kernel {kernel['loss']:.7g}, plain "
        f"{plain['loss']:.7g} (rel diff {rel('loss', plain):.3e}), kernel on "
        f"images one ulp up {moved['loss']:.7g} (rel diff "
        f"{rel('loss', moved):.3e}); grad_norm: kernel "
        f"{kernel['grad_norm']:.7g}, plain {plain['grad_norm']:.7g} (rel diff "
        f"{rel('grad_norm', plain):.3e}), one ulp up {moved['grad_norm']:.7g} "
        f"(rel diff {rel('grad_norm', moved):.3e})")


GRAD_REL_TOL = 2.0 ** -6   # grouped vs default step-1 gradients where not
                           # bitwise; PERF.md section 6 states the reason


def record_grouped_calls(fn, model, x) -> list[tuple]:
    """The 16 ``knn_mr_fused_grouped`` calls of one forward ``fn(model, x)``
    on the grouped route: ``(args, (idx, mr))`` each, recorded by patching
    the name the Grapher convs call."""
    calls = []
    kernel_op = grapher.knn_mr_fused_grouped

    def recording(*args):
        out = kernel_op(*args)
        calls.append((args, out))
        return out

    grapher.knn_mr_fused_grouped = recording
    try:
        fn(model, x)
        torch.cuda.synchronize()
    finally:
        grapher.knn_mr_fused_grouped = kernel_op
    check(len(calls) == 16, f"{len(calls)} grouped calls, expected 16")
    return calls


def folded_route(x, y, bias, k, dil, g):
    """fold -> the folded kernel -> unfold, on unfolded rows: idx
    ``(B, N, g, k)``, mr ``(B, N, g*D)``; with y = x one fold serves both."""
    b, n, _ = x.shape
    xf = fold_groups(x, g)
    yf = xf if y is x else fold_groups(y, g)
    idx, mr, _, _ = knn_mr.launch(xf, yf, bias, k, dil)
    return (idx.reshape(b, g, n, k).permute(0, 2, 1, 3),
            unfold_groups(mr, g))


def check_grouped_calls(calls, label: str, timed: bool) -> list[dict]:
    """Each recorded call's grouped output held on its own rows to
    (a) fold -> the folded kernel -> unfold, bitwise, and (b) the plain
    version ``knn_mr_grouped_reference``: mr bitwise wherever idx agrees;
    the fp64 oracle on the kernel's idx at every (row, group) pair whose idx
    differs and at ORACLE_ROWS more; on the plain idx at every pair that
    differs, on the plain version's own normalized rows, so that each
    difference is a near-tie that fp32 rounding may decide either way; and
    idx equal on all but FLIP_SHARE of the pairs of the 16 calls. The share
    holds for the forward, not for each call as in ``compare_fp32_paths``:
    a label call of 1280 pairs would allow one flip, and label 4 in bf16
    has two, where the kernel's idx is the exact fp64 order.
    With ``timed``, the grouped kernel's, the folded route's (the copies
    and the folded kernel), the folded kernel's alone on the folded rows and
    the plain version's ms, and the bound (the folded row's bytes and
    operations). Returns one dict per call, with the largest |mr - plain mr|
    on the pairs whose idx agrees."""
    rows = []
    flips_all = pairs_all = 0
    for i, ((x, y, bias, k, dil, g), (idx, mr)) in enumerate(calls):
        b, n, c = x.shape
        m, d = y.shape[1], c // g
        ref_idx, ref_mr = folded_route(x, y, bias, k, dil, g)
        check(torch.equal(idx, ref_idx) and torch.equal(mr, ref_mr),
              f"{label} call {i}: the grouped kernel differs from fold -> "
              f"kernel -> unfold")
        idx_p, mr_p = knn_mr.knn_mr_grouped_reference(x, y, bias, k, dil, g)
        same = (idx_p == idx).all(-1)  # (B, N, g)
        flips = int((~same).sum())
        mr_s = mr.reshape(b, n, g, d)[same]
        mr_ps = mr_p.reshape(b, n, g, d)[same]
        err = ((mr_s.float() - mr_ps.float()).abs().max().item()
               if mr_s.numel() else math.nan)  # nan: no pair agrees
        # the oracle on the folded layout: flat row (b * g + gi) * N + i
        idx_k, _, xn, yn = knn_mr.launch_grouped(x, y, bias, k, dil, g)
        check(torch.equal(idx_k, idx), f"{label} call {i}: a second launch "
              f"gave another idx")
        gen = torch.Generator(device=x.device).manual_seed(i)
        flipped = (~same).permute(0, 2, 1).reshape(-1).nonzero().squeeze(1)
        checked = torch.cat([flipped, torch.randperm(
            b * g * n, generator=gen, device=x.device)[:ORACLE_ROWS]])
        gap = knn_mr.ordering_gaps(
            xn, yn, bias, idx.permute(0, 2, 1, 3).reshape(b * g, n, k), dil,
            checked).max().item()
        gap_p = 0.0
        if flips:
            xp = l2_normalize(fold_groups(x, g))
            yp = xp if y is x else l2_normalize(fold_groups(y, g))
            gap_p = knn_mr.ordering_gaps(
                xp, yp, bias, idx_p.permute(0, 2, 1, 3).reshape(b * g, n, k),
                dil, flipped).max().item()
            del xp, yp
        print(f"  grouped {label} call {i:2d}: N={n:5d} M={m:5d} D={d:3d} "
              f"k*d={k * dil:2d}: idx differs from the plain version's on "
              f"{flips}/{same.numel()} (row, group) pairs; worst fp64 gap "
              f"{gap:.2e} (the plain idx there {gap_p:.2e}); max|mr - plain| "
              f"where idx agrees {err:.3e}", flush=True)
        check(gap <= ORACLE_TOL and gap_p <= ORACLE_TOL, f"{label} call {i}: "
              f"fp64 gap {gap:.2e}, of the plain idx {gap_p:.2e}")
        flips_all += flips
        pairs_all += same.numel()
        check(torch.equal(mr_s, mr_ps), f"{label} call {i}: mr differs from "
              f"the plain version's where idx agrees")
        row = dict(call=i, dtype=label, B=b, groups=g, N=n, M=m, D=d,
                   kd=k * dil, max_abs_err=err, plain_idx_flips=flips,
                   oracle_gap=gap, plain_oracle_gap=gap_p)
        del idx_p, mr_p, mr_s, mr_ps, idx_k, xn, yn
        if timed:
            iters = 20 if n * m < 10**7 else 10
            row["ms"] = cuda_ms(lambda: knn_mr.launch_grouped(
                x, y, bias, k, dil, g), iters, 3)
            row["folded_ms"] = cuda_ms(lambda: folded_route(
                x, y, bias, k, dil, g), iters, 3)
            xf = fold_groups(x, g)
            yf = xf if y is x else fold_groups(y, g)
            row["folded_kernel_ms"] = cuda_ms(lambda: knn_mr.launch(
                xf, yf, bias, k, dil), iters, 3)
            del xf, yf
            row["plain_ms"] = cuda_ms(lambda: knn_mr.knn_mr_grouped_reference(
                x, y, bias, k, dil, g), 3, 1)
            nbytes = (x.nbytes + (0 if y is x else y.nbytes)
                      + (0 if bias is None else bias.nbytes)
                      + idx.nbytes + mr.nbytes)
            flops = 2.0 * b * n * m * c
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       calls_per_forward=1)
            print("grouped_row " + json.dumps(row), flush=True)
        rows.append(row)
    log(f"grouped {label}: idx differs from the plain version's on "
        f"{flips_all}/{pairs_all} (row, group) pairs of the 16 calls")
    check(flips_all <= FLIP_SHARE * pairs_all, f"{label}: {flips_all} (row, "
          f"group) pairs differ from the plain idx")
    return rows


def folded_backward(x, y, idx, g, groups):
    """fold -> the folded backward kernel -> unfold, on the unfolded rows
    and idx ``(B, N, g, k)`` of one grouped backward call."""
    b, n, _, k = idx.shape
    xf = fold_groups(x, groups)
    yf = xf if y is x else fold_groups(y, groups)
    idxf = idx.permute(0, 2, 1, 3).reshape(b * groups, n, k).contiguous()
    gx, gy = knn_mr.launch_backward(xf, yf, idxf, fold_groups(g, groups))
    return unfold_groups(gx, groups), unfold_groups(gy, groups)


def check_grouped_backward(calls, label: str) -> None:
    """Each recorded grouped backward call's gx and gy bitwise fold -> the
    folded backward -> unfold on the call's own inputs. The folded launches
    made to compare are not counted."""
    saved = knn_mr.backward_launches
    try:
        for i, ((x, y, idx, g, groups), (gx, gy)) in enumerate(calls):
            want_gx, want_gy = folded_backward(x, y, idx, g, groups)
            check(torch.equal(bits(gx), bits(want_gx))
                  and torch.equal(bits(gy), bits(want_gy)),
                  f"{label}: grouped backward call {i} (N={x.shape[1]}, "
                  f"M={y.shape[1]}) differs from fold -> folded backward -> "
                  f"unfold")
    finally:
        knn_mr.backward_launches = saved
    log(f"{label}: its 16 grouped backward calls bitwise fold -> folded "
        f"backward -> unfold")


def grouped_phase(ref_logits: torch.Tensor, ref_step1: tuple) -> dict:
    """Phase 7: the grouped path, with GKGNET_GROUPED=1 for this phase only.
    Returns its launch counts, times and per-call rows."""
    saved = os.environ.get("GKGNET_GROUPED")
    os.environ["GKGNET_GROUPED"] = "1"
    try:
        return _grouped_phase(ref_logits, ref_step1)
    finally:
        if saved is None:
            del os.environ["GKGNET_GROUPED"]
        else:
            os.environ["GKGNET_GROUPED"] = saved


def _grouped_phase(ref_logits: torch.Tensor, ref_step1: tuple) -> dict:
    fn, (model, x) = entry(device="cuda", batch=8)
    log("grouped: GKGNet-S@576 bf16, batch 8, GKGNET_GROUPED=1, built")
    knn_mr.launches = knn_mr.grouped_launches = 0
    knn_mr.backward_launches = knn_topk.launches = 0
    logits = fn(model, x)
    torch.cuda.synchronize()
    counts = (knn_mr.grouped_launches, knn_mr.launches, knn_topk.launches)
    check(counts == (16, 0, 0), f"grouped: (grouped, folded, knn_topk) "
          f"launches {counts} in one forward, expected (16, 0, 0)")
    check(torch.equal(logits.cpu(), ref_logits), "grouped: the logits are "
          "not bitwise the default route's")
    for i in range(3):
        images = torch.randn((8, 576, 576, 3),
                             generator=torch.Generator().manual_seed(100 + i))
        scores = predict(model, images.to(torch.bfloat16))
        torch.cuda.synchronize()
        check(scores.shape == (8, 80) and bool(torch.isfinite(scores).all()),
              f"grouped request {i}: scores {tuple(scores.shape)}")
    eval_launches = knn_mr.grouped_launches
    check(eval_launches == 64 and knn_mr.launches == 0
          and knn_mr.backward_launches == 0,
          f"grouped: {eval_launches} grouped, {knn_mr.launches} folded and "
          f"{knn_mr.backward_launches} backward launches over one forward "
          f"and 3 requests, expected 64, 0 and 0")
    log("grouped eval: 16 grouped launches per forward, 64 over one forward "
        "and 3 requests, no folded one; logits bitwise the default route's")
    fwd_ms = {}
    for turn, flag in enumerate(("0", "1", "1", "0")):
        os.environ["GKGNET_GROUPED"] = flag
        fwd_ms[turn] = (flag, cuda_ms(lambda: fn(model, x), 10, 2))
    os.environ["GKGNET_GROUPED"] = "1"
    default = [ms for flag, ms in fwd_ms.values() if flag == "0"]
    grouped = [ms for flag, ms in fwd_ms.values() if flag == "1"]
    log(f"grouped eval: {grouped[0]:.2f} and {grouped[1]:.2f} ms/forward at "
        f"batch 8 (bf16); the default route in the same turns "
        f"{default[0]:.2f} and {default[1]:.2f} (default, grouped, grouped, "
        f"default)")
    profile_device(lambda: fn(model, x), "grouped forward")
    rows = check_grouped_calls(record_grouped_calls(fn, model, x), "bf16",
                               timed=True)
    del fn, model, x, logits
    torch.cuda.empty_cache()
    fn, (model, x) = entry(device="cuda", batch=2, dtype=torch.float32)
    fp32_rows = check_grouped_calls(record_grouped_calls(fn, model, x),
                                    "fp32", timed=False)
    log("grouped: the 16 calls of the forward bitwise fold -> kernel -> "
        "unfold and held to the plain version (near-tie flips only, mr "
        "bitwise where idx agrees) on their own activations, bf16 batch 8 "
        "and fp32 batch 2")
    del fn, model, x
    torch.cuda.empty_cache()

    fn, (state, batch) = train_entry(device="cuda", batch=8)
    model = state.model
    knn_mr.launches = knn_mr.grouped_launches = 0
    knn_mr.backward_launches = knn_topk.launches = 0
    ref_loss, ref_grads = ref_step1
    kernel_bwd = knn_mr.launch_backward_grouped
    for i in range(3):
        before = (knn_mr.grouped_launches, knn_mr.backward_launches)
        calls = []

        def recording(*args):
            out = kernel_bwd(*args)
            calls.append((args, out))
            return out

        knn_mr.launch_backward_grouped = recording
        try:
            state, logs = fn(state, batch)
            torch.cuda.synchronize()
        finally:
            knn_mr.launch_backward_grouped = kernel_bwd
        fwd = knn_mr.grouped_launches - before[0]
        bwd = knn_mr.backward_launches - before[1]
        check(fwd == 16 and bwd == 16 and knn_mr.launches == 0
              and len(calls) == 16,
              f"grouped train step {i}: {fwd} grouped, {bwd} backward and "
              f"{knn_mr.launches} folded launches, {len(calls)} grouped "
              f"backward calls, expected 16, 16, 0 and 16")
        check_grouped_backward(calls, f"grouped train step {i}")
        del calls
        values = {k: float(v) for k, v in logs.items()}
        for key in ("loss", "grad_norm"):
            check(math.isfinite(values[key]),
                  f"grouped train step {i}: {key} = {values[key]}")
        if i == 0:
            check(values["loss"] == ref_loss, f"grouped train step 0: loss "
                  f"{values['loss']!r}, the default route's {ref_loss!r}")
            worst, bitwise = 0.0, 0
            for key, p in model.named_parameters():
                ref = ref_grads[key]
                if torch.equal(p.grad, ref):
                    bitwise += 1
                    continue
                rel = ((p.grad - ref).abs().max()
                       / ref.abs().max().clamp(min=1e-30)).item()
                print(f"  grouped step-1 gradient {key}: max|diff| / "
                      f"max|grad| {rel:.3e}", flush=True)
                worst = max(worst, rel)
                check(rel <= GRAD_REL_TOL, f"grouped step-1 gradient {key}: "
                      f"{rel:.3e} of its largest entry")
            log(f"grouped train step 0: loss bitwise the default route's; "
                f"{bitwise} of {len(ref_grads)} gradients bitwise, the rest "
                f"within {worst:.3e} of their largest entry")
        log(f"grouped train step {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in values.items()))
    train_launches = (knn_mr.grouped_launches, knn_mr.backward_launches)
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    log(f"grouped train: {step_ms:.2f} ms/step at batch 8 (bf16, mean of "
        f"{iters} steps, host clock with synchronize); peak memory "
        f"{peak / 2**30:.2f} GiB")
    del fn, state, batch, model
    torch.cuda.empty_cache()
    return dict(eval_launches=eval_launches, train_launches=train_launches,
                rows=rows, fp32_rows=fp32_rows, fwd_ms=fwd_ms,
                step_ms=step_ms)


def phases_phase() -> dict:
    """Phase 8: the four phase kernels at the tool's geometry: timed (each
    launched on that run), then each held to its plain version. Returns the
    launches, the times and the largest error."""
    x, y = phases.seeded_inputs("cuda")
    k = phases.K
    phases.launches = 0
    times = phases.time_phases(x, y, k, iters=10, warmup=2)
    torch.cuda.synchronize()
    launches = phases.launches
    check(launches == 4 * 12, f"{launches} phase launches, expected 48")
    # the least time of every phase: the distance products at the bf16
    # tensor-core peak (x and y read once, one float written per row, move
    # far less)
    nbytes = x.nbytes + y.nbytes + 4 * x.shape[0] * x.shape[1]
    t_ops = 2.0 * x.shape[0] * x.shape[1] * y.shape[1] * x.shape[2] \
        / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    exact_d, bound_d = phases.dist_bound(x, y)
    kernel_idx = knn_mr.launch(x, y, None, k)[0]
    worst = 0.0
    rows = {}
    for phase in phases.PHASES:
        got = phases.launch(phase, x, y, k).double()
        plain = phases.phase_reference(phase, x, y, k).double()
        if phase == "sel":
            check(bool((got == -math.inf).all() and (plain == -math.inf).all()),
                  "sel: the checksums are not -inf")
            err = 0.0
        else:
            if phase == "dist":
                exact, bound = exact_d, bound_d
            else:
                cols = (phases.fixed_columns(x, k) if phase == "gfix"
                        else kernel_idx)
                exact, bound = phases.gather_bound(x, y, cols)
            over = int(((got - exact).abs() > bound).sum())
            check(over == 0, f"{phase}: {over} checksums off the fp64 ones "
                  f"beyond the fp32 bound")
            if phase != "selg":  # selg's plain selection may flip near-ties
                over = int(((got - plain).abs() > 2 * bound).sum())
                check(over == 0, f"{phase}: {over} checksums off the plain "
                      f"version's beyond twice the bound")
            err = (got - plain).abs().max().item()
            worst = max(worst, (got - exact).abs().max().item())
        plain_ms = cuda_ms(lambda: phases.phase_reference(phase, x, y, k),
                           3, 1)
        rows[phase] = dict(ms=times[phase], plain_ms=plain_ms,
                           bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes", max_abs_err_vs_plain=err)
        print(f"phase_row {json.dumps(dict(phase=phase, **rows[phase]))}",
              flush=True)
    query_rows = x.shape[0] * x.shape[1]
    log("phases: " + ", ".join(
        f"{p} {r['ms']:.3f} ms ({r['ms'] / query_rows * 1e6:.3f} ns per "
        f"query row)" for p, r in rows.items())
        + f"; split of selg: scan {times['dist']:.3f} ms, selection "
        f"{times['sel'] - times['dist']:.3f} ms, gather "
        f"{times['gfix'] - times['dist']:.3f} ms")
    xs, ys = x[:2, :2048].contiguous(), y[:2].contiguous()
    for name, (differ, n_rows, gap) in phases.oracle(xs, ys, k).items():
        log(f"phases oracle[{name}]: order-mismatch rows {differ}/{n_rows}, "
            f"max fp64 gap {gap:.3e}")
        check(gap <= ORACLE_TOL, f"oracle[{name}]: fp64 gap {gap:.3e}")
    del x, y, exact_d, bound_d, kernel_idx
    torch.cuda.empty_cache()
    return dict(launches=launches, rows=rows, max_abs_err=worst)


def per_step(rows: list[dict], calls_key: str) -> dict:
    """The rows' ms, plain_ms and bound_ms summed over the main path's calls,
    and the bound that holds for the larger part of that bound_ms."""
    main_rows = [r for r in rows if r[calls_key]]
    total = {key: sum(r[key] * r[calls_key] for r in main_rows)
             for key in ("ms", "plain_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r[calls_key] for r in main_rows
                 if r["bound_by"] == "operations")
    total["bound_by"] = ("operations" if by_ops > total["bound_ms"] / 2
                         else "bytes")
    return total


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

    # 2. build: one nvcc per source, all started together
    t = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda load: load(), (knn_mr._lib, knn_mr._bwd_lib,
                                            knn_topk._lib)))
    for name in ("knn_mr", "knn_mr_bwd", "knn_topk"):
        seconds, compiler_log = _build.build_info[name]
        log(f"build: {name}.cu in {seconds:.1f} s")
        print_ptxas_summary(compiler_log)
    log(f"build: the three sources built and loaded in "
        f"{time.perf_counter() - t:.1f} s")

    # 3. kernels vs plain at every main-path shape
    rows = kernel_rows()
    log("kernels: every forward row passed (a) bitwise mr and (b) the fp64 "
        "oracle")
    bwd_rows = backward_rows()
    log("kernels: every backward row passed (e) gx bitwise -g, (f) gy "
        "bitwise the ordered plain version and within the fp64 bound, and "
        "(g) determinism")
    t_rows = topk_rows()
    log("kernels: every knn_topk row passed the fp64 oracle, the value bound, "
        "the plain idx up to near-ties, determinism and the tie and NaN "
        "fixtures")

    # 4. eval: the main path, then requests
    fn, (model, x) = entry(device="cuda", batch=8)
    log("model: GKGNet-S@576 bf16, batch 8, built")
    knn_mr.launches = 0
    knn_mr.grouped_launches = 0
    knn_mr.backward_launches = 0
    knn_topk.launches = 0
    logits = fn(model, x)
    torch.cuda.synchronize()
    check(knn_mr.launches == 16 and knn_topk.launches == 0
          and knn_mr.grouped_launches == 0,
          f"{knn_mr.launches} knn_mr, {knn_mr.grouped_launches} grouped and "
          f"{knn_topk.launches} knn_topk launches in one forward, expected "
          f"16, 0 and 0")
    ref_logits = logits.cpu()
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
    eval_launches = knn_mr.launches
    check(eval_launches == 64 and knn_mr.backward_launches == 0
          and knn_mr.grouped_launches == 0,
          f"{eval_launches} forward and {knn_mr.backward_launches} backward "
          f"launches over one forward and 3 requests, expected 64 and 0")
    fwd_ms = cuda_ms(lambda: fn(model, x), 10, 2)
    log(f"model: {fwd_ms:.2f} ms/forward at batch 8, "
        f"{8e3 / fwd_ms:.1f} img/s (bf16)")
    profile_device(lambda: fn(model, x), "forward")
    del model, x, logits
    torch.cuda.empty_cache()

    compare_fp32_paths()

    # 5. train: the main path, then the fp32 per-call check
    train = train_phase()
    compare_fp32_train()

    # 6. this slice's path: the Grapher blocks through knn_topk
    graph = grapher_phase()
    compare_fp32_grapher()

    # 7. the grouped path; 8. the phases
    grouped = grouped_phase(ref_logits, train.pop("step1"))
    phase = phases_phase()

    # 9. result lines
    fwd = per_step(rows, "calls_per_forward")
    bwd = per_step(bwd_rows, "calls_per_step")
    topk = per_step(t_rows, "calls_per_pass")
    g_fwd = per_step(grouped["rows"], "calls_per_forward")
    train_fwd, train_bwd = train["launches"]
    kernels = [{
        "name": "knn_mr_fused",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_mr.py:874",
        # the eval path (one forward + 3 requests) and the train path
        # (3 steps)
        "launches": eval_launches + train_fwd,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per forward at batch 8: the sum over the 16 calls' shapes
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,  # no single PyTorch call computes kNN + mr
    }, {
        "name": "knn_mr_backward",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr_bwd.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_mr.py:1054",
        "launches": train_bwd,
        # largest |gy - the ordered plain version's gy| over the rows (0:
        # bitwise; the rows print |gy - exact fp64 sum| as fp64_err)
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        # per train step at batch 8: the sum over the 16 calls' shapes
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the tie-split
                             # VJP of gather + max
    }, {
        "name": "knn_topk",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_topk.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_topk.py:140",
        # the Grapher path: 4 aggregators x 9 blocks x (eval + train) and
        # the 3 stochastic 'mr' blocks in train
        "launches": graph["launches"],
        # largest |distance - fp64 distance| over the rows' checked values
        "max_abs_err": max(r["max_abs_err"] for r in t_rows),
        # per aggregator pass at batch 8: the sum over the 9 blocks' calls
        "ms": topk["ms"],
        "plain_ms": topk["plain_ms"],
        "bound_ms": topk["bound_ms"],
        "bound_by": topk["bound_by"],
        "library_ms": None,  # no single PyTorch call computes distance +
                             # top-k (the rows print the two-call route)
    }, {
        "name": "knn_mr_fused_grouped",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_mr.py:1167",
        # the grouped path: eval (one forward + 3 requests) and train (3
        # steps)
        "launches": grouped["eval_launches"] + grouped["train_launches"][0],
        # largest |mr - the plain version's mr| over the 16 calls in bf16
        # and in fp32, on the (row, group) pairs whose idx agrees with the
        # plain idx (the rest are near-tie flips, held to the fp64 oracle)
        "max_abs_err": max(r["max_abs_err"] for r in
                           grouped["rows"] + grouped["fp32_rows"]),
        # per forward at batch 8: the sum over the 16 calls
        "ms": g_fwd["ms"],
        "plain_ms": g_fwd["plain_ms"],
        "bound_ms": g_fwd["bound_ms"],
        "bound_by": g_fwd["bound_by"],
        "library_ms": None,  # no single PyTorch call computes kNN + mr
    }, {
        "name": "exp_kernel_phases",
        "route": "cuda",
        # the phases are instantiations of the knn_mr forward kernel
        "source": "gkgnet_tpu_torch/csrc/knn_mr.cu",
        "replaces": "tools/exp_kernel_phases.py:108",
        # the tool's timing run: 4 phases x (2 warmup + 10 timed)
        "launches": phase["launches"],
        # largest |checksum - fp64 checksum| over dist, gfix and selg
        "max_abs_err": phase["max_abs_err"],
        # one launch of each of the four phases, summed
        "ms": sum(r["ms"] for r in phase["rows"].values()),
        "plain_ms": sum(r["plain_ms"] for r in phase["rows"].values()),
        "bound_ms": sum(r["bound_ms"] for r in phase["rows"].values()),
        "bound_by": phase["rows"]["selg"]["bound_by"],
        "library_ms": None,  # a phase is a piece of a kernel: no PyTorch
                             # call computes its checksum
    }]
    log(f"kernel knn_mr_fused: {eval_launches} launches on the eval path "
        f"(one forward + 3 requests) and {train_fwd} on the train path (3 "
        f"steps); kernel knn_mr_backward: {train_bwd} on the train path; "
        f"checks passed at {len(rows)} shapes each, 16 fp32 forward calls "
        f"and 16 fp32 backward calls on the model's own activations; kernel "
        f"knn_topk: {graph['launches']} launches on the Grapher path, checks "
        f"passed at {len(t_rows)} shapes and on the blocks' fp32 calls; "
        f"kernel knn_mr_fused_grouped: {grouped['eval_launches']} launches "
        f"on the grouped eval path and {grouped['train_launches'][0]} on its "
        f"train path, bitwise the folded route and held to the plain "
        f"version at the 16 calls in bf16 and fp32; kernel "
        f"exp_kernel_phases: {phase['launches']} launches on the tool's "
        f"run, every phase held to its plain version")
    log(f"done: {time.perf_counter() - T0:.1f} s in all")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
