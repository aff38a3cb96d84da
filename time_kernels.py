"""Time the knn_mr forward and knn_topk kernels of one checkout at the main
paths' shapes, to compare two checkouts on one card.

    python3 time_kernels.py [--tag NAME] [--iters 20]
        [--sweep | --model | --blocks]

Run a copy of it from the root of each checkout, in turns (parent, change,
change, parent), on the same card: it takes ``cuda_ms``, ``BG``, the s@576
calls (``ROWS``) and knn_topk's fp32 row (``TOPK_ROWS``) from that
checkout's ``chip_smoke.py`` and calls only ``knn_mr.launch`` and
``knn_topk.launch``, so it runs in older checkouts too (a shape whose
kernel a checkout lacks prints its error). The shapes: s@576's calls at
batch 8 in their own type and all in fp32, arch b@576's (``B_SHAPES``),
knn_topk's fp32 row, and the fp32 calls of the t@128 model that
dryrun_multichip trains (recorded from one forward at batch 8: shapes and
bias only). The inputs are seeded, so the printed SHA-1 of each call's
outputs (knn_mr's idx and mr, then knn_topk's idx and distances on knn_mr's
normalized rows) shows whether two checkouts compute the same bits. One
``time_row`` JSON line per shape: its name, dtype, BG, N, M, D, k*d,
knn_mr's and knn_topk's ms (CUDA events, the mean of ``--iters`` launches
after 3 warmup), the digest, or the error, and at fp32 shapes the plain
versions' ms (``plain_ms``, ``topk_plain_ms``: 3 calls after one warmup);
a knn_topk-only row (k*d: its k) times knn_topk alone and the two-call
route (fp32 ``baddbmm`` + ``topk``).
Then the grouped kernel (``knn_mr.launch_grouped``) at s@576's calls in
fp32 (``grouped_row``: 8 images of 2 channel groups) and the phase tool's
four phases in fp32 at its stage-1 geometry (``phase_row``), each with its
ms and digest.
``--model`` instead times the s@576 eval forward at batch 8 in fp32 (TF32
off; CUDA events, 2 warmup, the mean of 10) and profiles it by kernel
(``model_row``: ms, the device's busy ms and the fp32 knn_mr kernel's).
``--sweep`` instead times the fp32 kernels at BG 8, N = M = 324 with the
stage-4 bias over D and k*d (``sweep_row``; where the checkout has the
``_FP32_BLOCK`` hook, also at 64 query rows and one column group a block,
``alt_ms``), and profiles one D = 1024 call of each kernel and of its
plain version by kernel (``chip_smoke.profile_device``). ``--blocks``
instead times the fp32 kernels at a few shapes (``BLOCK_SHAPES``) on every
block shape they take (query rows, column groups; ``block_row``), beside
the one the host picks. Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys

import torch

import chip_smoke
from gkgnet_tpu_torch.entry import DRYRUN_MODELS, entry
from gkgnet_tpu_torch.nn import grapher
from gkgnet_tpu_torch.nn.classifier import (GKGNetClassifier,
                                            init_parameters)
from gkgnet_tpu_torch.ops import knn_mr, knn_topk
from gkgnet_tpu_torch.ops.knn import knn_topk_reference
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu_torch.tools import exp_kernel_phases as phases

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


def t128_shapes() -> list[tuple]:
    """The distinct knn_mr calls of one forward of dryrun_multichip's t@128
    model (fp32) at batch 8, recorded on the card: shapes and bias."""
    kwargs, dtype, _ = DRYRUN_MODELS["t128"]
    model = GKGNetClassifier(**kwargs, dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.randn((8, kwargs["size"], kwargs["size"], 3),
                    generator=torch.Generator().manual_seed(1)).cuda()
    calls, op = {}, grapher.knn_mr_fused

    def recording(xx, yy, bias, k, dil):
        key = (xx.shape[1], yy.shape[1], xx.shape[2], k, dil,
               yy is xx, bias is not None)
        calls.setdefault(key, (xx.shape[0], bias))
        return op(xx, yy, bias, k, dil)

    grapher.knn_mr_fused = recording
    try:
        with torch.no_grad():
            model(x)
    finally:
        grapher.knn_mr_fused = op
    return [(f"t128_n{n}_m{m}_d{d}_kd{k * dil}", bg, n, None if self_knn
             else m, d, k, dil, bias, "fp32")
            for (n, m, d, k, dil, self_knn, _), (bg, bias) in calls.items()]


def shapes() -> list[tuple]:
    """chip_smoke.ROWS at its BG (self-kNN where the targets are the
    queries) in their own type, then in fp32, B_SHAPES, knn_topk's fp32
    rows of chip_smoke.TOPK_ROWS (k*d None: knn_topk alone) and the t@128
    calls."""
    s = [(f"s_{name}", chip_smoke.BG, n, None if targets == "self" else m,
          d, k, dil, table, dt)
         for (name, n, m, d, k, dil, table, _, dt, targets) in chip_smoke.ROWS]
    s += [(f"s_{name}_fp32", chip_smoke.BG, n,
           None if targets == "self" else m, d, k, dil, table, "fp32")
          for (name, n, m, d, k, dil, table, _, dt, targets) in chip_smoke.ROWS
          if dt == "bf16"]
    s += [(f"topk_{name}", bg, n, None if targets == "self" else m, d, k,
           None, table, dt)
          for (name, n, m, d, k, table, bg, _, dt, targets)
          in chip_smoke.TOPK_ROWS if dt == "fp32"]
    return s + B_SHAPES + t128_shapes()


# --sweep: the widths and (k, dilation) pairs of the fp32 sweep
SWEEP_D = (128, 256, 512, 768, 1024)
SWEEP_KD = ((9, 1), (9, 5))

# --blocks: fp32 shapes (as shapes(); dilation None: knn_topk alone), and
# the block shapes the fp32 kernels take
BLOCK_SHAPES = [
    ("b_ungrouped_stage4_d5_fp32", 8, 324, None, 1024, 9, 5,
     (1024, 324, 1), "fp32"),
    ("b_ungrouped_label4_fp32", 8, 80, 324, 1024, 9, 1, None, "fp32"),
    ("topk_grapher3_d2_fp32", 8, 1296, None, 400, 18, None, (400, 1296, 1),
     "fp32"),
    ("s_stage1_fp32", 16, 20736, 1296, 40, 9, 1, (80, 20736, 4), "fp32"),
    ("s_stage3_d2_fp32", 16, 1296, None, 200, 9, 2, (400, 1296, 1), "fp32"),
    ("s_label1_fp32", 16, 80, 20736, 40, 9, 1, None, "fp32"),
    ("t128_stage4_fp32", 16, 16, None, 192, 9, 1, None, "fp32"),
]
BLOCKS = ((64, 1), (32, 1), (32, 2), (16, 1), (16, 2), (16, 4), (8, 1),
          (8, 2), (8, 4))


@contextlib.contextmanager
def fp32_block(block):
    """The fp32 kernels' blocks at ``block`` (query rows, column groups)
    through the modules' test hooks: ``chip_smoke.fp32_block``, which an
    older checkout's ``chip_smoke.py`` lacks."""
    saved = knn_mr._FP32_BLOCK, knn_topk._FP32_BLOCK
    knn_mr._FP32_BLOCK = knn_topk._FP32_BLOCK = block
    try:
        yield
    finally:
        knn_mr._FP32_BLOCK, knn_topk._FP32_BLOCK = saved


def sweep(iters: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bias = torch.from_numpy(get_relative_pos_table(1024, 324, 1)).cuda()
    alt = hasattr(knn_mr, "_FP32_BLOCK")
    for d in SWEEP_D:
        x = torch.randn((8, 324, d), generator=gen, device="cuda")
        xn = knn_mr.l2_normalize(x)
        for k, dil in SWEEP_KD:
            row = dict(D=d, kd=k * dil,
                       chunked=knn_mr.block_layout(d, k * dil)[1])
            if alt:
                row["block"] = knn_mr.fp32_block(8, 324, 324, k * dil)
            for other in (False, True) if alt else (False,):
                with fp32_block((64, 1)) if other else \
                        contextlib.nullcontext():
                    key = "alt_" if other else ""
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


def two_call_route(xn, yn, k, bias):
    """The fp32 two-call PyTorch route of chip_smoke.py's topk rows: the
    squares (and bias) summed outside the timed calls, then baddbmm and
    topk."""
    x32, y32 = xn.float(), yn.float()
    base = (x32 * x32).sum(-1)[:, :, None] + (y32 * y32).sum(-1)[:, None, :]
    if bias is not None:
        base = base + bias
    return lambda: torch.topk(torch.baddbmm(
        base, x32, y32.transpose(1, 2), alpha=-2.0), k, largest=False)


def time_shape(shape: tuple, iters: int) -> dict:
    """dil None: a knn_topk-only row of k neighbours on normalized rows."""
    name, bg, n, m, d, k, dil, table, dt = shape
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((bg, n, d), generator=gen, device="cuda").to(dtype)
    y = x if m is None else torch.randn((bg, m, d), generator=gen,
                                        device="cuda").to(dtype)
    if isinstance(table, torch.Tensor):
        bias = table
    else:
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
    row = dict(name=name, dtype=dt, BG=bg, N=n, M=y.shape[1], D=d,
               kd=k * (dil or 1))
    if dil is None:  # knn_topk alone
        xn = knn_mr.l2_normalize(x)
        yn = xn if y is x else knn_mr.l2_normalize(y)
        try:
            t_idx, t_vals = knn_topk.launch(xn, yn, k=k, bias=bias,
                                            return_values=True)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            return dict(row, error=str(e).splitlines()[0])
        row["topk_ms"] = chip_smoke.cuda_ms(
            lambda: knn_topk.launch(xn, yn, k=k, bias=bias), iters, 3)
        row["two_call_ms"] = chip_smoke.cuda_ms(
            two_call_route(xn, yn, k, bias), iters, 3)
        row["plain_ms"] = chip_smoke.cuda_ms(
            lambda: knn_topk_reference(xn, yn, k=k, bias=bias), 3, 1)
        row["digest"] = digest(t_idx, t_vals)
        return row
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
    if dt == "fp32":  # the plain versions' times beside the kernels'
        row["plain_ms"] = chip_smoke.cuda_ms(
            lambda: knn_mr.knn_mr_reference(x, y, bias, k, dil), 3, 1)
        row["topk_plain_ms"] = chip_smoke.cuda_ms(
            lambda: knn_topk_reference(xn, yn, k=k * dil, bias=bias), 3, 1)
    return row


def blocks(iters: int) -> None:
    """Each of BLOCK_SHAPES on the host's block and on every one of BLOCKS:
    knn_mr's and knn_topk's ms."""
    for shape in BLOCK_SHAPES:
        name, bg, n, m, d, k, dil = shape[:7]
        kd = k * (dil or 1)
        row = dict(name=name, BG=bg, N=n, M=n if m is None else m, D=d,
                   kd=kd, host=knn_mr.fp32_block(bg, n, n if m is None
                                                 else m, kd))
        for block in (None,) + BLOCKS:
            with fp32_block(block):
                got = time_shape(shape, iters)
            row[str(block or "host")] = [got.get("ms"), got.get("topk_ms")]
        print("block_row " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()


def time_grouped(iters: int) -> list[dict]:
    """knn_mr.launch_grouped at s@576's calls in fp32: 8 images of 2
    groups of each call's D channels (BG 16 folded)."""
    rows = []
    for (name, n, m, d, k, dil, table, _, dt, targets) in chip_smoke.ROWS:
        if dt != "bf16":
            continue
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((chip_smoke.BG // 2, n, 2 * d), generator=gen,
                        device="cuda")
        y = x if targets == "self" else torch.randn(
            (chip_smoke.BG // 2, m, 2 * d), generator=gen, device="cuda")
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
        idx, mr, _, _ = knn_mr.launch_grouped(x, y, bias, k, dil, 2)
        ms = chip_smoke.cuda_ms(
            lambda: knn_mr.launch_grouped(x, y, bias, k, dil, 2), iters, 3)
        rows.append(dict(name=f"g_{name}_fp32", dtype="fp32",
                         B=chip_smoke.BG // 2, groups=2, N=n, M=y.shape[1],
                         D=d, kd=k * dil, ms=ms, digest=digest(idx, mr)))
    return rows


def time_phases(iters: int) -> list[dict]:
    """The phase tool's four phases in fp32 at its stage-1 geometry."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((phases.BG, phases.N, phases.D), generator=gen,
                    device="cuda")
    y = torch.randn((phases.BG, phases.M, phases.D), generator=gen,
                    device="cuda")
    rows = []
    for phase in phases.PHASES:
        out = phases.launch(phase, x, y, phases.K)
        ms = chip_smoke.cuda_ms(lambda: phases.launch(phase, x, y, phases.K),
                                iters, 3)
        rows.append(dict(name=f"phase_{phase}_fp32", dtype="fp32", ms=ms,
                         digest=digest(out)))
    return rows


def model(iters: int) -> None:
    """The s@576 eval forward at batch 8 in fp32 (TF32 off), timed and
    profiled."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fn, (m, x) = entry(device="cuda", batch=8, dtype=torch.float32)
    with torch.no_grad():
        ms = chip_smoke.cuda_ms(lambda: fn(m, x), iters, 2)
        prof = chip_smoke.profile_device(lambda: fn(m, x), "forward")
    print("model_row " + json.dumps(dict(
        name="s576_eval_fp32_batch8", ms=ms, busy_ms=prof["busy"],
        knn_mr_kernel_ms=prof["ours"].get("knn_mr_kernel", 0.0))),
        flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="", help="printed on every row")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--sweep", action="store_true",
                        help="the fp32 sweep and profiles instead")
    parser.add_argument("--model", action="store_true",
                        help="the fp32 s@576 eval forward instead")
    parser.add_argument("--blocks", action="store_true",
                        help="the fp32 kernels on every block shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.sweep:
        sweep(args.iters)
        return 0
    if args.model:
        model(10)
        return 0
    if args.blocks:
        blocks(args.iters)
        return 0
    for shape in shapes():
        row = dict(tag=args.tag, **time_shape(shape, args.iters))
        print("time_row " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    for row in time_grouped(args.iters):
        print("grouped_row " + json.dumps(dict(tag=args.tag, **row)),
              flush=True)
    for row in time_phases(args.iters):
        print("phase_row " + json.dumps(dict(tag=args.tag, **row)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
