"""Per-call time breakdown of the GKGNet forward (counterpart:
``tools/profile_breakdown.py``).

Times every distinct graph-conv call of the eval forward (the 12 Grapher
blocks by stage and dilation, and the 4 label taps, at the configured
batch) alone, through the kernel (``knn_mr_fused``: the hand-written CUDA
kernel on the card, its plain version on the CPU) and through its plain
version (``knn_mr_reference``), then the whole model both ways. The gap
between the kernel sum and the whole model is the dense (stem, convs, FFN,
BN) remainder. Prints a markdown table, the kernel sum, the remainder and
the model FLOPs, with the MFU against the card's published dense bf16 peak
(H100 SXM, 989 TFLOP/s; ``BENCH_PEAK_TFLOPS`` overrides it) beside
nvidia-smi's name and power limit.

Knobs (the JAX tool's): BD_BATCH (default 8), BD_SIZE (576), BD_ARCH (s),
BD_ITERS (10), BD_MODE (eval | train | both: train adds the forward +
backward per-call table, the whole train step of ``entry.train_entry``
and the step's split into eval forward, train forward (BatchNorm batch
moments, DropPath), forward + backward, and optimizer + EMA).

    python -m gkgnet_tpu_torch.tools.profile_breakdown [--device cpu]

Runs on the card unless ``--device cpu`` is given. Times come from
``utils.profiling.timeit``: CUDA events around BD_ITERS calls after a
warmup call on the card, the host clock's median on the CPU. (The JAX
tool differences two on-device ``lax.scan`` loops to cancel the fixed
dispatch cost of a remote TPU; a local card has none to cancel.) A shape
beyond the kernel's limits (``ops/knn_mr.py`` ``_check_launch``,
``block_layout``) is marked and counted at its plain time: on the card the
model itself would raise there.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import subprocess

import torch

from gkgnet_tpu_torch.core.trainer import ema_update
from gkgnet_tpu_torch.entry import entry, resolve_device, train_entry
from gkgnet_tpu_torch.nn.classifier import parse_losses
from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS, REDUCE_RATIOS
from gkgnet_tpu_torch.ops import knn_mr
from gkgnet_tpu_torch.ops.knn import l2_normalize
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu_torch.utils.profiling import model_flops, timeit

PEAK_TFLOPS = 989.0  # H100 SXM, dense bf16 (NVIDIA's data sheet)


def kernel_cases(arch: str, size: int, batch: int, k: int = 9,
                 num_group: int = 2) -> list[tuple]:
    """(name, count, BG, N, D, M, k, dilation, has_bias) for each distinct
    graph-conv shape of the forward, in the model's order; has_bias marks
    the Grapher calls (the relative-position bias), whose targets are the
    queries themselves where the stage's reduce ratio is 1."""
    opt = ARCH_SETTINGS[arch]
    blocks, channels = opt["blocks"], opt["channels"]
    bg = batch * num_group
    n = (size // 4) ** 2
    max_dil = 49 // k
    cases = []
    gi = 0
    for i, nb in enumerate(blocks):
        if i > 0:
            n //= 4
        c = channels[i]
        r = REDUCE_RATIOS[i]
        m = n // (r * r)
        dil_counts: dict[int, int] = {}
        for _ in range(nb):
            dil = min(gi // 4 + 1, max_dil)
            dil_counts[dil] = dil_counts.get(dil, 0) + 1
            gi += 1
        for dil, cnt in sorted(dil_counts.items()):
            cases.append((f"stage{i + 1}/d{dil}", cnt, bg, n, c // num_group,
                          m, k, dil, True))
        cases.append((f"label{i + 1}", 1, bg, 80, c // num_group, n, k, 1,
                      False))
    return cases


def case_inputs(case: tuple, dtype: torch.dtype, device: torch.device,
                gen: torch.Generator):
    """Seeded standard-normal (x, y, bias) of a case: the bias is the
    model's relative-position table of the stage (its channels, 2 groups
    of D, its nodes and reduce ratio), and y is x for a Grapher call whose
    stage does not pool its targets (N == M)."""
    _, _, bg, n, d, m, _, _, has_bias = case
    x = torch.randn((bg, n, d), generator=gen).to(device=device, dtype=dtype)
    bias = None
    if has_bias:
        table = get_relative_pos_table(2 * d, n, math.isqrt(n // m))
        bias = torch.from_numpy(table).to(device)
        if n == m:
            return x, x, bias
    y = torch.randn((bg, m, d), generator=gen).to(device=device, dtype=dtype)
    return x, y, bias


def kernel_fits(n: int, m: int, d: int, kd: int, dtype: torch.dtype,
                device: torch.device) -> bool:
    """Whether the kernel takes the call (its checks in ``_check_launch``
    and, on the card, a block layout that fits its shared memory)."""
    if kd > knn_mr.MAX_KD or kd > m or (n + 7) // 8 > 65535:
        return False
    return device.type != "cuda" or knn_mr.block_layout(d, kd, dtype)[0] > 0


@contextlib.contextmanager
def plain_kernels():
    """The kernels' launches replaced by their plain versions (the JAX
    tool's ``set_knn_impl('xla')``): a model on the card then runs the
    graph convs and their backward as the CPU does."""
    launch, backward = knn_mr.launch, knn_mr.launch_backward

    def plain(x, y, bias, k, dilation=1):
        idx, mr = knn_mr.knn_mr_reference(x, y, bias, k, dilation)
        return idx.contiguous(), mr, l2_normalize(x), l2_normalize(y)

    knn_mr.launch = plain
    knn_mr.launch_backward = knn_mr.knn_mr_backward_reference
    try:
        yield
    finally:
        knn_mr.launch, knn_mr.launch_backward = launch, backward


def _ms(fn, x: torch.Tensor, iters: int) -> float:
    """ms per call of ``fn()`` (timeit on the card when x is there)."""
    return timeit(lambda _: fn(), x, iters=iters) * 1e3


def card_line() -> str:
    """nvidia-smi's name and power limit of the card (or that there is
    none)."""
    if not torch.cuda.is_available():
        return "no card (CPU run)"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return proc.stdout.strip().splitlines()[0]


def eval_tables(arch: str, size: int, batch: int, iters: int,
                device: torch.device, dtype: torch.dtype = torch.bfloat16
                ) -> dict:
    """The whole model both ways, then each case alone both ways; prints
    the table and returns its numbers."""
    # the whole model first, before the cases' inputs hold memory
    fn, (model, x) = entry(device=device, batch=batch, dtype=dtype,
                           arch=arch, size=size)
    t_model = _ms(lambda: fn(model, x), x, iters)
    with plain_kernels():
        t_model_plain = _ms(lambda: fn(model, x), x, iters)
    print(f"full model: kernel {t_model:.2f} ms  plain "
          f"{t_model_plain:.2f} ms", flush=True)
    del fn, model, x

    gen = torch.Generator().manual_seed(0)
    rows = []
    for case in kernel_cases(arch, size, batch):
        name, cnt, bg, n, d, m, k, dil, _ = case
        xc, yc, bias = case_inputs(case, dtype, device, gen)
        t_plain = _ms(lambda: knn_mr.knn_mr_reference(xc, yc, bias, k, dil),
                      xc, iters)
        fits = kernel_fits(n, m, d, k * dil, dtype, device)
        t_kernel = _ms(lambda: knn_mr.knn_mr_fused(xc, yc, bias, k, dil),
                       xc, iters) if fits else None
        rows.append(dict(name=name, count=cnt, BG=bg, N=n, M=m, D=d,
                         kd=k * dil, kernel_ms=t_kernel, plain_ms=t_plain,
                         fits=fits))
        kernel_txt = f"{t_kernel:7.2f}" if fits else "    n/a"
        print(f"  {name}: kernel {kernel_txt} ms  plain {t_plain:7.2f} ms"
              f"  x{cnt}  (fits={fits})", flush=True)
        del xc, yc, bias
    total = sum(r["count"] * (r["kernel_ms"] if r["fits"] else r["plain_ms"])
                for r in rows)
    total_plain = sum(r["count"] * r["plain_ms"] for r in rows)

    fl = model_flops(arch, size, batch)
    peak = float(os.environ.get("BENCH_PEAK_TFLOPS", PEAK_TFLOPS)) * 1e12
    print()
    print("| call | xN | BG | N | M | D | k*d | kernel ms | plain ms |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        kernel_txt = (f"{r['kernel_ms']:.2f}" if r["fits"]
                      else "n/a (beyond the kernel's limits)")
        print(f"| {r['name']} | {r['count']} | {r['BG']} | {r['N']} "
              f"| {r['M']} | {r['D']} | {r['kd']} | {kernel_txt} "
              f"| {r['plain_ms']:.2f} |")
    print(f"| kernel SUM | | | | | | | {total:.2f} | {total_plain:.2f} |")
    print(f"| FULL MODEL | | | | | | | {t_model:.2f} "
          f"| {t_model_plain:.2f} |")
    dense = t_model - total
    print(f"\ndense remainder (model - kernels): {dense:.2f} ms")
    line = (f"model flops: {fl['per_image_total'] / 1e9:.1f} G/img; ")
    if device.type == "cuda":
        mfu = fl["total"] / (t_model * 1e-3) / peak
        line += (f"MFU at full-model time: {mfu * 100:.1f}% (dense bf16 "
                 f"peak {peak / 1e12:.0f} TF; {card_line()})")
    else:
        mfu = None
        line += "MFU: not measured (a CPU run)"
    print(line, flush=True)
    return dict(rows=rows, kernel_sum_ms=total, plain_sum_ms=total_plain,
                model_ms=t_model, model_plain_ms=t_model_plain,
                dense_ms=dense, flops=fl["total"], mfu=mfu)


def train_tables(arch: str, size: int, batch: int, iters: int,
                 device: torch.device, dtype: torch.dtype = torch.bfloat16
                 ) -> dict:
    """The forward + backward of each case through the kernel, the whole
    train step and its split; prints the tables and returns the numbers."""
    print("\n-- train (forward + backward) per call --", flush=True)
    gen = torch.Generator().manual_seed(0)
    rows = []
    total = 0.0
    for case in kernel_cases(arch, size, batch):
        name, cnt, _, n, d, m, k, dil, _ = case
        if not kernel_fits(n, m, d, k * dil, dtype, device):
            continue
        xc, yc, bias = case_inputs(case, dtype, device, gen)
        xc.requires_grad_()
        if yc is not xc:
            yc.requires_grad_()
        inputs = (xc,) if yc is xc else (xc, yc)

        def fwd_bwd(xc=xc, yc=yc, bias=bias, k=k, dil=dil, inputs=inputs):
            _, mr = knn_mr.knn_mr_fused(xc, yc, bias, k, dil)
            return torch.autograd.grad(mr.float().square().sum(), inputs)

        t_fb = _ms(fwd_bwd, xc, iters)
        rows.append(dict(name=name, count=cnt, fwd_bwd_ms=t_fb))
        total += cnt * t_fb
        print(f"  {name}: fwd+bwd {t_fb:7.2f} ms  x{cnt}", flush=True)
        del xc, yc, bias, inputs

    step, (state, data) = train_entry(device=device, batch=batch,
                                      dtype=dtype, arch=arch, size=size)
    model = state.model
    img, gt = data["img"], data["gt_label"]

    def run_step():
        step(state, data)

    t_step = _ms(run_step, img, iters)

    def fwd_eval():
        model.eval()
        with torch.no_grad():
            model(img)
        model.train()

    def fwd_train():
        with torch.no_grad():
            model(img, generator=torch.Generator(device).manual_seed(1))

    def fwd_bwd_model():
        score, _ = model(img, generator=torch.Generator(device).manual_seed(1))
        loss, _ = parse_losses(model.build_loss_head().loss(score, gt))
        torch.autograd.grad(loss, [p for p in model.parameters()
                                   if p.requires_grad], allow_unused=True)

    t_fe = _ms(fwd_eval, img, iters)
    t_ft = _ms(fwd_train, img, iters)
    t_fb = _ms(fwd_bwd_model, img, iters)
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-4)

    def opt_only():
        state.optimizer.update(state.step)
        ema_update(state.ema_params, model, state.step, 2e-4)

    t_opt = _ms(opt_only, img, iters)

    print("\n| call | xN | fwd+bwd ms |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r['name']} | {r['count']} | {r['fwd_bwd_ms']:.2f} |")
    print(f"| kernel SUM | | {total:.2f} |")
    print(f"| FULL TRAIN STEP | | {t_step:.2f} |")
    print(f"\ntrain dense+loss+opt remainder: {t_step - total:.2f} ms")
    print("\n-- train phase split --")
    print("| phase | ms | delta |")
    print("|---|---|---|")
    print(f"| fwd eval-mode | {t_fe:.2f} | |")
    print(f"| fwd train-mode (BN stats, droppath) | {t_ft:.2f} "
          f"| +{t_ft - t_fe:.2f} |")
    print(f"| fwd+bwd (dual loss, grad) | {t_fb:.2f} | +{t_fb - t_ft:.2f} |")
    print(f"| optimizer+EMA standalone | {t_opt:.2f} | |")
    print(f"| full step (clip+sched+logvars) | {t_step:.2f} "
          f"| +{t_step - t_fb - t_opt:.2f} |", flush=True)
    return dict(rows=rows, kernel_sum_ms=total, step_ms=t_step,
                fwd_eval_ms=t_fe, fwd_train_ms=t_ft, fwd_bwd_ms=t_fb,
                opt_ms=t_opt)


def main(argv=None) -> dict:
    """Returns ``{'eval': eval_tables(...)}`` and/or ``{'train': ...}`` by
    BD_MODE."""
    p = argparse.ArgumentParser(description="per-call time breakdown")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    batch = int(os.environ.get("BD_BATCH", "8"))
    size = int(os.environ.get("BD_SIZE", "576"))
    arch = os.environ.get("BD_ARCH", "s")
    iters = int(os.environ.get("BD_ITERS", "10"))
    mode = os.environ.get("BD_MODE", "eval")
    if mode not in ("eval", "train", "both"):
        raise ValueError(f"BD_MODE must be eval, train or both, got {mode}")
    print(f"device: {device} ({card_line()})  batch={batch} size={size} "
          f"arch={arch}", flush=True)
    out = {}
    if mode in ("eval", "both"):
        out["eval"] = eval_tables(arch, size, batch, iters, device)
    if mode in ("train", "both"):
        out["train"] = train_tables(arch, size, batch, iters, device)
    return out


if __name__ == "__main__":
    main()
