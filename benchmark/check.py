"""The comparison that decides ``correct``: the numbers read from what the
timed path produced against the plain fp32 reference, each held to its
limit from ``limits/<workload>.json``.

Training (the first ``checked_steps`` steps, which set-up drives through
the window's own call on distinct batches, before the window):

  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: over the leaves, the gap between the norms of the first
    step's gradient as the optimizer took it (program: AdamW's first moment
    after one step over 1 - beta1; reference: after clipping), over the
    larger of the reference leaf's norm and the median leaf's;
  * ``change_gap``: the same for the norm of each leaf's change after the
    checked steps, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's: below that (a conv bias under a
    train-mode BatchNorm) the gradient is round-off alone, which moves the
    leaf under Adam by that round-off. ``grad_gap`` keeps those leaves: the
    fp8 control's rounded gradients break their cancellation, and it is
    there that the control reads highest (``_grad_gap_moved`` is the gap
    without them, for the record).

Scoring and serving: ``score_gap``, the widest gap of a sigmoid score over
a sample of the window's answers drawn from the seed.

The reference runs after the window, once the program's state is freed,
in fp32 with TF32 off and cuDNN's deterministic algorithms.
"""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference.model import PlainGKGNet
from benchmark.reference.train import PlainTrainer

GRAD_FLOOR = 1e-3


@contextlib.contextmanager
def fp32_exact():
    """TF32 off and deterministic cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """``max |prog - ref| / max(ref, median ref)`` over the leaves (those
    in ``keep`` if given), and the worst leaf's name."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def reference_training(cfg: dict, params: dict, pool: dict, steps: int,
                       seed: int) -> dict:
    """The reference's losses, first-gradient norms and change norms over
    the first ``steps`` pool batches."""
    with fp32_exact():
        trainer = PlainTrainer(cfg, params)
        losses = [trainer.step(inputs.normalize(pool["img"][i],
                                                cfg["img_norm"]),
                               pool["gt"][i], seed) for i in range(steps)]
        grads = {k: float(torch.linalg.vector_norm(g))
                 for k, g in trainer.first_grads.items()}
        change = {k: float(torch.linalg.vector_norm(p.detach() - params[k]))
                  for k, p in trainer.params.items()}
    return {"loss": losses, "grad": grads, "change": change}


def train_readings(prog: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                    ref["loss"]))
    med = statistics.median(ref["grad"].values())
    moved = {k for k, v in ref["grad"].items() if v >= GRAD_FLOOR * med}
    grad, grad_leaf = worst_leaf_gap(prog["grad"], ref["grad"])
    grad_moved, _ = worst_leaf_gap(prog["grad"], ref["grad"], moved)
    change, change_leaf = worst_leaf_gap(prog["change"], ref["change"],
                                         moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "_grad_gap_moved": grad_moved, "_grad_leaf": grad_leaf,
            "_change_leaf": change_leaf,
            "_leaves_left_out": len(ref["grad"]) - len(moved)}


def reference_scores(cfg: dict, params: dict, stats: dict,
                     imgs: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """The reference's sigmoid scores of fp32 NHWC images, ``rows`` at a
    time."""
    out = []
    with fp32_exact(), torch.no_grad():
        model = PlainGKGNet(cfg["model"], params, stats)
        for i in range(0, imgs.shape[0], rows):
            out.append(torch.sigmoid(model.forward(imgs[i:i + rows])))
    return torch.cat(out)


def score_readings(answers: list, ref: dict) -> dict:
    """``answers``: ``(pool index, scores)`` pairs; ``ref``: pool index ->
    reference scores."""
    gap = max(float((s.float().cpu() - ref[j].cpu()).abs().max())
              for j, s in answers)
    return {"score_gap": gap}


def sample(n: int, k: int, seed: int) -> list[int]:
    """``k`` of ``range(n)`` drawn from the seed, sorted."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each limited number beside its limit; a
    reading that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
