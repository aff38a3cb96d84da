"""The plain training step of the GKGNet recipe: the dual loss
(label-smoothed sigmoid BCE summed and divided by the batch, plus 10x the
asymmetric loss), the gradients by autograd, clipping by the global norm,
AdamW (optax's arithmetic: bias-corrected moments, eps outside the root,
decoupled decay where ``model.decayed`` allows it) at the step-decay
schedule's rate with a linear warmup, and each step's DropPath draws from a
generator seeded from ``(seed, step)``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.model import PlainGKGNet, decayed, identity


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's draws: a word of ``SeedSequence([seed,
    step])``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def dual_loss(logits: torch.Tensor, gt: torch.Tensor, head: dict
              ) -> torch.Tensor:
    pred, t = logits.float(), gt.float()
    p = torch.sigmoid(pred)
    clip = head["clip"]
    pt = torch.clamp(1.0 - p + clip, max=1.0) * (1.0 - t) + p * t
    w = torch.pow(1.0 - pt, head["gamma_pos"] * t
                  + head["gamma_neg"] * (1.0 - t))
    asy = (-torch.log(torch.clamp(pt, min=1e-8)) * w).mean()
    eps = head["label_smooth_val"]
    s = torch.where(t > 0, 1.0 - eps, eps)
    bce = torch.clamp(pred, min=0) - pred * s \
        + torch.log1p(torch.exp(-pred.abs()))
    return bce.sum() / pred.shape[0] + head["asy_loss_scale"] * asy


def learning_rate(recipe: dict, step: int) -> float:
    """The rate of the step that follows ``step`` earlier updates."""
    opt, sched = recipe["optimizer"], recipe["lr_config"]
    per_epoch = recipe["steps_per_epoch"]
    lr = opt["lr"] * sched.get("gamma", 0.1) ** sum(
        step >= m * per_epoch for m in sched["step"])
    warmup = sched.get("warmup_iters", 0) * (
        per_epoch if sched.get("warmup_by_epoch") else 1)
    if step < warmup:
        frac = min(step / warmup, 1.0)
        lr *= 1.0 - (1.0 - frac) * (1.0 - sched.get("warmup_ratio", 1e-3))
    return lr


class PlainTrainer:
    """Parameters (fp32 leaves), AdamW moments and the step count of one
    training run; ``step(imgs, gt, seed)`` takes one step and returns the
    loss. ``first_grads`` holds the gradients the optimizer took at the
    first step (after clipping). ``rows`` (a fault for the checks' tests)
    keeps only the first rows of every batch."""

    def __init__(self, cfg: dict, params: dict, cast=identity,
                 rows: int | None = None):
        self.cfg, self.cast, self.rows = cfg, cast, rows
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.decay = decayed(cfg["model"])
        self.count = 0
        self.first_grads: dict | None = None

    def step(self, imgs: torch.Tensor, gt: torch.Tensor, seed: int) -> float:
        cfg = self.cfg
        if self.rows is not None:
            imgs, gt = imgs[:self.rows], gt[:self.rows]
        gen = torch.Generator(device=imgs.device).manual_seed(
            step_seed(seed, self.count))
        model = PlainGKGNet(cfg["model"], self.params, cast=self.cast)
        logits = model.forward(imgs, train=True, generator=gen)
        loss = dual_loss(logits, gt, cfg["model"]["head"])
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        del model, logits
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(g.double()) for g in grads])).float()
            clip = cfg["optimizer"].get("grad_clip_norm")
            scale = torch.where(norm < clip, 1.0, clip / norm) \
                if clip is not None else torch.ones(())
            grads = [g * scale for g in grads]
            if self.first_grads is None:
                self.first_grads = dict(zip(names, grads))
            opt = cfg["optimizer"]
            b1, b2 = opt["betas"]
            lr = learning_rate(cfg, self.count)
            self.count += 1
            for k, g in zip(names, grads):
                p, mu, nu = self.params[k], self.mu[k], self.nu[k]
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
                u = (mu / (1.0 - b1 ** self.count)) / (
                    torch.sqrt(nu / (1.0 - b2 ** self.count)) + opt["eps"])
                if self.decay[k]:
                    u = u + opt["weight_decay"] * p
                p.sub_(lr * u)
        return float(loss.detach())
