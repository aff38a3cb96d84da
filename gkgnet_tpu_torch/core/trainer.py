"""Training core: ``TrainState`` and the train and eval steps (counterpart:
``gkgnet_tpu/core/trainer.py``).

One ``train_step`` is: the optional batch augment (mixup/cutmix of the
images and labels on the device) -> forward in train mode (batch-moment
BatchNorm; DropPath, stochastic dilation and the perturbed graph build
drawn from a generator seeded from ``(seed, step)``, which the augment
draws from first) -> the head's loss -> backward (through the graph-conv
kernels' own backward) -> clip by global norm -> optimizer step at the
schedule's rate -> EMA of the parameters. The compute dtype follows the model: fp32 master parameters,
cast at use; no autocast and no GradScaler.

The optional dynamic loss scaler is the mmcv one the JAX package mirrors:
the loss is multiplied by ``loss_scale`` (initially 2**16) before the
backward and the gradients divided by it after; ``scale_growth_interval``
finite steps in a row double it; a step with a non-finite gradient halves
it (not below 1), zeroes the gradients and skips the update, and the
BatchNorm statistics keep their values from before the step.

The EMA follows MyEMAHook: ``m = min(momentum, (1 + t) / (warmup + t))``
at step t, ``ema = (1 - m) * ema + m * param``, over the parameters only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from gkgnet_tpu_torch.core.optim import Optimizer, global_norm
from gkgnet_tpu_torch.nn.classifier import parse_losses
from gkgnet_tpu_torch.nn.layers import BatchNorm


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    ema_params: dict[str, torch.Tensor] | None = None
    loss_scale: float | None = None   # dynamic loss scaling only
    good_steps: int | None = None


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       ema: bool = False, dynamic_loss_scale: bool = False,
                       init_scale: float = 2.0 ** 16) -> TrainState:
    """The state of a model whose parameters are already initialized."""
    ema_params = ({name: p.detach().clone()
                   for name, p in model.named_parameters()} if ema else None)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params=ema_params,
                      loss_scale=init_scale if dynamic_loss_scale else None,
                      good_steps=0 if dynamic_loss_scale else None)


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The generator of one step's random draws, seeded from (seed, step)."""
    word = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(word[0]))


def _bn_stats(model: nn.Module) -> list[torch.Tensor]:
    return [t for mod in model.modules() if isinstance(mod, BatchNorm)
            for t in (mod.running_mean, mod.running_var)]


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor], model: nn.Module,
               step: int, momentum: float, warmup: int = 100) -> None:
    """``ema = (1 - m) * ema + m * param`` in place, with
    ``m = min(momentum, (1 + step) / (warmup + step))``."""
    t = float(step)
    m = min(momentum, (1.0 + t) / (warmup + t))
    params = dict(model.named_parameters())
    ema = list(ema_params.values())
    torch._foreach_mul_(ema, 1.0 - m)
    torch._foreach_add_(ema, [params[name].detach() for name in ema_params],
                        alpha=m)


def make_train_step(loss_fn: Callable | None = None,
                    ema_momentum: float | None = None, ema_warmup: int = 100,
                    dynamic_loss_scale: bool = False,
                    scale_growth_interval: int = 2000,
                    batch_augment: Callable | None = None):
    """Returns ``train_step(state, batch, seed=0) -> (state, log_vars)``.

    ``batch``: dict with ``img`` (B, H, W, 3) and ``gt_label`` (B, C) on the
    model's device. The state is updated in place and returned. log_vars
    holds 0-d tensors (the head's losses, e.g. ``bce_loss`` and
    ``asy_loss``, ``loss``, ``grad_norm``, and ``loss_scale`` with dynamic
    scaling) and ``lr`` as a float. ``loss_fn`` defaults to the model's
    head loss. ``batch_augment``: ``(imgs, labels, generator) -> (imgs,
    labels)``, ``nn.augment.build_batch_augment``'s, applied before the
    forward.
    """

    def train_step(state: TrainState, batch: dict, seed: int = 0):
        model = state.model
        params = list(model.parameters())
        device = params[0].device
        model.train()
        if dynamic_loss_scale:
            stats = [t.clone() for t in _bn_stats(model)]
        state.optimizer.optimizer.zero_grad(set_to_none=True)
        gen = step_generator(seed, state.step, device)
        imgs, gt = batch["img"], batch["gt_label"]
        if batch_augment is not None:
            imgs, gt = batch_augment(imgs, gt, gen)
        cls_score, _ = model(imgs, generator=gen)
        head_loss = loss_fn or model.build_loss_head().loss
        total, log_vars = parse_losses(head_loss(cls_score, gt))
        if dynamic_loss_scale:
            (total * state.loss_scale).backward()
        else:
            total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]

        finite = True
        if dynamic_loss_scale:
            torch._foreach_div_(grads, state.loss_scale)
            finite = bool(torch.isfinite(torch.stack(
                torch._foreach_norm(grads, float("inf")))).all())
        if finite:
            grad_norm = state.optimizer.update(state.step)
        else:
            # mmcv LossScaler: drop the step, keep the statistics
            torch._foreach_zero_(grads)
            grad_norm = global_norm(grads)
            with torch.no_grad():
                for t, old in zip(_bn_stats(model), stats):
                    t.copy_(old)

        if state.ema_params is not None and ema_momentum is not None:
            ema_update(state.ema_params, model, state.step, ema_momentum,
                       ema_warmup)

        log_vars = {k: v.detach() for k, v in log_vars.items()}
        log_vars["grad_norm"] = grad_norm
        log_vars["lr"] = state.optimizer.lr(state.step)
        if dynamic_loss_scale:
            grown = finite and state.good_steps + 1 >= scale_growth_interval
            if not finite:
                state.loss_scale = max(state.loss_scale * 0.5, 1.0)
            elif grown:
                state.loss_scale *= 2.0
            state.good_steps = state.good_steps + 1 \
                if finite and not grown else 0
            log_vars["loss_scale"] = state.loss_scale
        state.step += 1
        return state, log_vars

    return train_step


def pipeline_device_norm(pipeline_cfg) -> tuple | None:
    """``(mean, std)`` if the pipeline's Normalize defers to the card
    (``device=True``), else None: the batch then crosses to the card as
    uint8 and ``make_device_normalize`` normalizes it there."""
    for t in pipeline_cfg or ():
        if isinstance(t, dict) and t.get("type") == "Normalize" \
                and t.get("device", False):
            return tuple(t["mean"]), tuple(t["std"])
    return None


def make_device_normalize(norm: tuple | None):
    """``(x - mean) * (1 / std)`` in fp32 on the batch's device for uint8
    (B, H, W, 3) batches; float batches pass through. ``norm`` is
    ``(mean, std)``, or None for the identity. The reciprocal (fp32) is
    what the JAX package computes: XLA turns its ``/ std`` by a constant
    into that product, and its host ``Normalize`` does the same, so both
    paths give the same bits."""
    if norm is None:
        return lambda img: img
    mean, std = norm

    def dev_norm(img: torch.Tensor) -> torch.Tensor:
        if img.dtype != torch.uint8:
            return img
        m = torch.tensor(mean, dtype=torch.float32, device=img.device)
        inv = 1.0 / torch.tensor(std, dtype=torch.float32, device=img.device)
        return (img.float() - m) * inv

    return dev_norm


def make_eval_step(use_ema: bool = False):
    """Returns ``eval_step(state, imgs) -> sigmoid scores (B, n_classes)``
    in fp32, from the EMA parameters when asked for and kept, with the
    current BatchNorm statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            if use_ema and state.ema_params is not None:
                cls_score, _ = torch.func.functional_call(
                    model, state.ema_params, (imgs,))
            else:
                cls_score, _ = model(imgs)
        finally:
            model.train(was_training)
        return torch.sigmoid(cls_score.float())

    return eval_step
