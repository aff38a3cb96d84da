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
it (not below 1) and keeps the parameters, the optimizer state (its step
counts too) and the BatchNorm statistics from before the step.

Every decision of the step stays on the device, as in the JAX package's
jitted step: the finite check, the skip (``torch.where`` selects over the
state, as JAX ``trainer.py:155-167``) and the scale's growth and back-off
are tensor operations on 0-d ``loss_scale``/``good_steps`` tensors; the
host writes the schedule's rate and the EMA's rate into device scalars
and re-seeds the step's generator before the step, and reads nothing back.
The gradients are allocated once and zeroed in place. So the step can be
captured as a CUDA graph (``core.graphs``): ``make_train_step`` and
``make_eval_step`` are the counterparts of the JAX package's ``jax.jit``,
and on the CPU the same code runs eagerly.

Under ``parallel.sharding.graph_sharding`` over a world of more than one
rank, each rank's step runs on its own rows of the global batch (the
per-sample draws are taken for the global batch, each rank keeping its
rows, and BatchNorm reduces its moments over the data group). After the
backward every rank of a graph group holds the same gradients (the graph
convs' boundary operators sum or gather their parts over the group, and
the layers around them run on the same inputs with cuDNN's deterministic
algorithms: its default fp32 convolution backward sums in an order that
changes from run to run on an H100), so the gradients are averaged over
the data group only, one all-reduce where the data axis is above 1, and
the ranks' parameters stay alike. The logged losses are averaged over the
data group.
Clipping, the optimizer, the loss scaler's finite check and the EMA then
see the same values on every rank. Batch augments mix rows within a rank's
own shard.

The EMA follows MyEMAHook: ``m = min(momentum, (1 + t) / (warmup + t))``
at step t, ``ema = (1 - m) * ema + m * param``, over the parameters only.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from gkgnet_tpu_torch.core.graphs import (ModelTensors, StepGraphs,
                                          capturable)
from gkgnet_tpu_torch.core.optim import Optimizer
from gkgnet_tpu_torch.nn.classifier import parse_losses
from gkgnet_tpu_torch.nn.grapher import _grouped_enabled
from gkgnet_tpu_torch.nn.layers import BatchNorm
from gkgnet_tpu_torch.parallel import collectives
from gkgnet_tpu_torch.parallel.sharding import active_graph_cfg
from gkgnet_tpu_torch.utils import profiling


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    ema_params: dict[str, torch.Tensor] | None = None
    # dynamic loss scaling only: 0-d fp32 and int32 tensors on the model's
    # device, which the step updates in place
    loss_scale: torch.Tensor | None = None
    good_steps: torch.Tensor | None = None


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       ema: bool = False, dynamic_loss_scale: bool = False,
                       init_scale: float = 2.0 ** 16) -> TrainState:
    """The state of a model whose parameters are already initialized (and
    on their device)."""
    ema_params = ({name: p.detach().clone()
                   for name, p in model.named_parameters()} if ema else None)
    device = next(model.parameters()).device
    scale = good = None
    if dynamic_loss_scale:
        scale = torch.tensor(init_scale, dtype=torch.float32, device=device)
        good = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params=ema_params, loss_scale=scale,
                      good_steps=good)


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's random draws: a word of the
    ``SeedSequence([seed, step])``."""
    word = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(word[0])


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """A new generator of one step's random draws, seeded from (seed,
    step). The train step re-seeds one generator per device with
    ``step_seed`` instead, which gives the same draws."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _bn_stats(model: nn.Module) -> list[torch.Tensor]:
    return [t for mod in model.modules() if isinstance(mod, BatchNorm)
            for t in (mod.running_mean, mod.running_var)]


def ema_rate(step: int, momentum: float, warmup: int = 100) -> float:
    """``m = min(momentum, (1 + step) / (warmup + step))``."""
    t = float(step)
    return min(momentum, (1.0 + t) / (warmup + t))


@torch.no_grad()
def ema_apply(ema_params: dict[str, torch.Tensor], model: nn.Module,
              m: torch.Tensor) -> None:
    """``ema = (1 - m) * ema + m * param`` in place; ``m`` a 0-d tensor on
    the parameters' device, read there."""
    params = dict(model.named_parameters())
    ema = list(ema_params.values())
    torch._foreach_mul_(ema, 1.0 - m)
    torch._foreach_add_(ema, torch._foreach_mul(
        [params[name].detach() for name in ema_params], m))


def ema_update(ema_params: dict[str, torch.Tensor], model: nn.Module,
               step: int, momentum: float, warmup: int = 100) -> None:
    """``ema_apply`` at ``ema_rate(step, momentum, warmup)``."""
    device = next(iter(ema_params.values())).device
    ema_apply(ema_params, model, torch.tensor(
        ema_rate(step, momentum, warmup), dtype=torch.float32,
        device=device))


@contextlib.contextmanager
def _deterministic_convs(on: bool):
    """cuDNN's deterministic algorithms inside the block when ``on``."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = before or on
    try:
        yield
    finally:
        cudnn.deterministic = before


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """What a train step reads and writes in place: parameters, gradients,
    buffers, optimizer state and rate, EMA and loss scaler."""
    model = state.model
    out = list(model.parameters()) + [p.grad for p in model.parameters()]
    out += list(model.buffers()) + state.optimizer.optimizer.state_tensors()
    out.append(state.optimizer.optimizer.lr)
    if state.ema_params is not None:
        out += list(state.ema_params.values())
    if state.loss_scale is not None:
        out += [state.loss_scale, state.good_steps]
    return out


def make_train_step(loss_fn: Callable | None = None,
                    ema_momentum: float | None = None, ema_warmup: int = 100,
                    dynamic_loss_scale: bool = False,
                    scale_growth_interval: int = 2000,
                    batch_augment: Callable | None = None,
                    compiled: bool | None = None):
    """Returns ``train_step(state, batch, seed=0) -> (state, log_vars)``.

    ``batch``: dict with ``img`` (B, H, W, 3) and ``gt_label`` (B, C) on the
    model's device. The state is updated in place and returned. log_vars
    holds 0-d tensors (the head's losses, e.g. ``bce_loss`` and
    ``asy_loss``, ``loss``, ``grad_norm``, and ``loss_scale`` with dynamic
    scaling) and ``lr`` as a float. ``loss_fn`` defaults to the model's
    head loss. ``batch_augment``: ``nn.augment.build_batch_augment``'s,
    applied before the forward.

    ``compiled`` (``core.graphs.capturable``): None captures the step as a
    CUDA graph per input signature for a CUDA model in a world of one
    rank (the first call of a signature runs eagerly, the second captures)
    and runs it eagerly otherwise; False runs it eagerly; True raises
    where it cannot capture. Both run the same code: the host writes the
    schedule's rate, the EMA's rate and the generator's seed before the
    step, and the step itself reads no value back. With several batch
    augments, which one runs is drawn first and read on the host, and
    each gets its graph; so does each ``GKGNET_GROUPED`` route, which the
    model reads at every call. Steps under ``graph_sharding`` over more
    than one rank stay eager.
    """
    graphs = StepGraphs()
    generators: dict[torch.device, torch.Generator] = {}
    ema_rates: dict[torch.device, torch.Tensor] = {}

    def body(state: TrainState, gen: torch.Generator, pick: int,
             m: torch.Tensor | None, imgs: torch.Tensor,
             gt: torch.Tensor) -> dict:
        """The step on the device; reads no value on the host."""
        model = state.model
        params = list(model.parameters())
        grads = [p.grad for p in params]
        torch._foreach_zero_(grads)
        if dynamic_loss_scale:
            kept = params + state.optimizer.optimizer.state_tensors() \
                + _bn_stats(model)
            before = [t.clone() for t in kept]
        if batch_augment is not None:
            imgs, gt = batch_augment.fns[pick](imgs, gt, gen)
        cfg = active_graph_cfg()
        with _deterministic_convs(cfg is not None and cfg.mesh.graph > 1):
            with profiling.span("forward"):
                cls_score, _ = model(imgs, generator=gen)
            with profiling.span("loss"):
                head_loss = loss_fn or model.build_loss_head().loss
                total, log_vars = parse_losses(head_loss(cls_score, gt))
            with profiling.span("backward"):
                if dynamic_loss_scale:
                    (total * state.loss_scale).backward()
                else:
                    total.backward()
        if cfg is not None and cfg.mesh.data > 1:
            collectives.reduce_mean_(grads, cfg.mesh.data_group,
                                     cfg.mesh.data)
        # the scaler's span holds the optimizer's: one span of markers
        with (profiling.span("loss_scale") if dynamic_loss_scale
              else contextlib.nullcontext()):
            if dynamic_loss_scale:
                torch._foreach_div_(grads, state.loss_scale)
                finite = torch.isfinite(torch.stack(
                    torch._foreach_norm(grads, float("inf")))).all()
                # non-finite: zero the gradients so the update stays
                # finite, then keep the state from before the step (mmcv
                # LossScaler)
                for g in grads:
                    g.masked_fill_(~finite, 0.0)
            with profiling.span("optimizer"):
                grad_norm = state.optimizer.apply()
            if dynamic_loss_scale:
                with torch.no_grad():
                    for t, old in zip(kept, before):
                        torch.where(finite, t, old, out=t)
                    scale, good = state.loss_scale, state.good_steps
                    grown = finite & (good + 1 >= scale_growth_interval)
                    scale.copy_(torch.where(
                        finite, torch.where(grown, scale * 2.0, scale),
                        torch.clamp(scale * 0.5, min=1.0)))
                    good.copy_(torch.where(finite & ~grown, good + 1, 0))

        if m is not None:
            with profiling.span("ema"):
                ema_apply(state.ema_params, model, m)

        log_vars = {k: v.detach() for k, v in log_vars.items()}
        if cfg is not None and cfg.mesh.data > 1:
            log_vars = {k: v.clone() for k, v in log_vars.items()}
            collectives.reduce_mean_(list(log_vars.values()),
                                     cfg.mesh.data_group, cfg.mesh.data)
        log_vars["grad_norm"] = grad_norm
        if dynamic_loss_scale:
            log_vars["loss_scale"] = state.loss_scale.clone()
        return log_vars

    def train_step(state: TrainState, batch: dict, seed: int = 0):
        with profiling.host_span("train_step"):
            with profiling.host_span("train_step.prepare"):
                model = state.model
                params = list(model.parameters())
                device = params[0].device
                model.train()
                for p in params:  # allocated once, zeroed in place
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                # the host's part: the rates and the seed, before the step
                state.optimizer.set_step(state.step)
                m = None
                if state.ema_params is not None \
                        and ema_momentum is not None:
                    if device not in ema_rates:
                        ema_rates[device] = torch.zeros(
                            (), dtype=torch.float32, device=device)
                    m = ema_rates[device].fill_(ema_rate(
                        state.step, ema_momentum, ema_warmup))
                if device not in generators:
                    generators[device] = torch.Generator(device=device)
                gen = generators[device].manual_seed(
                    step_seed(seed, state.step))
                pick = 0 if batch_augment is None \
                    else batch_augment.pick(gen)
                inputs = [batch["img"], batch["gt_label"]]
                compile_it = capturable(compiled, device)
                if compile_it:
                    live = _state_tensors(state) + ([] if m is None
                                                    else [m])
            if compile_it:
                log_vars = graphs(
                    (weakref.ref(model), pick, _grouped_enabled()), inputs,
                    lambda t: body(state, gen, pick, m, *t), live, (gen,))
            else:
                log_vars = body(state, gen, pick, m, *inputs)
            log_vars["lr"] = state.optimizer.lr(state.step)
            state.step += 1
            return state, log_vars

    train_step.graphs = graphs
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
    paths give the same bits. It runs eagerly (two ops), before a compiled
    step copies the batch into its graph's input. ``mean`` and ``1 / std``
    are made on a device at its first batch and kept (``builds`` counts
    them): made anew, each host-to-device copy from pageable memory would
    wait for the card on every batch."""
    if norm is None:
        return lambda img: img
    mean, std = norm
    consts: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def dev_norm(img: torch.Tensor) -> torch.Tensor:
        if img.dtype != torch.uint8:
            return img
        with profiling.host_span("input"):
            if img.device not in consts:
                consts[img.device] = (
                    torch.tensor(mean, dtype=torch.float32, device=img.device),
                    1.0 / torch.tensor(std, dtype=torch.float32,
                                       device=img.device))
                dev_norm.builds += 1
            m, inv = consts[img.device]
            return (img.float() - m) * inv

    dev_norm.builds = 0
    return dev_norm


def scores(model: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """The eval step's output: fp32 sigmoid scores."""
    return torch.sigmoid(logits.float())


def make_eval_step(use_ema: bool = False, compiled: bool | None = None,
                   output: Callable = scores):
    """Returns ``eval_step(state, imgs) -> output(model, logits)``, by
    default the sigmoid scores (B, n_classes) in fp32, from the EMA
    parameters when asked for and kept, with the current BatchNorm
    statistics. ``compiled`` as in ``make_train_step``: on a CUDA model in
    a world of one rank, one CUDA graph per input shape and dtype (and
    model, EMA choice and ``GKGNET_GROUPED`` route), captured at the
    second call of each.

    The forward runs in eval mode and leaves the model in the mode it
    found. A replay runs no forward, so it sets no mode: its graph was
    captured in eval mode. Nor does it walk the model's modules for the
    state the graph reads: ``eval_step.prepared`` (``core.graphs``
    ``ModelTensors``) keeps it, and counts in ``hits`` the replays it
    served unwalked and in ``rebuilds`` its walks."""
    graphs = StepGraphs()
    prepared = ModelTensors()

    def forward(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with profiling.span("forward"):
                if use_ema and state.ema_params is not None:
                    cls_score, _ = torch.func.functional_call(
                        model, state.ema_params, (imgs,))
                else:
                    cls_score, _ = model(imgs)
                return output(model, cls_score)
        finally:
            model.train(was_training)

    @torch.no_grad()
    def eval_step(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
        with profiling.host_span("eval_step"):
            model = state.model
            with profiling.host_span("eval_step.prepare"):
                device = next(model.parameters()).device
                compile_it = capturable(compiled, device)
                if compile_it:
                    ema = use_ema and state.ema_params is not None
                    live, kept = prepared(model)
                    if ema:
                        live += state.ema_params.values()
            if not compile_it:
                return forward(state, imgs)
            found = graphs.find((weakref.ref(model), ema, _grouped_enabled()),
                                [imgs], live)
            if kept and found.cap is not None:
                prepared.hits += 1
            return graphs.run(found, [imgs], lambda t: forward(state, t[0]))

    eval_step.graphs = graphs
    eval_step.prepared = prepared
    return eval_step
