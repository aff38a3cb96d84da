"""Optimizers with the JAX package's weight-decay rule and gradient clipping
(counterpart: ``gkgnet_tpu/core/optim.py``, optax
``chain(clip_by_global_norm, adamw | lamb | sgd)``).

Decay applies to a parameter unless the leaf name of its JAX variable is
``bias``, ``scale`` or ``alpha``. The rule reads the JAX leaf names
(``utils.weights.jax_leaf_names``), not the port's: the JAX package decays
``head/fc1_bias`` (the port's ``head.fc1.bias``), ``pos_embed`` and
``label_lt/embedding``, and exempts every BatchNorm scale and every other
bias.

Clipping is optax's: when the global norm ``n`` of the gradients is not
below ``max_norm``, each gradient becomes ``(g / n) * max_norm``
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to n and is not used). The
learning rate is set from the schedule before each step.

``Lamb`` is ``optax.lamb``, written out because torch has none: Adam's
bias-corrected moments, the decay added to the update where the mask
allows it, the update scaled per parameter by the trust ratio
``|p| / |u|`` (1 where either norm is 0), then ``-lr`` times it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from gkgnet_tpu_torch.utils.weights import jax_leaf_names

NO_DECAY_LEAVES = ("bias", "scale", "alpha")


def no_decay_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> True where weight decay applies."""
    return {name: leaf not in NO_DECAY_LEAVES
            for name, leaf in jax_leaf_names(model).items()}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, summed in fp64 and
    returned in fp32 (the CPU's fp32 norm of a large tensor is off by a few
    1e-6 relative)."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


class Lamb(torch.optim.Optimizer):
    """optax.lamb: ``scale_by_adam`` (eps outside the root, no eps_root),
    ``add_decayed_weights`` (a group's ``weight_decay``),
    ``scale_by_trust_ratio`` and ``-lr``, over each parameter as one
    leaf."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                mu = (1.0 - b1) * g + b1 * state["mu"]
                nu = (1.0 - b2) * (g * g) + b2 * state["nu"]
                state["mu"], state["nu"] = mu, nu
                u = (mu / (1.0 - b1 ** t)) / (
                    torch.sqrt(nu / (1.0 - b2 ** t)) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p_norm = torch.linalg.vector_norm(p)
                u_norm = torch.linalg.vector_norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0,
                                    p_norm / u_norm)
                p.add_(-group["lr"] * (u * ratio))


class Optimizer:
    """A torch optimizer behind optax's clip-by-global-norm, with the
    learning rate taken from a schedule of the step count."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 learning_rate: float | Callable[[int], float],
                 grad_clip_norm: float | None):
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]

    def lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(step))
        return float(self.learning_rate)

    def update(self, step: int) -> torch.Tensor:
        """Clip the parameters' gradients in place and take one step at the
        schedule's rate for ``step`` (the count of earlier updates).
        Returns the global norm of the gradients before clipping."""
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.grad_clip_norm is not None:
            keep = norm < self.grad_clip_norm
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(
                grads, torch.where(keep, 1.0, self.grad_clip_norm).to(norm))
        lr = self.lr(step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return norm


def build_optimizer(model: nn.Module,
                    learning_rate: float | Callable[[int], float],
                    optimizer: str = "adamw", weight_decay: float = 0.05,
                    betas: tuple[float, float] = (0.9, 0.999),
                    eps: float = 1e-8, grad_clip_norm: float | None = 5.0,
                    paramwise_no_decay: bool = True) -> Optimizer:
    """AdamW, LAMB (or SGD with momentum ``betas[0]``) over the model's
    parameters in two groups, decayed and not, with clipping at
    ``grad_clip_norm``."""
    mask = no_decay_mask(model) if paramwise_no_decay else {}
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        (decay if mask.get(name, True) else no_decay).append(p)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    groups = [g for g in groups if g["params"]]
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    if optimizer == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=betas, eps=eps)
    elif optimizer == "lamb":
        opt = Lamb(groups, lr=lr0, betas=betas, eps=eps)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=lr0, momentum=betas[0])
    else:
        raise ValueError(f"unknown optimizer {optimizer}")
    return Optimizer(opt, learning_rate, grad_clip_norm)
