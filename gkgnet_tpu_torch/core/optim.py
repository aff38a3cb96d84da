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
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to n and is not used).

``AdamW``, ``Lamb`` and ``SGD`` are optax's transformations written out,
with every decision on the device, so that a train step can be captured
in a CUDA graph (``core.graphs``): the learning rate is a 0-d device
tensor that ``Optimizer.set_step`` writes from the schedule before each
step, the step counts and bias corrections are device tensors, and every
state tensor is updated in place. LAMB is Adam's bias-corrected moments,
the decay added to the update where the mask allows it, the update scaled
per parameter by the trust ratio ``|p| / |u|`` (1 where either norm is 0),
then ``-lr`` times it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from gkgnet_tpu_torch.utils import profiling
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


class _OptaxOptimizer(torch.optim.Optimizer):
    """An optax transformation as a torch optimizer whose every decision
    stays on the device: the learning rate is the 0-d fp32 tensor ``lr``
    (``set_lr`` writes it from the host, outside any CUDA graph), each
    parameter's state (its step count too) is made once by ``init_state``
    and updated in place, and ``step`` reads no tensor's value on the host.
    So a step can be captured in a CUDA graph and replayed, and the eager
    step runs the same code."""

    def __init__(self, params, defaults: dict):
        # capturable: load_state_dict keeps each state tensor, the step
        # count too, on its parameter's device
        super().__init__(params, dict(defaults, capturable=True))
        self.lr: torch.Tensor | None = None

    def _new_state(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def set_lr(self, value: float) -> None:
        device = self.param_groups[0]["params"][0].device
        if self.lr is None or self.lr.device != device:
            self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.lr.fill_(value)

    @torch.no_grad()
    def init_state(self) -> None:
        """The state of every parameter that has none yet."""
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p].update(self._new_state(p, group))

    # the state's names in the saves of this package's earlier optimizers
    # (torch's AdamW and SGD; its Lamb kept mu and nu, and a host int step)
    _EARLIER_NAMES = {"exp_avg": "mu", "exp_avg_sq": "nu",
                      "momentum_buffer": "trace"}

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's, also for a save of this package's earlier optimizers:
        their state renamed (``_EARLIER_NAMES``), an empty momentum buffer
        dropped, the step count made an fp32 tensor, and every group
        capturable, so that each state tensor lands on its parameter's
        device."""
        state = {}
        for key, st in state_dict["state"].items():
            st = {self._EARLIER_NAMES.get(name, name): v
                  for name, v in st.items() if v is not None}
            if "step" in st:
                st["step"] = torch.as_tensor(st["step"], dtype=torch.float32)
            state[key] = st
        groups = [dict(g, capturable=True)
                  for g in state_dict["param_groups"]]
        super().load_state_dict(dict(state_dict, state=state,
                                     param_groups=groups))

    def state_tensors(self) -> list[torch.Tensor]:
        self.init_state()
        return [v for group in self.param_groups for p in group["params"]
                for v in self.state[p].values()]

    def _group(self, group: dict, *keys: str):
        params = [p for p in group["params"] if p.grad is not None]
        return (params, [p.grad for p in params],
                *([self.state[p][k] for p in params] for k in keys))


class AdamW(_OptaxOptimizer):
    """optax.adamw: ``scale_by_adam`` (eps outside the root, no eps_root),
    ``add_decayed_weights`` (a group's ``weight_decay``) and ``-lr``, each
    parameter's moments ``mu``/``nu`` and fp32 step count on its device."""

    def __init__(self, params, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def _new_state(self, p, group):
        return {"step": torch.zeros((), dtype=torch.float32,
                                    device=p.device),
                "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _updates(self, group: dict) -> tuple[list, list]:
        """``(params, u)``: Adam's bias-corrected direction plus the decay,
        before the learning rate."""
        b1, b2 = group["betas"]
        params, grads, steps, mus, nus = self._group(group, "step", "mu",
                                                     "nu")
        torch._foreach_add_(steps, 1.0)
        # optax's update_moment: (1 - b) * g + b * t
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(grads, grads),
                            alpha=1.0 - b2)
        bc1 = torch._foreach_pow(b1, steps)    # 1 - b ** t, on the device
        torch._foreach_neg_(bc1)
        torch._foreach_add_(bc1, 1.0)
        bc2 = torch._foreach_pow(b2, steps)
        torch._foreach_neg_(bc2)
        torch._foreach_add_(bc2, 1.0)
        u = torch._foreach_div(mus, bc1)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(u, denom)
        if group["weight_decay"]:
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
        return params, u

    def _scale(self, params: list, u: list) -> list:
        return u

    @torch.no_grad()
    def step(self, closure=None):
        self.init_state()
        for group in self.param_groups:
            params, u = self._updates(group)
            if params:
                u = self._scale(params, u)
                torch._foreach_mul_(u, self.lr)
                torch._foreach_sub_(params, u)


class Lamb(AdamW):
    """optax.lamb: AdamW's direction (``scale_by_adam`` and
    ``add_decayed_weights``), scaled per parameter by the trust ratio
    ``|p| / |u|`` (1 where either norm is 0), then ``-lr``."""

    def __init__(self, params, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, betas=betas, eps=eps,
                         weight_decay=weight_decay)

    def _scale(self, params, u):
        p_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(u))
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0,
                            p_norm / u_norm)
        torch._foreach_mul_(u, list(ratio.unbind()))
        return u


class SGD(_OptaxOptimizer):
    """optax's ``add_decayed_weights`` (a group's ``weight_decay``) then
    ``sgd`` with momentum: ``t = g + momentum * t``, ``-lr * t``; no
    state without momentum."""

    def __init__(self, params, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(momentum=momentum,
                                      weight_decay=weight_decay))

    def _new_state(self, p, group):
        return {"trace": torch.zeros_like(p)} if group["momentum"] else {}

    @torch.no_grad()
    def step(self, closure=None):
        self.init_state()
        for group in self.param_groups:
            params, grads = self._group(group)
            if not params:
                continue
            d = grads
            if group["weight_decay"]:
                d = torch._foreach_add(grads, params,
                                       alpha=group["weight_decay"])
            if group["momentum"]:
                traces = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(traces, group["momentum"])
                torch._foreach_add_(traces, d)
                d = traces
            torch._foreach_sub_(params, torch._foreach_mul(d, self.lr))


class Optimizer:
    """An optimizer of this module behind optax's clip-by-global-norm, with
    the learning rate taken from a schedule of the step count."""

    def __init__(self, optimizer: _OptaxOptimizer,
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

    def set_step(self, step: int) -> None:
        """Write the schedule's rate for ``step`` (the count of earlier
        updates) into the optimizer's device scalar: on the host, before
        the step and outside any CUDA graph."""
        self.optimizer.set_lr(self.lr(step))

    def apply(self) -> torch.Tensor:
        """Clip the parameters' gradients in place and take one step at
        the rate ``set_step`` wrote. Returns the global norm of the
        gradients before clipping. Reads no value on the host."""
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.grad_clip_norm is not None:
            keep = norm < self.grad_clip_norm
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(
                grads, torch.where(keep, 1.0, self.grad_clip_norm).to(norm))
        self.optimizer.step()
        return norm

    def update(self, step: int) -> torch.Tensor:
        """``set_step(step)`` then ``apply()``."""
        self.set_step(step)
        return self.apply()


@profiling.timed("setup.optimizer")
def build_optimizer(model: nn.Module,
                    learning_rate: float | Callable[[int], float],
                    optimizer: str = "adamw", weight_decay: float = 0.05,
                    betas: tuple[float, float] = (0.9, 0.999),
                    eps: float = 1e-8, grad_clip_norm: float | None = 5.0,
                    paramwise_no_decay: bool = True) -> Optimizer:
    """AdamW, LAMB (or SGD with momentum ``betas[0]``) over the model's
    parameters in two groups, decayed and not, with clipping at
    ``grad_clip_norm``. Timed in the set-up table's ``setup.optimizer``
    row (``utils/profiling.py``)."""
    mask = no_decay_mask(model) if paramwise_no_decay else {}
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        (decay if mask.get(name, True) else no_decay).append(p)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    groups = [g for g in groups if g["params"]]
    if optimizer == "adamw":
        opt = AdamW(groups, betas=betas, eps=eps)
    elif optimizer == "lamb":
        opt = Lamb(groups, betas=betas, eps=eps)
    elif optimizer == "sgd":
        opt = SGD(groups, momentum=betas[0])
    else:
        raise ValueError(f"unknown optimizer {optimizer}")
    return Optimizer(opt, learning_rate, grad_clip_norm)
