"""Entry points of the port (counterparts: ``__graft_entry__.entry`` and
``bench.py``'s ``bench_train``).

``entry()`` builds the main path's model, GKGNet-S at 576x576 with 80
classes in bf16, from a seeded init, and a seeded standard-normal NHWC
input (never zeros: an all-zeros image makes every kNN distance tie).
``predict(model, images)`` answers one request: sigmoid scores.
``train_entry()`` builds the training step of the same model.

All run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from gkgnet_tpu_torch.core.optim import build_optimizer
from gkgnet_tpu_torch.core.schedules import step_lr_with_warmup
from gkgnet_tpu_torch.core.trainer import create_train_state, make_train_step
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters

SIZE = 576
N_CLASSES = 80


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or implied) and there is no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                           "the CPU")
    return device


def entry(device: str | torch.device | None = None, batch: int = 1,
          dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """Returns ``(fn, (model, x))`` where ``fn(model, x)`` is the eval
    forward giving the logits ``(batch, 80)``."""
    device = resolve_device(device)
    model = GKGNetClassifier(arch="s", n_classes=N_CLASSES, size=SIZE,
                             dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    x = torch.randn((batch, SIZE, SIZE, 3),
                    generator=torch.Generator().manual_seed(seed))
    x = x.to(device=device, dtype=dtype)

    @torch.no_grad()
    def fn(model: GKGNetClassifier, x: torch.Tensor) -> torch.Tensor:
        return model(x)[0]

    return fn, (model, x)


@torch.no_grad()
def predict(model: GKGNetClassifier, images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> sigmoid scores ``(B, n_classes)`` on the model's
    device."""
    device = next(model.parameters()).device
    logits, _ = model(images.to(device))
    return model.predict(logits)


def train_entry(device: str | torch.device | None = None, batch: int = 8,
                dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """Returns ``(fn, (state, batch))`` where ``fn(state, batch)`` takes one
    training step and returns ``(state, log_vars)``: GKGNet-S@576 with
    drop_path 0.1, AdamW (lr 1e-4 stepped at epochs 10 and 50 of 1000
    steps, 5000 warmup steps, wd 0.05, clip 5) and an EMA of momentum 2e-4;
    seeded standard-normal images and multi-hot labels (each class on with
    probability 0.05), as ``bench.py``'s ``bench_train`` makes them."""
    device = resolve_device(device)
    model = GKGNetClassifier(arch="s", n_classes=N_CLASSES, size=SIZE,
                             drop_path=0.1, dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.standard_normal((batch, SIZE, SIZE, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.random((batch, N_CLASSES)) < 0.05)
    data = {"img": images.to(device=device, dtype=dtype),
            "gt_label": labels.to(device=device, dtype=torch.float32)}
    schedule = step_lr_with_warmup(1e-4, 1000, [10, 50], warmup_iters=5000)
    state = create_train_state(model, build_optimizer(model, schedule),
                               ema=True)
    step = make_train_step(ema_momentum=2e-4)

    def fn(state, batch):
        return step(state, batch, seed)

    return fn, (state, data)
