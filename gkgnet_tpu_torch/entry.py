"""Entry points of the port (counterpart: ``__graft_entry__.entry``).

``entry()`` builds the main path's model, GKGNet-S at 576x576 with 80
classes in bf16, from a seeded init, and a seeded standard-normal NHWC
input (never zeros: an all-zeros image makes every kNN distance tie).
``predict(model, images)`` answers one request: sigmoid scores.

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

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
