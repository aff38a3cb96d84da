"""Model export for deployment (counterpart: ``tools/deployment/export.py``;
the reference's pytorch2onnx.py).

    python -m gkgnet_tpu_torch.tools.deployment.export CONFIG [CKPT_DIR] \\
        --out model.pt2 [--batch 1] [--verify] [--device cpu]

Exports the eval forward, ``sigmoid(model(imgs).float())`` from fp32 NHWC
images cast to the model's type (the eval step's computation), with
``torch.export.export(..., strict=False)`` at a fixed batch, and writes it
with ``torch.export.save`` (``--format pt2``, the StableHLO artifact's
counterpart). The kNN kernels stay in the graph as the registered operators
``torch.ops.gkgnet_tpu_torch.*``. ``--verify`` loads the written file and
holds its scores on seeded standard-normal images to the eager forward's
(atol 2e-3, rtol 1e-3, the JAX tool's tolerance) and prints the largest
difference. The artifact runs on the device it was exported on: the card
unless ``--device cpu`` is given; raises without a card.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch import nn

from gkgnet_tpu_torch.core.export import SAVEDMODEL_REASON
from gkgnet_tpu_torch.tools.inference import init_model

VERIFY_ATOL, VERIFY_RTOL = 2e-3, 1e-3


class ScoreModel(nn.Module):
    """The exported computation: NHWC fp32 images -> fp32 sigmoid scores."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        cls_score, _ = self.model(imgs.to(self.model.backbone.dtype))
        return torch.sigmoid(cls_score.float())


def export_program(model: nn.Module, batch: int, size: int
                   ) -> torch.export.ExportedProgram:
    """The eval forward of ``model`` (on its device, in eval mode) as an
    exported program taking ``(batch, size, size, 3)`` fp32 images."""
    device = next(model.parameters()).device
    spec = torch.zeros((batch, size, size, 3), dtype=torch.float32,
                       device=device)
    with torch.no_grad():
        return torch.export.export(ScoreModel(model.eval()), (spec,),
                                   strict=False)


def sample_images(batch: int, size: int) -> np.ndarray:
    """The verification input: seeded standard-normal NHWC images."""
    return np.random.default_rng(0).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a GKGNet model")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--format", choices=["pt2", "savedmodel"], default="pt2")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{'out', 'bytes', 'export_s', 'program'}`` and, with
    ``--verify``, ``max_diff``: the largest |artifact - eager| score."""
    args = parse_args(argv)
    if args.format == "savedmodel":
        raise NotImplementedError(SAVEDMODEL_REASON)
    model, cfg = init_model(args.config, args.checkpoint, args.device)
    size = cfg.model["size"]
    t = time.perf_counter()
    program = export_program(model, args.batch, size)
    torch.export.save(program, args.out)
    result = dict(out=args.out, bytes=os.path.getsize(args.out),
                  export_s=time.perf_counter() - t, program=program)
    print(f"wrote torch.export artifact ({result['bytes']} bytes, "
          f"{result['export_s']:.1f} s) -> {args.out}")
    if args.verify:
        device = next(model.parameters()).device
        sample = torch.from_numpy(sample_images(args.batch, size)).to(device)
        reloaded = torch.export.load(args.out).module()
        with torch.no_grad():
            got = reloaded(sample).cpu().numpy()
            want = ScoreModel(model)(sample).cpu().numpy()
        result["max_diff"] = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, atol=VERIFY_ATOL,
                                   rtol=VERIFY_RTOL)
        print(f"verify OK: exported outputs match the eager forward (max "
              f"|diff| {result['max_diff']:.3e})")
    return result


if __name__ == "__main__":
    main()
