"""Exported-model inference wrappers (counterpart:
``gkgnet_tpu/core/export.py``; the reference's ONNXRuntimeClassifier).

The port's deployment format is a ``torch.export`` program saved with
``torch.export.save`` (``.pt2``), the counterpart of the JAX package's
StableHLO artifact: ``tools/deployment/export.py`` writes it, holding the
eval forward with its sigmoid at a fixed input shape. Its graph calls the
kNN kernels as the registered operators ``torch.ops.gkgnet_tpu_torch.*``,
which dispatch by device when the program runs: the CUDA kernels on the
card, the plain versions on the CPU.

``ExportedProgramClassifier`` runs such an artifact with the same
``__call__(imgs) -> (B, C) scores`` contract as the eager forward, so an
artifact goes through the same evaluation harness
(``tools/deployment/test.py``). It runs on the device the artifact was
exported for and raises when asked for another: an artifact is never moved
in silence.

The JAX package's second backend, a TF SavedModel through jax2tf, has no
counterpart: there is no TensorFlow beside PyTorch in the port's runtime,
and no converter from a torch program to one. ``backend='savedmodel'``
raises ``NotImplementedError`` saying so.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# the operators an artifact's graph calls must be registered before the load
from gkgnet_tpu_torch.ops import knn, knn_mr  # noqa: F401

SAVEDMODEL_REASON = (
    "the 'savedmodel' backend (a TF SavedModel through jax2tf) has no "
    "counterpart in the PyTorch port: its runtime holds no TensorFlow and "
    "no converter from a torch.export program; export with --format pt2")


def _artifact_input(program: torch.export.ExportedProgram
                    ) -> tuple[tuple[int, ...], torch.device]:
    """The shape and device of an exported program's one user input."""
    names = program.graph_signature.user_inputs
    if len(names) != 1:
        raise ValueError(f"an artifact takes one input (the images), this "
                         f"one takes {len(names)}")
    node = next(n for n in program.graph.nodes
                if n.op == "placeholder" and n.name == names[0])
    val = node.meta["val"]
    return tuple(int(s) for s in val.shape), val.device


class ExportedProgramClassifier:
    """Run a saved ``torch.export`` artifact (fixed input shape)."""

    def __init__(self, path: str,
                 device: str | torch.device | None = None):
        self.program = torch.export.load(path)
        self.input_shape, self.device = _artifact_input(self.program)
        if device is not None and torch.device(device).type \
                != self.device.type:
            raise ValueError(
                f"{path} was exported for {self.device.type}, asked to run "
                f"on {torch.device(device).type}: export it again on that "
                f"device")
        self.batch = self.input_shape[0]
        self._module = self.program.module()

    @torch.no_grad()
    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """NHWC fp32 images of the artifact's shape, on its device -> sigmoid
        scores there (a caller that normalizes on the device keeps the
        batch there)."""
        if tuple(imgs.shape) != self.input_shape:
            raise ValueError(f"input {tuple(imgs.shape)}, the artifact takes "
                             f"{self.input_shape}")
        if imgs.device.type != self.device.type:
            raise ValueError(f"input on {imgs.device.type}, the artifact was "
                             f"exported for {self.device.type}")
        return self._module(imgs)

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """``forward`` on host arrays: NHWC fp32 images -> scores."""
        x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32))
        return self.forward(x.to(self.device)).cpu().numpy()


def load_exported_classifier(path: str, backend: str = "auto",
                             device: str | torch.device | None = None):
    """The wrapper for an artifact: ``backend`` 'pt2' (a file; 'auto' takes
    a file as one) or 'savedmodel' (a directory; no counterpart here, it
    raises ``NotImplementedError``)."""
    if backend == "auto":
        backend = "savedmodel" if os.path.isdir(path) else "pt2"
    if backend == "pt2":
        return ExportedProgramClassifier(path, device)
    if backend == "savedmodel":
        raise NotImplementedError(SAVEDMODEL_REASON)
    raise ValueError(f"unknown backend {backend!r}")
