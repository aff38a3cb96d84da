"""gkgnet_tpu_torch — the PyTorch/CUDA port of ``gkgnet_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside it is the reference; this package imports neither it
nor JAX. Layout conventions are the JAX package's:
  * images / feature maps:  NHWC
  * node sets:              (B, N, C) channel-last
  * edge indices:           (B, N, k) int32 neighbour ids

Hand-written kernels live in ``csrc/`` and are built with ``nvcc`` on first
use (``ops/_build.py``). Entry points (``entry.py``) run on the card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
