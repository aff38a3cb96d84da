"""The environment fingerprint the train CLI logs at start (counterpart:
``collect_env`` of ``gkgnet_tpu/utils/env.py``; the reference logs mmcv's
collect_env, tools/train.py:146-151)."""

from __future__ import annotations

import os
import platform
import subprocess
import sys


def _run(cmd: list[str], cwd: str | None = None) -> str | None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=10, cwd=cwd)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def collect_env() -> dict:
    """Versions, the card (name, count, and nvidia-smi's name and power
    limit) and the git revision."""
    import numpy
    import PIL
    import torch

    info = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "hostname": platform.node(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "absent",
        "numpy": numpy.__version__,
        "PIL": PIL.__version__,
        "cuda_available": torch.cuda.is_available(),
    }
    if torch.cuda.is_available():
        info["device_count"] = torch.cuda.device_count()
        info["device_name"] = torch.cuda.get_device_name(0)
    info["nvidia_smi"] = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"]) or "absent"
    sha = _run(["git", "rev-parse", "--short", "HEAD"],
               cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__)))))
    if sha:
        info["git"] = sha
    return info
