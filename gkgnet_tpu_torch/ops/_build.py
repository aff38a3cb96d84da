"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, and load them with ``ctypes``.

Each source under ``gkgnet_tpu_torch/csrc`` becomes ``build/<name>-<hash>.so``
at the repository root, where the hash covers the source, every header it
includes by ``#include "..."`` (recursively) and the flags: a changed source
or header is rebuilt, an unchanged one is loaded as it is. The library
is compiled under a temporary name and renamed into place, so an
interrupted build leaves nothing that a later run would load. No PyTorch
headers are compiled and nothing waits on a lock.

Nothing is built when this module is imported: ``load`` builds on first
use, on the machine with the card. Each first ``load`` of a name in a
process is timed in the set-up table's ``setup.kernels`` row
(``utils/profiling.py``), with its ``builds`` and ``cached`` counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

from gkgnet_tpu_torch.utils import profiling

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}
# name -> the compiler's output, which holds the -Xptxas -v summary ("" when
# the library was already built)
compiler_log: dict[str, str] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's conventional install location."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[str]:
    """``csrc/<name>.cu`` and the headers it includes with quotes, found
    recursively relative to the including file, each once, in the order
    first reached."""
    files: list[str] = []
    todo = [os.path.join(CSRC_DIR, f"{name}.cu")]
    while todo:
        path = os.path.normpath(todo.pop(0))
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            for inc in _LOCAL_INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return files


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _compile(name: str, out: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s: "
                           f"{' '.join(cmd)}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return log


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it first if the
    source changed since the last build."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.timed("setup.kernels"):
            path = _lib_path(name)
            cached = os.path.exists(path)
            compiler_log[name] = "" if cached else _compile(name, path)
            lib = ctypes.CDLL(path)
        profiling.tally("setup.kernels", "cached" if cached else "builds")
        _loaded[name] = lib
    return lib
