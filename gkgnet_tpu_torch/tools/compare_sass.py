"""Compare the SASS of two versions of a CUDA source, kernel by kernel.

    python -m gkgnet_tpu_torch.tools.compare_sass OTHER_CSRC [NAME ...]
        [--fp32]

builds ``csrc/<NAME>.cu`` of this checkout and of the directory
``OTHER_CSRC`` (another checkout's ``gkgnet_tpu_torch/csrc``) for sm_90a
with the flags of ``ops/_build.py``, dumps both with ``cuobjdump -sass``
and, for every kernel of the other build, prints whether this build has a
kernel of the same name (namespaces, parameter lists and trailing ``false``
or ``0`` template arguments left out: the default instantiation of a kernel
that gained compile-time flags, such as knn_mr_kernel's grouped flag and
its phase) and the same instructions, addresses and encodings aside. Exits 1 if any differs. NAME defaults to ``knn_mr``.

``--fp32`` compares only the CUDA-core kernels: every fp32 instantiation
of knn_mr_kernel and knn_topk_kernel (``knn_mr_kernel<float, ...>`` before
their redesign on ``csrc/knn_scan_f32.cuh``, ``knn_mr_kernel<KDM, ...>``
after it, which take fp32 only), and l2norm_rows and row_sq in both types
(names as printed, matched by ``FP32_ONLY``); it counts the rest as
skipped, so the exit code says whether the kernels that were meant to stay
did. Without it, against a checkout from before that redesign, the fp32
kernels read ``missing`` (their names lost the type) and every other
kernel must read ``same``.

Needs ``nvcc``, ``cuobjdump`` and ``cu++filt`` from the CUDA toolkit, not a
card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

from gkgnet_tpu_torch.ops import _build

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
FP32_ONLY = (r"^(knn_mr_kernel<(float|\d)|knn_topk_kernel<(float|\d)|"
             r"l2norm_rows<|row_sq<)")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(_build.find_nvcc()), name)


def _key(mangled: str) -> str:
    """``name<template arguments>`` of a kernel, namespaces left out and
    trailing false or 0 arguments dropped."""
    name = subprocess.run([_tool("cu++filt"), mangled], capture_output=True,
                          text=True, check=True).stdout.strip()
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|"
                  r"knn_select::", "", name)
    depth = 0
    for i, ch in enumerate(name):  # cut after the template argument list
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == ">" and depth == 0:
            name = name[:i + 1]
            break
    trailing = re.compile(r", (?:\(bool\)0|false|\(int\)0|0)>$")
    while trailing.search(name):
        name = trailing.sub(">", name)
    return name


def sass(src: str, out: str) -> dict[str, list[str]]:
    """Kernel name -> its instructions, for one source file compiled to the
    cubin ``out``."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-cubin", "-o", out, src],
                   check=True, capture_output=True, text=True)
    dump = subprocess.run([_tool("cuobjdump"), "-sass", out], check=True,
                          capture_output=True, text=True).stdout
    kernels: dict[str, list[str]] = {}
    current = None
    for line in dump.splitlines():
        fn = _FUNCTION.match(line)
        if fn:
            current = kernels.setdefault(_key(fn.group(1)), [])
            continue
        ins = _INSTRUCTION.search(line)
        if ins and current is not None:
            current.append(ins.group(1))
    return kernels


def main(argv: list[str]) -> int:
    only = re.compile(FP32_ONLY) if "--fp32" in argv else None
    argv = [a for a in argv if a != "--fp32"]
    if not argv:
        raise SystemExit(__doc__)
    other, names = argv[0], argv[1:] or ["knn_mr"]
    differ = skipped = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            mine = sass(os.path.join(_build.CSRC_DIR, f"{name}.cu"),
                        os.path.join(tmp, f"mine_{name}.cubin"))
            theirs = sass(os.path.join(other, f"{name}.cu"),
                          os.path.join(tmp, f"other_{name}.cubin"))
            for kernel, ins in sorted(theirs.items()):
                if only is not None and not only.search(kernel):
                    skipped += 1
                    continue
                got = mine.get(kernel)
                same = got == ins
                differ += not same
                print(f"sass {name}.cu {kernel}: "
                      + ("same" if same else "missing" if got is None else
                         f"differs ({len(got)} vs {len(ins)} instructions)"),
                      flush=True)
    if only is not None:
        print(f"sass: {skipped} kernels skipped (--fp32)", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
