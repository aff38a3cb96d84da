"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), and when the process holds a module of JAX
or of the JAX package once the window has closed. With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and traced seconds and the
breakdown. The comparison with the plain reference decides ``correct``;
its numbers and limits come last, on standard error and under ``checks``.
The harness's spans and the readings go to ``benchmark/out/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.workload(spec, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: the benchmark runs the "
              f"port without JAX", file=sys.stderr)
        return 3
    harness.report(result, os.path.join(ROOT, "benchmark", "out"),
                   f"{args.workload}-{args.seed}-trace{args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
