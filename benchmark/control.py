"""The readings that the limits of ``limits/<workload>.json`` are set from,
on the card, in one process per call (the benchmark's own runs do not run
this):

    python3 benchmark/control.py --workload <cell>[,<cell>...] \\
        --seeds 1,2,... [--control-seeds ...] [--fault-seeds ...] \\
        [--seconds 1]

  * ``--seeds``: sound runs of the program, the cell's own set-up and a
    short window (``--seconds``; training cells compare their set-up
    steps and need none), checked against the fp32 reference: the lower
    readings;
  * ``--control-seeds``: the plain reference computed in fp8 (e4m3, per
    tensor scaled, gradients too) in the program's place, the step below
    the configuration's bf16: the upper readings;
  * ``--fault-seeds`` (training cells): the reference in the program's
    place with half of each batch left out and the loss's mean taken over
    the rest.

Each run prints one JSON line: the workload, the system, the seed, the
readings, ``correct`` under the current limits and the end-to-end metrics.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def systems(batch: int):
    from benchmark.reference.model import round_to
    from benchmark.system import Program, Reference
    return {
        "program": Program,
        "control": lambda *a: Reference(*a, cast=round_to("fp8")),
        "half": lambda *a: Reference(*a, rows=batch // 2),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    device = torch.device("cuda", 0)
    for name in args.workload.split(","):
        tr = harness.traffic(harness.workload(spec, name)["traffic"])
        make = systems(tr["batch"])
        plan = [("program", args.seeds), ("control", args.control_seeds)]
        if tr["kind"] == "train":
            plan.append(("half", args.fault_seeds))
        for system, seeds in plan:
            for seed in [int(s) for s in seeds.split(",") if s]:
                t = time.perf_counter()
                seconds = 0.0 if tr["kind"] == "train" else args.seconds
                r = harness.run_cell(spec, name, seed, seconds, False, device,
                                     make_system=make[system])
                print(json.dumps({
                    "workload": name, "system": system, "seed": seed,
                    "readings": r["_readings"], "correct": r["correct"],
                    "metrics": r["metrics"], "attempted": r["attempted"],
                    "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                    "ref_peak_bytes": torch.cuda.max_memory_allocated(device),
                    "run_s": time.perf_counter() - t}), flush=True)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
