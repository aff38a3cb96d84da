"""Edge-build scaling benchmark (counterpart: ``tools/bench_scaling.py``):
edges/s of ``parallel.edge_partition.edge_partitioned_knn_mr`` over worlds
of 1, 2, 4, ... ranks on the graph axis, for both schedules (the gather and
the ring).

    python -m gkgnet_tpu_torch.tools.bench_scaling [--max-world 4] \\
        [--json out.json] [--device cpu]

Each world is spawned on this host (``parallel.spawn``); each rank makes
the same seeded inputs (stage 1 of GKGNet-S@576 by default: ``--batch``
images x 2 channel groups, N 20736 queries, M 1296 targets, D 40, k 9, in
bf16), keeps its block of queries and targets, and times ``--iters`` calls
after one warmup call, each call ended by a device synchronize; a world's
time is its slowest rank's. Where the ranks outnumber the cards they share
the cards (over gloo, through host buffers), so the numbers measure the
partition's overhead, not its scaling: the output says which.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gkgnet_tpu_torch.parallel import spawn
from gkgnet_tpu_torch.parallel.edge_partition import edge_partitioned_knn_mr
from gkgnet_tpu_torch.parallel.mesh import make_mesh


def rank_times(n: int, m: int, d: int, k: int, bg: int, iters: int,
               dtype: str) -> dict:
    """One rank of a graph world: ms per call of each schedule."""
    mesh = make_mesh(data=1, graph=torch.distributed.get_world_size())
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((bg, n, d), generator=gen).to(getattr(torch, dtype))
    y = torch.randn((bg, m, d), generator=gen).to(getattr(torch, dtype))
    s, r = mesh.graph, mesh.graph_rank
    x_l = x[:, r * n // s:(r + 1) * n // s].contiguous().to(mesh.device)
    y_l = y[:, r * m // s:(r + 1) * m // s].contiguous().to(mesh.device)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    out = {}
    for tag, overlap in (("gather", False), ("ring", True)):
        with torch.no_grad():
            edge_partitioned_knn_mr(mesh, x_l, y_l, None, k=k,
                                    overlap=overlap)
            sync()
            t = time.perf_counter()
            for _ in range(iters):
                edge_partitioned_knn_mr(mesh, x_l, y_l, None, k=k,
                                        overlap=overlap)
                sync()
        out[tag] = (time.perf_counter() - t) * 1e3 / iters
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--max-world", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--n", type=int, default=20736, help="query nodes")
    p.add_argument("--m", type=int, default=1296, help="target nodes")
    p.add_argument("--dim", type=int, default=40)
    p.add_argument("--k", type=int, default=9)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--json", default=None, help="write the results here")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the "
                           "CPU")
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    bg = args.batch * 2  # 2 channel groups
    edges = bg * args.n * args.k
    results = []
    g = 1
    while g <= args.max_world:
        if args.n % g == 0 and args.m % g == 0:
            ranks = spawn.run_world(
                rank_times, g, (args.n, args.m, args.dim, args.k, bg,
                                args.iters, args.dtype),
                device=args.device)
            row = {"graph_ranks": g,
                   "shared_card": args.device == "cuda" and g > cards}
            for tag in ("gather", "ring"):
                ms = max(r[tag] for r in ranks)
                row[f"ms_{tag}"] = ms
                row[f"edges_per_sec_{tag}"] = edges / ms * 1e3
            results.append(row)
        g *= 2
    base = results[0]["edges_per_sec_gather"] if results else 1.0
    for r in results:
        r["scaling_efficiency_gather"] = (r["edges_per_sec_gather"]
                                          / (base * r["graph_ranks"]))
        r["ring_vs_gather"] = (r["edges_per_sec_ring"]
                               / r["edges_per_sec_gather"])
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    out = {"config": {"batch": args.batch, "n": args.n, "m": args.m,
                      "dim": args.dim, "k": args.k, "dtype": args.dtype,
                      "device": name, "cards": cards},
           "note": ("worlds with shared_card true run several ranks on one "
                    "card: their numbers measure the partition's overhead, "
                    "not its scaling"),
           "results": results}
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
