"""Does the partitioned bf16 train step repeat from run to run, and what
makes it move? A diagnosis tool for one card.

    python -m gkgnet_tpu_torch.tools.determinism_probe [MODE ...]

For each mode: ``chip_smoke.py`` phase 13 (b)'s bf16 graph-only step
(``train_entry()`` at batch 8 on a world of 2 ranks, mesh data 1 x
graph 2) taken twice from the seeded state in one world, and (c)'s two
steps of ``entry.dryrun_rank('s576', ...)`` (data 2 x graph 2, global
batch 8) taken twice in one world of 4. It prints, per mode, the digests
of rank 0's and rank 1's gradients in the two runs, whether the runs are
bitwise alike, the gap of the gradients to the one-process step's
(max|diff| / max|grad| per leaf: median and worst) and the launch counts;
then (c)'s losses of every rank in both runs. Modes (all three by
default):

  * ``atomic``: ``gather_nodes`` as ``torch.gather`` alone (set in this
    tool's ranks only), whose backward on the card is a scatter-add with
    float atomics;
  * ``atomic_det``: the same under ``torch.use_deterministic_algorithms(
    True, warn_only=True)`` (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before
    the world starts), set here and never in the port;
  * ``ordered``: the port as it is, whose gather backward is the ordered
    sum (``ops/aggregate.py`` ``gather_backward``).

Before the modes it checks the one-process bf16 step twice, and the
perturbed graph build's ``scatter_add_`` (``ops/perturbed_topk.py``) twice
at t@224's stage-1 and stage-3 shapes. Needs a card: without one it exits
with an error.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import torch

from gkgnet_tpu_torch import entry as entry_mod
from gkgnet_tpu_torch.ops import aggregate, knn_mr, knn_topk, perturbed_topk
from gkgnet_tpu_torch.parallel import edge_partition, spawn
from gkgnet_tpu_torch.parallel.mesh import make_mesh
from gkgnet_tpu_torch.parallel.sharding import graph_sharding

T0 = time.perf_counter()
MODES = ("atomic", "atomic_det", "ordered")


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def setup(mode: str) -> None:
    """The mode's gather backward (in each rank)."""
    if mode.startswith("atomic"):
        aggregate.gather_nodes = aggregate._take
        edge_partition.gather_nodes = aggregate._take
    if mode == "atomic_det":
        torch.use_deterministic_algorithms(True, warn_only=True)


def grads_of(model) -> dict:
    return {k: p.grad.detach().float().cpu()
            for k, p in model.named_parameters()}


def digest(grads: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(grads):
        h.update(grads[k].numpy().tobytes())
    return h.hexdigest()[:16]


def leaf_gaps(got: dict, ref: dict) -> list[float]:
    """max|got - ref| / max|ref| per leaf (a leaf below 1e-4 of the
    model's largest |ref| relative to that), sorted."""
    top = max(g.abs().max().item() for g in ref.values())
    gaps = []
    for key, g in ref.items():
        scale = g.abs().max().item()
        scale = top if scale < 1e-4 * top else scale
        gaps.append((got[key] - g).abs().max().item() / max(scale, 1e-30))
    return sorted(gaps)


def graph_only_rank(mode: str) -> list[dict]:
    """(b) twice on one rank of a (data 1, graph 2) world."""
    setup(mode)
    mesh = make_mesh(data=1, graph=2)
    out = []
    for run in range(2):
        fn, (state, batch) = entry_mod.train_entry(device=mesh.device,
                                                   batch=8)
        entry_mod._reset_counts()
        with graph_sharding(mesh):
            state, logs = fn(state, batch)
        torch.cuda.synchronize()
        g = grads_of(state.model)
        out.append(dict(loss=float(logs["loss"]), digest=digest(g),
                        counts=entry_mod.launch_counts(),
                        grads=g if run == 0 and mesh.rank == 0 else None))
        del fn, state, batch, g
        torch.cuda.empty_cache()
    return out


def prod_rank(mode: str) -> list[list[float]]:
    """(c)'s two steps twice on one rank of a world of 4."""
    setup(mode)
    return [entry_mod.dryrun_rank("s576", 8, 2, False, 2)["loss"]
            for _ in range(2)]


def one_process() -> list[tuple[float, dict]]:
    """The one-process bf16 step twice from the seeded state."""
    out = []
    for _ in range(2):
        fn, (state, batch) = entry_mod.train_entry(device="cuda", batch=8)
        state, logs = fn(state, batch)
        torch.cuda.synchronize()
        out.append((float(logs["loss"]), grads_of(state.model)))
        del fn, state, batch
        torch.cuda.empty_cache()
    return out


def perturbed_check() -> dict:
    """y's gradient through the perturbed build twice, per shape."""
    res = {}
    for name, (b, n, m, c, k, dil) in {
            "t224_stage1": (4, 3136, 196, 24, 9, 1),
            "t224_stage3": (4, 196, 196, 120, 9, 3)}.items():
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((b, n, c), generator=gen).cuda()
        y0 = torch.randn((b, m, c), generator=gen).cuda()
        grads = []
        for _ in range(2):
            y = y0.clone().requires_grad_()
            out = perturbed_topk.soft_knn_gather(
                x, y, k, dilation=dil, num_samples=20, sigma=0.1,
                generator=torch.Generator(device="cuda").manual_seed(7))
            out.sum().backward()
            torch.cuda.synchronize()
            grads.append(y.grad.clone())
        res[name] = dict(bitwise=bool(torch.equal(grads[0], grads[1])),
                         max_abs=float((grads[0] - grads[1]).abs().max()),
                         scale=float(grads[0].abs().max()))
    return res


def main(modes) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}")
    knn_mr._lib()
    knn_mr._bwd_lib()
    knn_topk._lib()
    log(f"perturbed scatter_add_ twice: {json.dumps(perturbed_check())}")
    ref = one_process()
    same = all(torch.equal(ref[0][1][k], ref[1][1][k]) for k in ref[0][1])
    log(f"one process bf16 step twice: losses {ref[0][0]!r} "
        f"{ref[1][0]!r}, gradients bitwise alike {same}")
    ref_grads = ref[0][1]
    del ref
    for mode in modes:
        env = ({"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
               if mode == "atomic_det" else {})
        os.environ.update(env)
        t = time.perf_counter()
        res = spawn.run_world(graph_only_rank, 2, (mode,), device="cuda",
                              timeout_s=300)
        r0 = res[0]
        gaps = leaf_gaps(r0[0].pop("grads"), ref_grads)
        log(f"[{mode}] (b) graph-only bf16 step, two runs: losses "
            f"{[r['loss'] for r in r0]}, digests rank0 "
            f"{[r['digest'] for r in r0]} rank1 "
            f"{[r['digest'] for r in res[1]]}; runs alike "
            f"{r0[0]['digest'] == r0[1]['digest']}; gap to one process "
            f"median {gaps[len(gaps) // 2]:.3e} worst {gaps[-1]:.3e}; "
            f"counts {r0[0]['counts']}; {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        res = spawn.run_world(prod_rank, 4, (mode,), device="cuda",
                              timeout_s=600)
        log(f"[{mode}] (c) 2 x 2, two steps, two runs: rank losses {res}; "
            f"step 2 alike across runs "
            f"{all(r[0][1] == r[1][1] for r in res)}; "
            f"{time.perf_counter() - t:.1f} s")
        for key in env:
            del os.environ[key]
    log("done")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("determinism_probe: no CUDA device")
    unknown = set(sys.argv[1:]) - set(MODES)
    if unknown:
        sys.exit(f"determinism_probe: unknown modes {sorted(unknown)}, "
                 f"choose from {MODES}")
    main(sys.argv[1:] or MODES)
