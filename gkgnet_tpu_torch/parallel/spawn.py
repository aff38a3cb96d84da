"""Spawn a world of ranks on this host and collect what each returns.

``run_world(target, n, args)`` starts n processes (``spawn``: no inherited
CUDA state), each of which joins the world through a ``file://`` store in a
fresh temporary directory (no TCP port to collide with another world),
calls ``target(*args)`` and saves what it returns. A rank that raises fails
the world at once: the parent kills the others and raises with the rank's
traceback. A world that has not finished after ``timeout_s`` is killed and
raises too; the process group's own timeout fails a collective that waits
on a dead peer before that.

``target`` must be importable by the children: a function of a module, not
of ``__main__`` run from stdin, nor a lambda.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback

import torch

from gkgnet_tpu_torch.parallel import mesh as mesh_mod


def _child(rank: int, n: int, root: str, target, args: tuple, device: str,
           backend: str | None, timeout_s: float, threads: int) -> None:
    # every rank is on this host: gloo's pairs over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(threads)
    try:
        mesh_mod.init_distributed(
            device, backend=backend,
            init_method=f"file://{os.path.join(root, 'store')}", rank=rank,
            world_size=n, local_rank=rank, local_world_size=n,
            timeout_s=timeout_s, verbose=rank == 0)
        out = target(*args)
        torch.save(out, os.path.join(root, f"result{rank}.pt"))
        mesh_mod.destroy()
    except BaseException:
        with open(os.path.join(root, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(target, n: int, args: tuple = (), *, device: str = "cpu",
              backend: str | None = None, timeout_s: float = 300.0) -> list:
    """Run ``target(*args)`` on each rank of a world of n spawned ranks on
    ``device`` and return the n results, in rank order. Raises on the
    first rank that fails and on a world that outlasts ``timeout_s``
    (the process groups get the same timeout)."""
    threads = max(1, (os.cpu_count() or 1) // n)  # the host's cores shared
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gkgnet_world_") as root:
        procs = [ctx.Process(target=_child,
                             args=(r, n, root, target, args, device, backend,
                                   timeout_s, threads), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(_failure(root, procs, failed))
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {n} ranks outlasted {timeout_s:.0f} s "
                        f"(+60 s); ranks still alive: "
                        f"{[r for r, p in enumerate(procs) if p.is_alive()]}")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(_failure(root, procs, failed))
            return [torch.load(os.path.join(root, f"result{r}.pt"),
                               weights_only=False) for r in range(n)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)


def _failure(root: str, procs, failed: list[int]) -> str:
    lines = [f"rank {r} exited with {procs[r].exitcode}" for r in failed]
    for r in failed:
        path = os.path.join(root, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"--- rank {r}:\n{f.read()}")
    return "\n".join(lines)
