"""The process world and its (data, graph) mesh on ``torch.distributed``
(counterpart: ``gkgnet_tpu/parallel/mesh.py``).

The parallel dimensions are the JAX package's:

  * ``data`` -- the batch (data parallelism): each data rank holds its own
    rows of the global batch; the gradients are averaged over the data axis
    after the backward, and BatchNorm's train-mode moments are reduced over
    it (SyncBN);
  * ``graph`` -- the node partition of the graph convs: the ranks of one
    graph group hold the same rows, and each graph conv splits its query
    nodes over the group (``parallel/edge_partition.py``).

One rank is one process with one device. Ranks are laid out (data, graph)
as ``make_mesh`` lays out devices: rank = data_rank * graph + graph_rank,
so the ranks of a graph group are consecutive (on one host where the world
spans hosts by data).

Transport, chosen once by ``choose_backend`` and printed by
``init_distributed``, with no try-and-fall-back:
  * NCCL where every local rank has a card of its own;
  * gloo where local ranks share a card or run on the CPU: CUDA tensors
    cross it through host buffers (``parallel/collectives.py``), since
    NCCL refuses two ranks on one device;
  * an explicit ``backend=`` wins.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

_DEVICE: list[torch.device] = []  # the device init_distributed chose


@dataclass
class Mesh:
    """This rank's place in a (data, graph) mesh of the world.

    ``data_group`` holds the ranks with this rank's graph coordinate (the
    ranks a data-axis reduction spans) and ``graph_group`` those with its
    data coordinate; a group is None where its axis has size 1 (every
    collective over it is then the identity). ``graph_ranks`` are the
    global ranks of this rank's graph group, in graph order."""

    world: int
    rank: int
    data: int
    graph: int
    data_rank: int
    graph_rank: int
    data_group: object | None
    graph_group: object | None
    graph_ranks: tuple[int, ...]
    device: torch.device
    backend: str | None


def choose_backend(device: torch.device, local_world: int,
                   n_cards: int) -> str:
    """The transport rule: NCCL where every local rank has a card of its
    own, else gloo (ranks sharing a card, or on the CPU)."""
    if device.type == "cuda" and local_world <= n_cards:
        return "nccl"
    return "gloo"


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def init_distributed(device: str | torch.device = "cuda",
                     backend: str | None = None,
                     init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None,
                     local_world_size: int | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     verbose: bool = True) -> torch.device:
    """Join the world and return this rank's device.

    Without arguments it reads the ``torch.distributed.run`` environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
    ``MASTER_ADDR`` / ``MASTER_PORT`` through ``env://``); a spawned world
    passes a ``file://`` store and its ranks. The process group always gets
    ``timeout_s``, so a rank that never arrives fails its peers' collectives
    instead of hanging them. On CUDA, local rank r takes card
    ``r % device_count``."""
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else world_size
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None \
        else local_rank
    local_world_size = (_env_int("LOCAL_WORLD_SIZE", world_size)
                        if local_world_size is None else local_world_size)
    device = torch.device(device)
    n_cards = 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                               "the CPU")
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    _DEVICE[:] = [device]
    rule = choose_backend(device, local_world_size, n_cards)
    backend = backend or rule
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    if verbose and rank == 0:
        why = ("every local rank has a card of its own" if rule == "nccl"
               else f"{local_world_size} local ranks on {n_cards} card(s)"
               + ("; CUDA tensors staged through pinned host buffers"
                  if device.type == "cuda" else ""))
        how = f"rule: {why}" if backend == rule else "asked for"
        print(f"transport: {backend} ({how}); world {world_size}, timeout "
              f"{timeout_s:.0f} s", flush=True)
    return device


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(data: int | None = None, graph: int = 1,
              device: torch.device | None = None) -> Mesh:
    """The (data, graph) mesh of the current world (a world of one rank
    when ``torch.distributed`` is not initialized). ``data=None`` fills
    ``world // graph``. Every rank must call it, in the same order as its
    peers: it creates the process groups."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    graph = graph or 1
    if data is None:
        if world % graph:
            raise ValueError(f"a graph axis of {graph} does not divide a "
                             f"world of {world} ranks (launch a multiple "
                             f"of {graph}, e.g. with torch.distributed.run "
                             f"--nproc_per_node {graph})")
        data = world // graph
    if data * graph != world:
        raise ValueError(f"mesh {data}x{graph} != a world of {world} ranks "
                         f"(launch {data * graph} ranks, e.g. with "
                         f"torch.distributed.run --nproc_per_node "
                         f"{data * graph})")
    layout = np.arange(world).reshape(data, graph)
    data_rank, graph_rank = divmod(rank, graph)
    data_group = graph_group = None
    # every rank creates every group, in one order
    if data > 1:
        for g in range(graph):
            grp = dist.new_group(layout[:, g].tolist())
            if g == graph_rank:
                data_group = grp
    if graph > 1:
        for d in range(data):
            grp = dist.new_group(layout[d].tolist())
            if d == data_rank:
                graph_group = grp
    if device is None:
        device = _DEVICE[0] if initialized and _DEVICE else \
            torch.device("cpu")
    return Mesh(world=world, rank=rank, data=data, graph=graph,
                data_rank=data_rank, graph_rank=graph_rank,
                data_group=data_group, graph_group=graph_group,
                graph_ranks=tuple(layout[data_rank].tolist()),
                device=torch.device(device),
                backend=dist.get_backend() if initialized else None)


def local_batch_rows(global_rows: int, mesh: Mesh) -> slice:
    """THIS rank's rows of a global batch: the data rank's contiguous block
    (the graph ranks of a data group hold the same rows)."""
    if global_rows % mesh.data:
        raise ValueError(f"a global batch of {global_rows} does not split "
                         f"over {mesh.data} data ranks")
    n = global_rows // mesh.data
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """A global host batch dict -> this rank's rows of every entry, on the
    mesh's device."""
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        out[key] = t[local_batch_rows(t.shape[0], mesh)].to(mesh.device)
    return out


def _state_tensors(state) -> list[torch.Tensor]:
    """The parameters, buffers, optimizer state and EMA of a TrainState,
    in one order on every rank."""
    out = list(state.model.parameters()) + list(state.model.buffers())
    if state.optimizer is not None:
        opt = state.optimizer.optimizer
        for group in opt.param_groups:
            for p in group["params"]:
                for key in sorted(opt.state.get(p, {})):
                    v = opt.state[p][key]
                    if isinstance(v, torch.Tensor):
                        out.append(v)
    if state.ema_params is not None:
        out += list(state.ema_params.values())
    return out


@torch.no_grad()
def replicate_state(state, mesh: Mesh):
    """Make every rank's TrainState rank 0's: a broadcast of the
    parameters, buffers, optimizer state and EMA. Returns the state."""
    from gkgnet_tpu_torch.parallel import collectives

    if mesh.world > 1:
        for t in _state_tensors(state):
            collectives.broadcast_(t, src=0)
    return state


def sync_processes(mesh: Mesh | None = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Line the ranks up at a barrier that fails after ``timeout_s`` (gloo's
    monitored barrier names the ranks that did not arrive). No-op in a
    world of one."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(
            timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier(device_ids=[mesh.device.index] if mesh else None)
