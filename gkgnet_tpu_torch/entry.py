"""Entry points of the port (counterparts: ``__graft_entry__.entry`` and
``bench.py``'s ``bench_train``).

``entry()`` builds the main path's model, GKGNet-S at 576x576 with 80
classes in bf16, from a seeded init, and a seeded standard-normal NHWC
input (never zeros: an all-zeros image makes every kNN distance tie).
``predict(model, images)`` answers one request: sigmoid scores.
``train_entry()`` builds the training step of the same model.
``dryrun_multichip(n)`` and ``dryrun_multichip_prod(n)`` (counterparts:
``__graft_entry__.dryrun_multichip`` / ``dryrun_multichip_prod``) spawn a
world of n ranks on this host (``parallel.spawn``), lay them out as a
(data = n/2, graph = 2) mesh and take one full train step on each --
forward with the edge-partitioned graph convs, dual loss, backward,
gradient mean over the data axis, AdamW, BatchNorm statistics over the
data group and EMA -- then print the loss: t@128 with k = 3 and 10
classes in fp32, and s@576 with k = 9 and 80 classes in bf16 at a global
batch of 8. Ranks that share one card talk over gloo through host buffers
(``parallel.mesh.choose_backend``).

All run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from gkgnet_tpu_torch.core.optim import build_optimizer
from gkgnet_tpu_torch.core.schedules import step_lr_with_warmup
from gkgnet_tpu_torch.core.trainer import create_train_state, make_train_step
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters
from gkgnet_tpu_torch.ops import knn_mr, knn_topk
from gkgnet_tpu_torch.parallel import spawn
from gkgnet_tpu_torch.parallel.mesh import (make_mesh, replicate_state,
                                            shard_batch)
from gkgnet_tpu_torch.parallel.sharding import graph_sharding

SIZE = 576
N_CLASSES = 80


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or implied) and there is no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                           "the CPU")
    return device


def entry(device: str | torch.device | None = None, batch: int = 1,
          dtype: torch.dtype = torch.bfloat16, seed: int = 0,
          arch: str = "s", size: int | None = None):
    """Returns ``(fn, (model, x))`` where ``fn(model, x)`` is the eval
    forward giving the logits ``(batch, 80)``; ``arch`` and ``size``
    (default SIZE) pick another of the model's settings."""
    device = resolve_device(device)
    size = SIZE if size is None else size
    model = GKGNetClassifier(arch=arch, n_classes=N_CLASSES, size=size,
                             dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    x = torch.randn((batch, size, size, 3),
                    generator=torch.Generator().manual_seed(seed))
    x = x.to(device=device, dtype=dtype)

    @torch.no_grad()
    def fn(model: GKGNetClassifier, x: torch.Tensor) -> torch.Tensor:
        return model(x)[0]

    return fn, (model, x)


@torch.no_grad()
def predict(model: GKGNetClassifier, images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> sigmoid scores ``(B, n_classes)`` on the model's
    device."""
    device = next(model.parameters()).device
    logits, _ = model(images.to(device))
    return model.predict(logits)


def train_entry(device: str | torch.device | None = None, batch: int = 8,
                dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                arch: str = "s", size: int | None = None):
    """Returns ``(fn, (state, batch))`` where ``fn(state, batch)`` takes one
    training step and returns ``(state, log_vars)``: GKGNet-S@576 (or
    ``arch`` at ``size``, default SIZE) with
    drop_path 0.1, AdamW (lr 1e-4 stepped at epochs 10 and 50 of 1000
    steps, 5000 warmup steps, wd 0.05, clip 5) and an EMA of momentum 2e-4;
    seeded standard-normal images and multi-hot labels (each class on with
    probability 0.05), as ``bench.py``'s ``bench_train`` makes them."""
    device = resolve_device(device)
    size = SIZE if size is None else size
    model = GKGNetClassifier(arch=arch, n_classes=N_CLASSES, size=size,
                             drop_path=0.1, dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.standard_normal((batch, size, size, 3), dtype=np.float32))
    labels = torch.from_numpy(rng.random((batch, N_CLASSES)) < 0.05)
    data = {"img": images.to(device=device, dtype=dtype),
            "gt_label": labels.to(device=device, dtype=torch.float32)}
    schedule = step_lr_with_warmup(1e-4, 1000, [10, 50], warmup_iters=5000)
    state = create_train_state(model, build_optimizer(model, schedule),
                               ema=True)
    step = make_train_step(ema_momentum=2e-4)

    def fn(state, batch):
        return step(state, batch, seed)

    return fn, (state, data)


# the dryruns' models: (constructor arguments, dtype, share of positive
# labels)
DRYRUN_MODELS = {
    "t128": (dict(arch="t", k=3, k_label_gcn=3, n_classes=10, size=128,
                  drop_path=0.1), torch.float32, 0.3),
    "s576": (dict(arch="s", k=9, k_label_gcn=9, n_classes=N_CLASSES,
                  size=SIZE, drop_path=0.1), torch.bfloat16, 0.05),
}


def dryrun_state(name: str, device: str | torch.device, batch: int,
                 seed: int = 0):
    """``(state, data, step)`` of a dryrun model on ``device``: the seeded
    init with AdamW (lr 1e-4 stepped at epochs 10 and 50 of 10 steps, 5
    warmup steps) and an EMA of momentum 2e-4, a global batch of seeded
    standard-normal images and multi-hot labels on the host (as the JAX
    dryrun makes them), and the train step."""
    kwargs, dtype, positive = DRYRUN_MODELS[name]
    model = GKGNetClassifier(**kwargs, dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    schedule = step_lr_with_warmup(1e-4, 10, [10, 50], warmup_iters=5)
    state = create_train_state(model, build_optimizer(model, schedule),
                               ema=True)
    size, n_classes = kwargs["size"], kwargs["n_classes"]
    images = np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3), dtype=np.float32)
    labels = np.random.default_rng(seed + 1).random((batch, n_classes))
    data = {"img": torch.from_numpy(images).to(dtype),
            "gt_label": torch.from_numpy(labels < positive).float()}
    return state, data, make_train_step(ema_momentum=2e-4)


def launch_counts() -> dict:
    """The knn kernels' launch counters, by kernel."""
    return dict(knn_mr=knn_mr.launches,
                knn_mr_backward=knn_mr.backward_launches,
                knn_mr_grouped=knn_mr.grouped_launches,
                knn_mr_normalize=knn_mr.normalize_launches,
                knn_topk=knn_topk.launches,
                gather_backward=knn_mr.gather_backward_launches)


def _reset_counts() -> None:
    knn_mr.launches = knn_mr.backward_launches = 0
    knn_mr.grouped_launches = knn_topk.launches = 0
    knn_mr.normalize_launches = knn_mr.gather_backward_launches = 0


def _timed(device: torch.device, fn):
    """``(fn(), ms)`` on a host clock around device synchronizations."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t) * 1e3


def dryrun_rank(name: str, batch: int, steps: int = 1,
                report: bool = False, graph: int = 2) -> dict:
    """One rank of a dryrun world (run by ``parallel.spawn.run_world``):
    the (data = world / graph, graph) mesh, the dryrun state replicated
    from rank 0, this rank's rows of the global batch, and ``steps`` train
    steps under ``graph_sharding``. Returns the losses and, with
    ``report``, the knn launch counts and ms of an eval forward on the
    gather schedule and one on the ring (after an untimed one, before the
    steps; their logits on the host) and of each train step, the peak
    memory, and a digest of the parameters after the steps (equal on every
    rank when the ranks' parameters are bitwise alike)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    mesh = make_mesh(data=world // graph, graph=graph)
    state, data, step = dryrun_state(name, mesh.device, batch)
    replicate_state(state, mesh)
    local = shard_batch(data, mesh)
    out = dict(rank=mesh.rank, device=str(mesh.device), data=mesh.data,
               graph=mesh.graph, backend=mesh.backend, loss=[], steps=[])
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    model = state.model

    def forward(overlap: bool) -> dict:
        _reset_counts()
        model.eval()
        with torch.no_grad(), graph_sharding(mesh, overlap=overlap):
            logits, ms = _timed(mesh.device, lambda: model(local["img"])[0])
        model.train()
        return dict(counts=launch_counts(), ms=ms, logits=logits.float().cpu())

    if report:
        forward(False)  # the first call's start-up costs, untimed
        out["eval_gather"] = forward(False)
        out["eval_ring"] = forward(True)
    for _ in range(steps):
        _reset_counts()
        with graph_sharding(mesh):
            (state, logs), ms = _timed(
                mesh.device, lambda: step(state, local, 7))
        out["loss"].append(float(logs["loss"]))
        out["steps"].append(dict(counts=launch_counts(), ms=ms))
    if mesh.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    if report:
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        out["params_digest"] = digest.hexdigest()
    return out


def dryrun_multichip(n_devices: int, device=None) -> float:
    """One train step of t@128 (k 3, 10 classes, fp32, drop_path 0.1) on a
    spawned world of n ranks, mesh (data = n/2, graph = 2) (graph 1 for an
    odd n), global batch 2 per data rank; prints and returns the loss."""
    device = resolve_device(device)
    graph = 2 if n_devices % 2 == 0 else 1
    res = spawn.run_world(dryrun_rank, n_devices,
                          ("t128", 2 * (n_devices // graph), 1, False, graph),
                          device=device.type)
    loss = res[0]["loss"][0]
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}): loss {loss}")
    print(f"dryrun_multichip({n_devices}) ok: mesh={{'data': "
          f"{n_devices // graph}, 'graph': {graph}}} "
          f"transport={res[0]['backend']} loss={loss:.4f}")
    return loss


def dryrun_multichip_prod(n_devices: int = 4, device=None, batch: int = 8,
                          steps: int = 1, report: bool = False
                          ) -> list[dict]:
    """The production geometry: s@576 (k 9, 80 classes, bf16, drop_path
    0.1) on a spawned world of n ranks, mesh (data = n/2, graph = 2),
    global batch ``batch``; ``steps`` train steps (and with ``report`` the
    timed eval forwards of ``dryrun_rank``). Prints the loss; returns every
    rank's ``dryrun_rank`` result."""
    device = resolve_device(device)
    if n_devices % 2:
        raise ValueError("the production dryrun takes graph = 2: an even "
                         "world")
    res = spawn.run_world(dryrun_rank, n_devices,
                          ("s576", batch, steps, report, 2),
                          device=device.type, timeout_s=600.0)
    loss = res[0]["loss"][0]
    if not all(np.isfinite(r["loss"]).all() for r in res):
        raise RuntimeError(f"dryrun_multichip_prod({n_devices}): losses "
                           f"{[r['loss'] for r in res]}")
    print(f"dryrun_multichip_prod({n_devices}) ok: mesh={{'data': "
          f"{n_devices // 2}, 'graph': 2}} transport={res[0]['backend']} "
          f"arch=s size=576 batch={batch} loss={loss:.4f}")
    return res
