"""The ranks' side of tests/test_torch_parallel.py: one function that runs
every case of the port on a spawned world of 4 CPU ranks and returns this
rank's results. It imports torch and the port only (never JAX or the tests'
conftest), since each spawned rank imports the module of its target.

``run_cases(inputs)`` takes the numpy inputs the test module made (and the
JAX package's variable trees, as numpy) and returns a dict of this rank's
outputs, keyed by case, with its mesh coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from gkgnet_tpu_torch.core.optim import build_optimizer
from gkgnet_tpu_torch.core.schedules import step_lr_with_warmup
from gkgnet_tpu_torch.core.trainer import create_train_state, make_train_step
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier
from gkgnet_tpu_torch.nn.layers import BatchNorm
from gkgnet_tpu_torch.parallel import collectives as col
from gkgnet_tpu_torch.parallel import edge_partition as ep
from gkgnet_tpu_torch.parallel.mesh import (make_mesh, shard_batch,
                                            sync_processes)
from gkgnet_tpu_torch.parallel.sharding import graph_sharding
from gkgnet_tpu_torch.utils.weights import load_jax_variables

SMALL = dict(arch="t", k=3, k_label_gcn=3, n_classes=10, size=128)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(t: torch.Tensor, dim: int, parts: int, i: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, i * n, n).contiguous()


def _edges(mesh, case: dict, overlap: bool,
           dtype: torch.dtype = torch.float32) -> dict:
    """edge_partitioned_knn_mr on this rank's block of the batch (data) and
    of the queries and targets (graph), in ``dtype``, with the gradients of
    sum(mr^2) (taken in fp32)."""
    x, y, bias = (None if case.get(k) is None else _t(case[k])
                  for k in ("x", "y", "bias"))
    x = x.to(dtype)
    y = None if y is None else y.to(dtype)
    x = _block(x, 0, mesh.data, mesh.data_rank)
    x_l = _block(x, 1, mesh.graph, mesh.graph_rank).requires_grad_()
    y_l = None
    if y is not None:
        y = _block(y, 0, mesh.data, mesh.data_rank)
        y_l = _block(y, 1, mesh.graph, mesh.graph_rank).requires_grad_()
    if bias is not None:
        bias = _block(bias, 0, mesh.graph, mesh.graph_rank)
    idx, mr = ep.edge_partitioned_knn_mr(mesh, x_l, y_l, bias, k=case["k"],
                                         dilation=case["d"], overlap=overlap)
    mr.float().square().sum().backward()
    return dict(idx=idx, mr=mr.detach(), gx=x_l.grad,
                gy=None if y_l is None else y_l.grad)


def _edges_whole(mesh, case: dict) -> dict:
    """replicated_targets_knn_mr as the model's graph convs take it: this
    rank's block of the batch (data) and of the queries (graph) against the
    whole targets (the queries themselves for self-kNN), with the gradients
    of sum(mr^2) for the whole x and y of the data block."""
    x = _block(_t(case["x"]), 0, mesh.data, mesh.data_rank).requires_grad_()
    y = None
    if case.get("y") is not None:
        y = _block(_t(case["y"]), 0, mesh.data,
                   mesh.data_rank).requires_grad_()
    bias = None if case.get("bias") is None \
        else _block(_t(case["bias"]), 0, mesh.graph, mesh.graph_rank)
    x_l = col.scatter_rows(x, mesh.graph_group, dim=1)
    idx, mr = ep.replicated_targets_knn_mr(
        mesh, x_l, x if y is None else y, bias, k=case["k"],
        dilation=case["d"])
    mr.square().sum().backward()
    return dict(idx=idx, mr=mr.detach(), gx=x.grad,
                gy=None if y is None else y.grad)


def _label(mesh, case: dict, dtype: torch.dtype = torch.float32) -> dict:
    """label_sharded_knn_mr on this rank's batch rows and block of targets,
    in ``dtype``, with the gradients of sum(mr^2) (taken in fp32; x whole,
    y this rank's block)."""
    x = _block(_t(case["x"]), 0, mesh.data, mesh.data_rank).to(dtype)
    x.requires_grad_()
    y = _block(_t(case["y"]), 0, mesh.data, mesh.data_rank).to(dtype)
    y_l = _block(y, 1, mesh.graph, mesh.graph_rank).requires_grad_()
    idx, mr = ep.label_sharded_knn_mr(mesh, x, y_l, k=case["k"])
    mr.float().square().sum().backward()
    r_idx, r_mr = ep.replicated_knn_mr(mesh, x.detach(), y, k=case["k"])
    return dict(idx=idx, mr=mr.detach(), gx=x.grad, gy=y_l.grad,
                replicated_idx=r_idx, replicated_mr=r_mr)


def _batchnorm(mesh, x: np.ndarray, w: np.ndarray) -> dict:
    """The data-group BatchNorm in train mode on this rank's rows, and the
    gradients of sum(out * w) over those rows."""
    bn = BatchNorm(x.shape[-1], process_group=mesh.data_group).train()
    x_l = _block(_t(x), 0, mesh.data, mesh.data_rank).requires_grad_()
    out = bn(x_l)
    (out * _block(_t(w), 0, mesh.data, mesh.data_rank)).sum().backward()
    return dict(out=out.detach(), mean=bn.running_mean.clone(),
                var=bn.running_var.clone(), gx=x_l.grad,
                gweight=bn.weight.grad, gbias=bn.bias.grad)


def _model(variables: dict, **kwargs) -> GKGNetClassifier:
    model = GKGNetClassifier(**SMALL, **kwargs)
    load_jax_variables(model, variables)
    return model


def _forward(mesh, variables: dict, x: np.ndarray, overlap: bool):
    model = _model(variables).eval()
    img = shard_batch({"img": x}, mesh)["img"]
    with torch.no_grad(), graph_sharding(mesh, overlap=overlap):
        return model(img)[0]


def split_moments(parts: int):
    """``BatchNorm._moments`` of one process whose batch is ``parts`` data
    ranks' rows: each block's sums, added in rank order, as the data
    group's all-reduce adds them (a check's reference)."""
    def moments(self, x32):
        axes = tuple(range(x32.dim() - 1))
        c = x32.shape[-1]
        total = None
        for block in x32.chunk(parts, 0):
            sums = torch.cat([block.sum(dim=axes),
                              block.square().sum(dim=axes),
                              block.new_full((1,), block.numel() // c)])
            total = sums if total is None else total + sums
        count = total[2 * c]
        mean, mean_sq = total[:c] / count, total[c:2 * c] / count
        return mean, torch.clamp(mean_sq - mean.square(), min=0.0), count
    return moments


def train_setup(variables: dict):
    """The state and step of the train-step cases: the JAX weights, AdamW
    with clip 5 and a warmup schedule, EMA, drop_path 0."""
    model = _model(variables).train()
    schedule = step_lr_with_warmup(1e-3, 10, [5], warmup_iters=2)
    state = create_train_state(model, build_optimizer(model, schedule),
                               ema=True)
    return state, make_train_step(ema_momentum=2e-4)


def _train_step(mesh, variables: dict, batch: dict) -> dict:
    state, step = train_setup(variables)
    seen = []
    hook = state.model.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.deterministic))
    with graph_sharding(mesh):
        state, logs = step(state, shard_batch(batch, mesh), 7)
    hook.remove()
    return dict(logs={k: float(v) for k, v in logs.items()},
                deterministic=(seen, torch.backends.cudnn.deterministic),
                state={k: v.clone() for k, v in
                       state.model.state_dict().items()},
                grads={k: p.grad.clone() for k, p in
                       state.model.named_parameters()})


def _gradients(mesh, variables: dict, batch: dict) -> dict:
    """Every parameter's gradient after one forward and backward of the
    head's loss on this rank's rows, before any reduction."""
    model = _model(variables).train()
    local = shard_batch(batch, mesh)
    with graph_sharding(mesh):
        score, _ = model(local["img"],
                         generator=torch.Generator().manual_seed(7))
        losses = model.build_loss_head().loss(score, local["gt_label"])
        sum(v.mean() for v in losses.values()).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _bf16_collectives(mesh) -> dict:
    """Each collective on bfloat16 tensors (moved as bytes over gloo):
    rank r's tensor is seeded by r."""
    def mine(rank):
        return torch.randn((2, 3, 5), generator=torch.Generator()
                           .manual_seed(rank)).bfloat16()
    x = mine(mesh.rank)
    ring = col.RingTransfer(x, mesh.graph_ranks, mesh.graph_rank,
                            mesh.graph_group).wait()
    b = x.clone()
    col.broadcast_(b, src=0)
    return dict(gathered=col.all_gather(x, mesh.graph_group, dim=1),
                summed=col.all_reduce(x, mesh.graph_group), ring=ring,
                broadcast=b, mine=x)


def run_cases(inputs: dict) -> dict:
    """Every case on this rank: meshes (data 2, graph 2) and (data 1,
    graph 4), in one order on every rank."""
    m22 = make_mesh(data=2, graph=2)
    m14 = make_mesh(data=1, graph=4)
    m41 = make_mesh(data=4, graph=1)
    out = dict(rank=m22.rank, m22=(m22.data_rank, m22.graph_rank),
               m14=(m14.data_rank, m14.graph_rank))
    out["bf16"] = _bf16_collectives(m14)
    out["gather_bias"] = _edges(m22, inputs["bias_case"], overlap=False)
    out["ring_bias"] = _edges(m14, inputs["bias_case"], overlap=True)
    out["gather_self"] = _edges(m22, inputs["self_case"], overlap=False)
    out["ring_self"] = _edges(m14, inputs["self_case"], overlap=True)
    out["whole_bias"] = _edges_whole(m22, inputs["bias_case"])
    out["whole_self"] = _edges_whole(m22, inputs["self_case"])
    out["label"] = _label(m22, inputs["label_case"])
    out["label_grad"] = _label(m22, inputs["label_grad_case"])
    out["label_grad_bf16"] = _label(m22, inputs["label_grad_case"],
                                    torch.bfloat16)
    out["ring_bf16"] = _edges(m14, inputs["bias_case"], overlap=True,
                              dtype=torch.bfloat16)
    out["batchnorm"] = _batchnorm(m41, inputs["bn_x"], inputs["bn_w"])
    for overlap in (False, True):
        out[f"forward_{overlap}"] = _forward(
            m22, inputs["variables"], inputs["img"], overlap)
    out["train_m22"] = _train_step(m22, inputs["variables"],
                                   inputs["batch"])
    out["train_m14"] = _train_step(m14, inputs["variables"],
                                   inputs["batch"])
    out["grads_graph"] = _gradients(m14, inputs["variables"],
                                    inputs["batch"])
    out["grads_m22"] = _gradients(m22, inputs["variables"], inputs["batch"])
    sync_processes(m22, timeout_s=60.0)
    out["synced"] = True
    return out
