"""Data and graph parallelism of the port (``gkgnet_tpu_torch/parallel/``)
against the JAX package's (``gkgnet_tpu/parallel/``), on the CPU.

JAX runs on ``make_mesh(data=2, graph=2)`` over 4 of the conftest's 8
virtual devices (and ``graph=4`` for the ring), the port on a world of 4
spawned CPU ranks over gloo with the same numpy inputs from a seed. One
module-scoped world runs every case of the port (``torch_parallel_cases``,
which imports torch and the port only); each test reads its case. The
tolerances are the JAX package's own tests' (``tests/test_parallel.py``)
where they compare the same things, and each says why where they do not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_cases as cases
from gkgnet_tpu.nn.classifier import GKGNetClassifier as JaxClassifier
from gkgnet_tpu.nn.layers import BatchNorm as JaxBatchNorm
from gkgnet_tpu.parallel.edge_partition import (edge_partitioned_knn_mr,
                                                label_sharded_knn_mr)
from gkgnet_tpu.parallel.mesh import make_mesh
from gkgnet_tpu.parallel.sharding import graph_sharding
from gkgnet_tpu_torch.nn import layers as tlayers
from gkgnet_tpu_torch.ops.knn_mr import knn_mr_fused
from gkgnet_tpu_torch.parallel import edge_partition as tep
from gkgnet_tpu_torch.parallel import sharding as tsharding
from gkgnet_tpu_torch.parallel.mesh import Mesh
from gkgnet_tpu_torch.parallel.spawn import run_world

WORLD_TIMEOUT_S = 240.0


def _random_tree(shapes, rng):
    """Random fp32 leaves for a tree of ShapeDtypeStructs, scaled so that
    activations stay O(1) (as tests/test_torch_model.py makes them)."""
    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "fc1_kernel"):
            fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" \
                else s.shape[-1]
            return rng.standard_normal(s.shape) * np.sqrt(1.0 / fan_in)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "embedding":
            return rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    bias_case = dict(
        x=rng.standard_normal((4, 64, 16)).astype(f32),
        y=rng.standard_normal((4, 32, 16)).astype(f32),
        bias=(rng.standard_normal((64, 32)) * 0.1).astype(f32), k=3, d=2)
    self_case = dict(x=rng.standard_normal((2, 32, 8)).astype(f32), y=None,
                     bias=None, k=4, d=1)
    label_case = dict(x=rng.standard_normal((4, 10, 16)).astype(f32),
                      y=rng.standard_normal((4, 64, 16)).astype(f32), k=4)
    label_grad_case = dict(x=rng.standard_normal((2, 6, 8)).astype(f32),
                           y=rng.standard_normal((2, 32, 8)).astype(f32),
                           k=3)
    img = rng.standard_normal((2, 128, 128, 3)).astype(f32)
    model = JaxClassifier(**cases.SMALL)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(img),
                           train=False))
    variables = {c: _random_tree(shapes[c], rng)
                 for c in ("params", "batch_stats")}
    batch = {"img": rng.standard_normal((4, 128, 128, 3)).astype(f32),
             "gt_label": (rng.random((4, 10)) < 0.3).astype(f32)}
    return dict(bias_case=bias_case, self_case=self_case,
                label_case=label_case, label_grad_case=label_grad_case,
                bn_x=rng.standard_normal((16, 4, 4, 6)).astype(f32),
                bn_w=rng.standard_normal((16, 4, 4, 6)).astype(f32),
                img=img, variables=variables, batch=batch)


@pytest.fixture(scope="module")
def world():
    """``(inputs, results)``: every case of the port on one world of 4
    spawned CPU ranks; results in rank order."""
    inputs = _inputs()
    return inputs, run_world(cases.run_cases, 4, (inputs,),
                             timeout_s=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def jax_meshes():
    devices = jax.devices()[:4]
    return (make_mesh(data=2, graph=2, devices=devices),
            make_mesh(data=1, graph=4, devices=devices))


def _assemble(results, case, key, coords, batch_dim_parts, row_parts):
    """The whole (B, R, ...) tensor from each rank's (batch block, row
    block) of it; ranks holding the same block must agree bitwise."""
    blocks = {}
    for r in results:
        dr, gr = r[coords]
        t = r[case][key]
        if (dr, gr) in blocks:
            assert torch.equal(blocks[(dr, gr)], t)
        blocks[(dr, gr)] = t
    rows = [torch.cat([blocks[(dr, gr)] for gr in range(row_parts)], dim=1)
            for dr in range(batch_dim_parts)]
    return torch.cat(rows, dim=0)


def _jax_edges(mesh, case, overlap):
    x = jnp.asarray(case["x"])
    node = NamedSharding(mesh, P("data", "graph", None))
    xs = jax.device_put(x, node)
    if case["y"] is None:
        fn = jax.jit(lambda a: edge_partitioned_knn_mr(
            mesh, a, None, None, k=case["k"], dilation=case["d"],
            overlap=overlap))
        return fn(xs)
    ys = jax.device_put(jnp.asarray(case["y"]), node)
    bs = jax.device_put(jnp.asarray(case["bias"]),
                        NamedSharding(mesh, P("graph", None)))
    fn = jax.jit(lambda a, b, c: edge_partitioned_knn_mr(
        mesh, a, b, c, k=case["k"], dilation=case["d"], overlap=overlap))
    return fn(xs, ys, bs)


def _port_plain_grads(case):
    """The unpartitioned port's gradients of sum(mr^2) (the plain version
    on the CPU)."""
    x = torch.from_numpy(case["x"]).requires_grad_()
    y = None if case["y"] is None \
        else torch.from_numpy(case["y"]).requires_grad_()
    bias = None if case.get("bias") is None \
        else torch.from_numpy(case["bias"])
    _, mr = knn_mr_fused(x, x if y is None else y, bias, case["k"],
                         case["d"])
    mr.square().sum().backward()
    return x.grad, None if y is None else y.grad


@pytest.mark.parametrize("name,overlap", [
    ("gather_bias", False), ("ring_bias", True),
    ("gather_self", False), ("ring_self", True)])
def test_edge_partitioned_matches_jax(world, jax_meshes, name, overlap):
    """Both schedules, with and without a bias (self-kNN without): idx
    equal to the JAX package's partitioned build, mr within 1e-5
    (tests/test_parallel.py's tolerances), and the gradients of
    sum(mr^2) assembled over the shards within 1e-5 of the unpartitioned
    port's (the reduce-scatter adds the shards' target gradients in
    another order)."""
    inputs, results = world
    case = inputs["bias_case" if "bias" in name else "self_case"]
    mesh = jax_meshes[1] if overlap else jax_meshes[0]
    coords, parts = ("m14", (1, 4)) if overlap else ("m22", (2, 2))
    j_idx, j_mr = _jax_edges(mesh, case, overlap)
    idx = _assemble(results, name, "idx", coords, *parts)
    mr = _assemble(results, name, "mr", coords, *parts)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(mr.numpy(), np.asarray(j_mr), atol=1e-5,
                               rtol=1e-5)
    gx_ref, gy_ref = _port_plain_grads(case)
    gx = _assemble(results, name, "gx", coords, *parts)
    np.testing.assert_allclose(gx.numpy(), gx_ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    if gy_ref is not None:
        gy = _assemble(results, name, "gy", coords, *parts)
        np.testing.assert_allclose(gy.numpy(), gy_ref.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("name,case", [("whole_bias", "bias_case"),
                                       ("whole_self", "self_case")])
def test_replicated_targets_is_the_gather_schedule(world, name, case):
    """The graph convs' gather schedule on the (data 2, graph 2) world,
    each rank's block of the queries against the whole targets it holds:
    idx and mr bitwise the gather schedule's on the same blocks (the same
    call on the same rows); the gradients of sum(mr^2) for the whole x and
    y, the same on every graph rank, within 1e-5 of the unpartitioned
    port's (the ranks' target gradients are summed in another order)."""
    inputs, results = world
    gather = name.replace("whole", "gather")
    for key in ("idx", "mr"):
        assert torch.equal(_assemble(results, name, key, "m22", 2, 2),
                           _assemble(results, gather, key, "m22", 2, 2))
    gx_ref, gy_ref = _port_plain_grads(inputs[case])
    for key, ref in (("gx", gx_ref), ("gy", gy_ref)):
        if ref is None:
            continue
        got = _assemble(results, name, key, "m22", 2, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_label_sharded_knn_mr_bitwise(world, jax_meshes):
    """The label build with the targets split over graph 2 (data 2): idx
    and mr bitwise the JAX package's label-sharded build, every graph rank
    the same, and bitwise the port's replicated build."""
    inputs, results = world
    case = inputs["label_case"]
    mesh = jax_meshes[0]
    xs = jax.device_put(jnp.asarray(case["x"]),
                        NamedSharding(mesh, P("data", None, None)))
    ys = jax.device_put(jnp.asarray(case["y"]),
                        NamedSharding(mesh, P("data", "graph", None)))
    j_idx, j_mr = jax.jit(lambda a, b: label_sharded_knn_mr(
        mesh, a, b, k=case["k"]))(xs, ys)
    idx = _assemble(results, "label", "idx", "m22", 2, 1)
    mr = _assemble(results, "label", "mr", "m22", 2, 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(mr.numpy(), np.asarray(j_mr))
    for r in results:
        assert torch.equal(r["label"]["idx"], r["label"]["replicated_idx"])
        assert torch.equal(r["label"]["mr"], r["label"]["replicated_mr"])


def test_label_sharded_knn_mr_grad(world):
    """Gradients of sum(mr^2) through the owner-side fetch and its sum:
    against ``jax.grad`` of the unsharded JAX build within 1e-5
    (tests/test_parallel.py's tolerance)."""
    from gkgnet_tpu.ops.aggregate import max_relative
    from gkgnet_tpu.ops.knn import knn_graph

    inputs, results = world
    case = inputs["label_grad_case"]
    k = case["k"]

    def loss_ref(x_, y_):
        idx = knn_graph(x_, y_, k=k)
        return jnp.sum(max_relative(x_, idx, y_) ** 2)

    gx_r, gy_r = jax.grad(loss_ref, argnums=(0, 1))(
        jnp.asarray(case["x"]), jnp.asarray(case["y"]))
    gx = _assemble(results, "label_grad", "gx", "m22", 2, 1)
    gy = _assemble(results, "label_grad", "gy", "m22", 2, 2)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_r), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(gy_r), atol=1e-5,
                               rtol=1e-5)


def _jax_build_grads(case: dict, dtype=jnp.float32, idx=None) -> tuple:
    """``jax.grad`` of sum(mr^2) (taken in fp32) through the JAX package's
    unsharded build (``knn_graph`` + ``dilate_edges`` + ``max_relative``)
    on the case's inputs in ``dtype``: the partitioned builds' contract.
    With ``idx`` the graph is that one (the build gets no gradient)."""
    from gkgnet_tpu.ops.aggregate import max_relative
    from gkgnet_tpu.ops.knn import dilate_edges, knn_graph

    k, d = case["k"], case.get("d", 1)
    bias = None if case.get("bias") is None else jnp.asarray(case["bias"])

    def loss_ref(x_, y_):
        edges = idx if idx is not None else dilate_edges(
            knn_graph(x_, y_, k=k * d, bias=bias), dilation=d)
        mr = max_relative(x_, edges, y_).astype(jnp.float32)
        return jnp.sum(mr ** 2)

    return jax.grad(loss_ref, argnums=(0, 1))(
        jnp.asarray(case["x"]).astype(dtype),
        jnp.asarray(case["y"]).astype(dtype))


def test_ring_gradients_match_jax(world):
    """The ring's gradients of sum(mr^2) (graph 4, with the bias; y's
    through the ordered-sum gather backward of its max-relative) against
    ``jax.grad`` of the unsharded JAX build within 1e-5, the label build's
    tolerance below."""
    inputs, results = world
    gx_r, gy_r = _jax_build_grads(inputs["bias_case"])
    gx = _assemble(results, "ring_bias", "gx", "m14", 1, 4)
    gy = _assemble(results, "ring_bias", "gy", "m14", 1, 4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_r), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(gy_r), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name,case,coords,parts", [
    ("label_grad_bf16", "label_grad_case", "m22", (2, 2)),
    ("ring_bf16", "bias_case", "m14", (1, 4))])
def test_partitioned_y_gradients_in_bf16_match_jax(world, name, case,
                                                   coords, parts):
    """y's bf16 gradients of sum(mr^2) through the label-sharded build (its
    owner-side fetch) and the ring (its max-relative), both through the
    ordered-sum gather backward on bf16 rows, assembled over the shards,
    against ``jax.grad`` of the JAX package's bf16 max-relative on the same
    inputs and the port's graph (bf16 distances may rank near-ties
    otherwise than the JAX build's). The edges' gradients agree (each
    rel_j rounded to bf16, the tie sets and the split g / cnt alike); the
    JAX scatter-add rounds each of a target's few adds to bf16 (2**-9 of
    the running sum apiece) where the port rounds its fp32 sum once:
    2**-6 of the largest |gy|."""
    inputs, results = world
    idx = _assemble(results, name, "idx", coords, parts[0], 1 if
                    name.startswith("label") else parts[1])
    _, gy_r = _jax_build_grads(inputs[case], jnp.bfloat16,
                               jnp.asarray(idx.numpy()))
    gy = _assemble(results, name, "gy", coords, *parts).float()
    ref = np.asarray(gy_r.astype(jnp.float32))
    np.testing.assert_allclose(gy.numpy(), ref, rtol=2 ** -6,
                               atol=2 ** -6 * np.abs(ref).max())


def test_batchnorm_over_data_group_is_global_bn(world):
    """The data-group BatchNorm (4 ranks of 4 rows) against the JAX
    package's BatchNorm over the global 16 rows: out 1e-5, running mean
    1e-6, running var rtol 1e-4 (tests/test_parallel.py's tolerances); and
    its backward against the one-process BatchNorm's on the global rows
    (the all-reduce's backward): the gradients of sum(out * w) for x within
    1e-5, and for the weight and bias, summed over the ranks, within 1e-5
    relative."""
    inputs, results = world
    x, w = inputs["bn_x"], inputs["bn_w"]
    bn = JaxBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        use_running_average=False)
    want, stats = bn.apply(variables, jnp.asarray(x),
                           use_running_average=False,
                           mutable=["batch_stats"])
    got = torch.cat([r["batchnorm"]["out"] for r in results])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for r in results:
        np.testing.assert_allclose(
            r["batchnorm"]["mean"].numpy(),
            np.asarray(stats["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(
            r["batchnorm"]["var"].numpy(),
            np.asarray(stats["batch_stats"]["var"]), rtol=1e-4)
    one = tlayers.BatchNorm(x.shape[-1]).train()
    xt = torch.from_numpy(x).requires_grad_()
    (one(xt) * torch.from_numpy(w)).sum().backward()
    gx = torch.cat([r["batchnorm"]["gx"] for r in results])
    np.testing.assert_allclose(gx.numpy(), xt.grad.numpy(), atol=1e-5,
                               rtol=1e-5)
    for key, ref in (("gweight", one.weight.grad), ("gbias", one.bias.grad)):
        total = sum(r["batchnorm"][key] for r in results)
        np.testing.assert_allclose(total.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("overlap", [False, True])
def test_model_forward_matches_jax_under_graph_sharding(world, jax_meshes,
                                                        overlap):
    """The t@128 eval forward on the (data 2, graph 2) world against the
    JAX forward under ``graph_sharding`` on its 2 x 2 mesh, same weights:
    atol 2e-4, rtol 2e-3 (tests/test_parallel.py's tolerances); the graph
    ranks of a data rank agree bitwise."""
    inputs, results = world
    mesh = jax_meshes[0]
    model = JaxClassifier(**cases.SMALL)
    v = jax.device_put(
        jax.tree.map(jnp.asarray, inputs["variables"]),
        NamedSharding(mesh, P()))
    xs = jax.device_put(jnp.asarray(inputs["img"]),
                        NamedSharding(mesh, P("data")))
    with graph_sharding(mesh, overlap=overlap):
        (want, _), _ = jax.jit(lambda vv, xx: model.apply(
            vv, xx, train=False, mutable=["constants"]))(v, xs)
    by_rank = {r["m22"]: r[f"forward_{overlap}"] for r in results}
    for dr in range(2):
        assert torch.equal(by_rank[(dr, 0)], by_rank[(dr, 1)])
    got = torch.cat([by_rank[(0, 0)], by_rank[(1, 0)]])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-3)


def _one_rank_step(inputs, moments_parts: int):
    """The port's one-rank train step on the same weights and global batch
    of 4 (no mesh); with ``moments_parts`` > 1 its BatchNorm moments are
    summed in that many data ranks' blocks, as the data group sums them."""
    state, step = cases.train_setup(inputs["variables"])
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    own = tlayers.BatchNorm._moments
    if moments_parts > 1:
        tlayers.BatchNorm._moments = cases.split_moments(moments_parts)
    try:
        state, logs = step(state, batch, 7)
    finally:
        tlayers.BatchNorm._moments = own
    return ({k: float(v) for k, v in logs.items()},
            {k: v.clone() for k, v in state.model.state_dict().items()},
            {k: p.grad.clone() for k, p in state.model.named_parameters()})


def _assert_leafwise(got: dict, ref: dict, rel: float) -> None:
    """Every leaf of got within ``rel`` of the largest |value| of its leaf
    in ref; a leaf whose largest |value| is below ``rel`` of the model's
    largest holds only rounding noise (a conv bias before a BatchNorm: its
    exact gradient is 0) and is held within ``rel`` of the model's
    largest."""
    assert set(got) == set(ref)
    top = max(g.abs().max().item() for g in ref.values())
    for key, g in ref.items():
        scale = g.abs().max().item()
        if scale < rel * top:
            scale = top
        err = (got[key] - g).abs().max().item()
        assert err <= rel * scale, (key, err, scale)


@pytest.mark.parametrize("mesh,parts", [("m14", 1), ("m22", 2)])
def test_partitioned_train_step_matches_one_rank_step(world, mesh, parts):
    """One step on the (data 1, graph 4) and the (data 2, graph 2) worlds
    against the one-rank step on the same weights and global batch
    (drop_path 0; the draws are test_drop_path_draws_for_the_global_batch's).
    Against the 2 x 2 world the one-rank step sums its BatchNorm moments in
    the two data ranks' blocks (``split_moments``): a moment that rounds
    otherwise moves a kNN distance by an ulp, which flips near-ties and
    moves this random model's loss by percents, so the check holds the
    step to the reference that differs from it in no rounding but the
    graph convs' and the gradients' sums. Every rank's state is bitwise the
    same; the logged losses and the pre-clip gradient norm within 1e-5
    relative; every parameter within 2 lr + 1e-6 of its leaf's largest
    |p| (Adam's first update is +-lr on every element, and on a leaf whose
    exact gradient is 0 -- a conv bias before a BatchNorm -- its sign is
    the rounding noise's); the BatchNorm running statistics within 1e-4
    of each leaf's largest value, with a floor of 1e-6 (test_torch_train's
    bound for the same statistics)."""
    inputs, results = world
    logs0, state0, _ = _one_rank_step(inputs, parts)
    key_ = f"train_{mesh}"
    for r in results[1:]:
        for key, value in results[0][key_]["state"].items():
            assert torch.equal(value, r[key_]["state"][key]), key
    logs, state = results[0][key_]["logs"], results[0][key_]["state"]
    for key in ("bce_loss", "asy_loss", "loss", "grad_norm"):
        np.testing.assert_allclose(logs[key], logs0[key], rtol=1e-5,
                                   err_msg=key)
    lr = logs0["lr"]
    for key, value in state0.items():
        if key.endswith(("running_mean", "running_var")):
            bound = max(1e-4 * value.abs().max().item(), 1e-6)
        elif value.is_floating_point():
            bound = 2 * lr + 1e-6 * value.abs().max().item()
        else:
            bound = 0.0
        err = (state[key].float() - value.float()).abs().max().item()
        assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("mesh,parts", [("m14", 1), ("m22", 2)])
def test_partitioned_train_step_reduces_the_one_rank_gradients(world, mesh,
                                                                parts):
    """The gradients each rank's optimizer stepped with (after the data
    axis's mean and the clip) against the one-rank step's, per leaf, within
    1e-4 of the leaf's largest |g| (the graph-only gradients' bound,
    test_graph_ranks_hold_the_one_rank_gradients), every rank's bitwise the
    same: the data mean is held leaf by leaf, not only through the global
    norm. The reference is that of test_partitioned_train_step_matches_one_
    rank_step (moments summed by data rank on the 2 x 2 world)."""
    inputs, results = world
    _, _, grads0 = _one_rank_step(inputs, parts)
    key_ = f"train_{mesh}"
    for r in results[1:]:
        for key, g in results[0][key_]["grads"].items():
            assert torch.equal(g, r[key_]["grads"][key]), key
    _assert_leafwise(results[0][key_]["grads"], grads0, 1e-4)


def test_graph_ranks_hold_the_one_rank_gradients(world):
    """After the backward on a (data 1, graph 4) world every rank holds the
    same gradients bitwise, and they are the one-rank backward's within
    1e-4 of each leaf's largest |g| (the graph convs' target gradients are
    summed over the ranks in another order, and the difference is carried
    back through the network: measured up to 1.5e-5). A leaf whose largest
    |g| is below 1e-4 of the model's largest holds only rounding noise (a
    conv bias before a BatchNorm: its exact gradient is 0) and is held
    within 1e-4 of the model's largest (measured 1.2e-6). On the (data 2,
    graph 2) world the graph ranks of each data rank agree bitwise."""
    inputs, results = world
    model = cases._model(inputs["variables"]).train()
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    score, _ = model(batch["img"], generator=torch.Generator().manual_seed(7))
    losses = model.build_loss_head().loss(score, batch["gt_label"])
    sum(v.mean() for v in losses.values()).backward()
    ref = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
    for r in results:
        assert set(r["grads_graph"]) == set(ref)
        for key, g in r["grads_graph"].items():
            assert torch.equal(g, results[0]["grads_graph"][key]), key
    _assert_leafwise(results[0]["grads_graph"], ref, 1e-4)
    by_rank = {r["m22"]: r["grads_m22"] for r in results}
    for dr in range(2):
        for key, g in by_rank[(dr, 0)].items():
            assert torch.equal(g, by_rank[(dr, 1)][key]), key


def test_bfloat16_collectives(world):
    """On a (data 1, graph 4) world, bfloat16 tensors through gloo (as
    bytes): the all-gather is the ranks' tensors concatenated bitwise, the
    all-reduce their fp32 sum rounded once, a ring step hands each rank
    its predecessor's tensor, a broadcast rank 0's."""
    _, results = world
    by_rank = {r["m14"][1]: r["bf16"] for r in results}
    mine = [by_rank[g]["mine"] for g in range(4)]
    total = sum(m.float() for m in mine).bfloat16()
    for g, r in by_rank.items():
        assert r["gathered"].dtype == torch.bfloat16
        assert torch.equal(r["gathered"], torch.cat(mine, dim=1))
        assert torch.equal(r["summed"], total)
        assert torch.equal(r["ring"], mine[(g - 1) % 4])
        assert torch.equal(r["broadcast"], mine[0])


def test_sync_processes_lines_the_ranks_up(world):
    """Every rank passed the monitored barrier at the end of its cases."""
    _, results = world
    assert [r.get("synced") for r in results] == [True] * 4


def test_drop_path_draws_for_the_global_batch():
    """Under a data axis DropPath draws its mask for the global batch from
    the generator and each rank keeps its rows: the ranks' outputs stacked
    are the one-rank output on the global batch, bitwise."""
    dp = tlayers.DropPath(0.5).train()
    x = torch.randn((8, 3, 4), generator=torch.Generator().manual_seed(0))
    want = dp(x, torch.Generator().manual_seed(1))
    got = []
    for rank in range(4):
        mesh = Mesh(world=4, rank=rank, data=4, graph=1, data_rank=rank,
                    graph_rank=0, data_group=None, graph_group=None,
                    graph_ranks=(rank,), device=torch.device("cpu"),
                    backend=None)
        with tsharding.graph_sharding(mesh):
            got.append(dp(x[2 * rank:2 * rank + 2],
                          torch.Generator().manual_seed(1)))
    assert torch.equal(torch.cat(got), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_normalize_on_the_cpu_is_the_plain_fused_build(dtype):
    """On a CPU tensor the ring's and the label build's row normalization
    is the one of knn_mr_fused's plain version (``l2_normalize``), bitwise,
    rows of zeros included (on the card it is the kernel's own,
    tests/test_torch_cuda.py)."""
    from gkgnet_tpu_torch.ops.knn import l2_normalize

    x = torch.randn((4, 3, 200), generator=torch.Generator().manual_seed(0))
    x[0, 0] = 0.0
    x = x.to(dtype)
    assert torch.equal(tep.knn_normalize(x), l2_normalize(x))


def test_train_step_takes_deterministic_convs_under_a_graph_axis(world):
    """Under a graph axis above 1 the train step's forward and backward run
    with cuDNN's deterministic algorithms (the graph ranks' replicated
    layers must give the same gradients), and the flag is restored after;
    without one the flag is left as it is."""
    from gkgnet_tpu_torch.core import trainer

    _, results = world
    for r in results:
        for key in ("train_m22", "train_m14"):
            seen, after = r[key]["deterministic"]
            assert seen == [True] and after is False, (key, seen, after)
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    try:
        cudnn.deterministic = False
        with trainer._deterministic_convs(True):
            assert cudnn.deterministic
        assert not cudnn.deterministic
        with trainer._deterministic_convs(False):
            assert not cudnn.deterministic
        cudnn.deterministic = True
        with trainer._deterministic_convs(False):
            assert cudnn.deterministic
        assert cudnn.deterministic
    finally:
        cudnn.deterministic = before
