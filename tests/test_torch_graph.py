"""Parity of the port's graph build and aggregators with the JAX package, on
the CPU: ``knn_topk_reference`` (the plain version of the knn_topk CUDA
kernel) against the JAX kernel in interpret mode, the dispatch of
``knn_graph``, stochastic ``dilate_edges``, and the Grapher / GrapherLabel
blocks with the edge, sage, gin and gat aggregators (and 'mr' with
stochastic dilation) against the JAX blocks, in eval and in train mode.

Inputs are made with numpy from a seed and handed to both frameworks;
weights are random numpy trees in the JAX layout, carried into the port by
``gkgnet_tpu_torch.utils.weights``. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.nn import grapher as jgrapher
from gkgnet_tpu.ops import aggregate as jagg
from gkgnet_tpu.ops import knn as jknn
from gkgnet_tpu.ops.pallas.knn_topk import knn_topk as j_knn_topk
from gkgnet_tpu.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu_torch.nn import grapher as tgrapher
from gkgnet_tpu_torch.nn import layers as tlayers
from gkgnet_tpu_torch.ops import aggregate as tagg
from gkgnet_tpu_torch.ops import knn as tknn
from gkgnet_tpu_torch.ops import knn_topk as tknn_topk
from gkgnet_tpu_torch.utils.weights import (init_block_parameters,
                                            jax_leaf_names,
                                            state_dict_from_jax)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU work on one thread: the suite runs several test files at
    once on the host's cores, and beside them a run on every core's thread
    spends most of its time waiting for the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------- knn_topk: the kernel's contract


def _normalized(rng, shape, dtype):
    """Seeded rows, L2-normalized by the JAX package in fp32, then rounded
    to ``dtype``: the same values as a jnp array and as a torch tensor."""
    a = jknn.l2_normalize(jnp.asarray(rng.standard_normal(shape),
                                      jnp.float32))
    j = a.astype(jnp.bfloat16) if dtype == "bf16" else a
    t = _t(np.asarray(j.astype(jnp.float32)))
    return j, (t.to(torch.bfloat16) if dtype == "bf16" else t)


def _ties_case(dtype):
    """tests/test_pallas.py's tie case: three targets equal to every query,
    so the lowest index must win."""
    x = np.ones((1, 8, 4), np.float32)
    y = np.concatenate([np.ones((1, 3, 4)), np.zeros((1, 5, 4))], 1)
    y = y.astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (jnp.asarray(x, jdt), jnp.asarray(y, jdt), _t(x).to(tdt),
            _t(y).to(tdt), None, 3)


def _topk_case(case, dtype):
    """The shapes of tests/test_pallas.py (cross, self-size, tiny odd, bias,
    self-kNN, ties) -> (jx, jy, tx, ty, bias, k)."""
    if case == "ties":
        return _ties_case(dtype)
    rng = np.random.default_rng({"cross": 0, "self_size": 0, "tiny": 0,
                                 "bias": 1, "self": 2}[case])
    bg, n, d, m, k = {"cross": (2, 64, 16, 48, 5),
                      "self_size": (1, 100, 12, 100, 7),
                      "tiny": (4, 33, 8, 20, 4),
                      "bias": (2, 48, 10, 36, 6),
                      "self": (2, 40, 6, 40, 5)}[case]
    jx, tx = _normalized(rng, (bg, n, d), dtype)
    if case == "self":
        jy, ty = jx, tx
    else:
        jy, ty = _normalized(rng, (bg, m, d), dtype)
    bias = (rng.standard_normal((n, m)).astype(np.float32)
            if case == "bias" else None)
    return jx, jy, tx, ty, bias, k


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["cross", "self_size", "tiny", "bias",
                                  "self", "ties"])
def test_knn_topk_reference_matches_jax_kernel(case, dtype):
    """``knn_topk_reference`` against the JAX kernel (interpret mode): idx
    bitwise; with ``return_values`` the distances within 1e-6 (fp32 sums of
    at most 16 products of unit rows taken in another order: a few fp32
    ulps of values below 4)."""
    jx, jy, tx, ty, bias, k = _topk_case(case, dtype)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else _t(bias)
    ref_idx, ref_vals = j_knn_topk(jx, jy, k=k, bias=jb, tile_n=16,
                                   interpret=True, return_values=True)
    idx = tknn.knn_topk_reference(tx, ty, k=k, bias=tb)
    assert idx.dtype == torch.int32 and idx.shape == (*tx.shape[:2], k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    idx_v, vals = tknn.knn_topk_reference(tx, ty, k=k, bias=tb,
                                          return_values=True)
    assert torch.equal(idx_v, idx) and vals.dtype == torch.float32
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals),
                               rtol=0, atol=1e-6)
    if case == "ties":
        assert idx[0, 0].tolist() == [0, 1, 2]


def test_knn_graph_nan_rows_match_jax_xla():
    """One NaN query row and one NaN target row: the port's knn_graph (the
    plain version on the CPU) gives what the JAX XLA knn_graph gives, idx
    bitwise: NaN distances after every number, in column order. The JAX
    kernel's masked argmin instead returns 1 << 30 in every slot of every
    row that holds a NaN distance (knn_topk.py:81-83); the port does not
    follow it there."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, 8, 4)).astype(np.float32)
    y = rng.standard_normal((1, 12, 4)).astype(np.float32)
    x[0, 2] = np.nan
    y[0, 5] = np.nan
    k = 6
    ref = jknn.knn_graph(jnp.asarray(x), jnp.asarray(y), k=k)
    got = tknn.knn_graph(_t(x), _t(y), k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0, 2].tolist() == list(range(k))
    assert not (got[0, [0, 1, 3, 4, 5, 6, 7]] == 5).any()
    xn = jknn.l2_normalize(jnp.asarray(x))
    yn = jknn.l2_normalize(jnp.asarray(y))
    kernel = np.asarray(j_knn_topk(xn, yn, k=k, interpret=True))
    assert (kernel == 1 << 30).all()
    _, vals = tknn.knn_topk_reference(tknn.l2_normalize(_t(x)),
                                      tknn.l2_normalize(_t(y)), k=k,
                                      return_values=True)
    assert torch.isnan(vals[0, 2]).all() and torch.isfinite(vals[0, 0]).all()


@pytest.mark.parametrize("bias_kind", [None, "shared", "batched"])
def test_knn_graph_on_cpu_never_launches(bias_kind):
    """On CPU tensors knn_graph runs the plain version (the counter stays
    0) and equals ``knn_topk_reference`` on the normalized rows; the
    kernel's wrapper itself raises on CPU tensors."""
    rng = np.random.default_rng(14)
    x = _t(rng.standard_normal((2, 20, 6)).astype(np.float32))
    y = _t(rng.standard_normal((2, 30, 6)).astype(np.float32))
    bias = {None: None, "shared": torch.zeros((20, 30)),
            "batched": _t(rng.standard_normal((2, 20, 30)).astype(
                np.float32))}[bias_kind]
    before = tknn_topk.launches
    idx = tknn.knn_graph(x, y, k=5, bias=bias)
    assert tknn_topk.launches == before
    ref = tknn.knn_topk_reference(tknn.l2_normalize(x), tknn.l2_normalize(y),
                                  k=5, bias=bias)
    assert torch.equal(idx, ref)
    with pytest.raises(ValueError, match="CUDA"):
        tknn_topk.launch(x, y, k=5, bias=bias)
    assert tknn_topk.launches == before


@pytest.mark.parametrize("case", ["k_over_m", "bias_shape", "bias_dtype",
                                  "channels"])
def test_knn_topk_rejects_bad_inputs(case):
    x, y = torch.zeros(2, 10, 4), torch.zeros(2, 12, 4)
    bias, k = torch.zeros(10, 12), 3
    if case == "k_over_m":
        k = 13
    elif case == "bias_shape":
        bias = torch.zeros(12, 10)
    elif case == "bias_dtype":
        bias = bias.double()
    else:
        y = torch.zeros(2, 12, 5)
    with pytest.raises((ValueError, TypeError)):
        tknn.knn_topk_reference(x, y, k=k, bias=bias)


# ------------------------------------------------- stochastic dilate_edges


def _edge_ids(bg=2, n=5, kd=12):
    """idx whose entries encode their position: row * kd + slot."""
    return torch.arange(bg * n * kd, dtype=torch.int32).reshape(bg, n, kd)


def test_dilate_edges_stochastic_epsilon_zero_and_eval_are_strided():
    idx = _edge_ids()
    strided = np.asarray(jknn.dilate_edges(jnp.asarray(idx.numpy()),
                                           dilation=3))
    gen = torch.Generator().manual_seed(0)
    for kwargs in (dict(epsilon=0.0, training=True),      # epsilon 0
                   dict(epsilon=1.0, training=False)):    # eval
        got = tknn.dilate_edges(idx, dilation=3, stochastic=True,
                                generator=gen, **kwargs)
        np.testing.assert_array_equal(got.numpy(), strided)
    assert torch.equal(tknn.dilate_edges(idx, dilation=1, stochastic=True,
                                         epsilon=1.0), idx)


@pytest.mark.parametrize("dilation", [1, 3])
def test_dilate_edges_stochastic_epsilon_one_is_one_permutation(dilation):
    """epsilon 1: the first k positions of one random permutation of the
    k*d candidates, the same for every row, from the generator's draws (the
    gate, then the permutation)."""
    kd = 12
    idx = _edge_ids(kd=kd)
    got = tknn.dilate_edges(idx, dilation=dilation, stochastic=True,
                            epsilon=1.0, training=True,
                            generator=torch.Generator().manual_seed(5))
    k = kd // dilation
    assert got.shape == (2, 5, k)
    slots = got % kd
    assert (slots == slots[0, 0]).all()
    assert len(set(slots[0, 0].tolist())) == k
    gen = torch.Generator().manual_seed(5)
    torch.rand((), generator=gen)
    perm = torch.randperm(kd, generator=gen)[:k]
    assert slots[0, 0].tolist() == perm.tolist()
    assert torch.equal(got, idx[..., perm])


def test_dilate_edges_stochastic_training_needs_a_generator():
    with pytest.raises(ValueError, match="generator"):
        tknn.dilate_edges(_edge_ids(), dilation=2, stochastic=True,
                          epsilon=0.2, training=True)


def test_neighbor_aggregates_match_jax():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    y = rng.standard_normal((2, 14, 6)).astype(np.float32)
    idx = rng.integers(0, 14, (2, 9, 4)).astype(np.int32)
    self_idx = rng.integers(0, 9, (2, 9, 4)).astype(np.int32)
    for t_fn, j_fn in ((tagg.sum_neighbors, jagg.sum_neighbors),
                       (tagg.max_neighbors, jagg.max_neighbors)):
        np.testing.assert_allclose(
            t_fn(_t(x), _t(idx), _t(y)).numpy(),
            np.asarray(j_fn(jnp.asarray(x), jnp.asarray(idx),
                            jnp.asarray(y))), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            t_fn(_t(x), _t(self_idx)).numpy(),
            np.asarray(j_fn(jnp.asarray(x), jnp.asarray(self_idx))),
            rtol=1e-6, atol=1e-6)


def test_layers_take_per_edge_tensors():
    """BasicConv (grouped 1x1 conv + BN + act) on a (B, N, k, C) tensor in
    train mode: BN reduces over every leading axis, as flax does; the same
    as running it on the (B*N*k, C) rows."""
    g = torch.Generator().manual_seed(16)
    x = torch.randn((2, 5, 3, 8), generator=g)
    conv = tlayers.BasicConv([8, 12], "gelu", "batch")
    init_block_parameters(conv, torch.Generator().manual_seed(1))
    flat = tlayers.BasicConv([8, 12], "gelu", "batch")
    flat.load_state_dict(conv.state_dict())
    out = conv.train()(x)
    ref = flat.train()(x.reshape(-1, 8)).reshape(2, 5, 3, 12)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(conv[1].running_var, flat[1].running_var,
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------- Grapher blocks against the JAX ones

C, HW, K = 16, 8, 4
N_LABELS = 6


def _random_tree(shapes, rng):
    """Random fp32 leaves for a tree of ShapeDtypeStructs, scaled so that
    activations stay O(1)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(
                np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _wrap(tree, path):
    for name in reversed(path):
        tree = {name: tree}
    return tree


def _port_state_dict(variables, jax_path, torch_prefix):
    """A standalone JAX block's tree as the port block's state_dict, by
    placing it at its path in the full model's tree."""
    full = state_dict_from_jax({c: _wrap(t, jax_path)
                                for c, t in variables.items()})
    assert all(k.startswith(torch_prefix) for k in full)
    return {k[len(torch_prefix):]: v for k, v in full.items()}


class _Case:
    """One block in both frameworks with the same weights and inputs."""

    def __init__(self, kind, conv, r=1, dilation=1, stochastic=False,
                 epsilon=0.0):
        rng = np.random.default_rng(17)
        self.kind = kind
        self.x = rng.standard_normal((2, HW, HW, C)).astype(np.float32)
        self.rel = None
        multi = conv == "mr"
        if kind == "grapher":
            if r > 1:
                self.rel = get_relative_pos_table(C, HW * HW, r)
            self.jm = jgrapher.Grapher(
                C, K, dilation, conv, "gelu", stochastic=stochastic,
                epsilon=epsilon, r=r, use_multi_group=multi)
            self.tm = tgrapher.Grapher(
                C, K, dilation, conv, "gelu", stochastic=stochastic,
                epsilon=epsilon, r=r, use_multi_group=multi)
            self.args = (self.x, self.rel)
            path, prefix = ("backbone", "backbone_1_grapher"), \
                "backbone.backbone.1.0."
        else:
            self.labels = rng.standard_normal((2, N_LABELS, C)).astype(
                np.float32)
            self.jm = jgrapher.GrapherLabel(C, K, conv=conv, act="gelu",
                                            use_multi_group=multi)
            self.tm = tgrapher.GrapherLabel(C, K, conv=conv, act="gelu",
                                            use_multi_group=multi)
            self.args = (self.labels, self.x)
            path, prefix = ("backbone", "gcn_label_0_0"), \
                "backbone.gcn_label.0.0."
        self.path, self.prefix = path, prefix
        jargs = [None if a is None else jnp.asarray(a) for a in self.args]
        shapes = jax.eval_shape(lambda: self.jm.init(
            jax.random.PRNGKey(0), *jargs, False))
        self.variables = {c: _random_tree(shapes[c], rng)
                          for c in ("params", "batch_stats")}
        self.tm.load_state_dict(
            _port_state_dict(self.variables, path, prefix), strict=True)
        self.w = rng.standard_normal(self._out_shape()).astype(np.float32)

    def _out_shape(self):
        return self.x.shape if self.kind == "grapher" else self.labels.shape

    def jax_apply(self, variables, train):
        jargs = [None if a is None else jnp.asarray(a) for a in self.args]
        rngs = {"dilation": jax.random.PRNGKey(3)} if train else None
        if train:
            out, upd = self.jm.apply(variables, *jargs, True,
                                     mutable=["batch_stats"], rngs=rngs)
        else:
            out, upd = self.jm.apply(variables, *jargs, False), None
        return (out[0] if self.kind == "label" else out), upd

    def port_apply(self, train):
        self.tm.train(train)
        args = [None if a is None else _t(a) for a in self.args]
        gen = torch.Generator().manual_seed(3) if train else None
        out = self.tm(*args, gen)
        return out[0] if self.kind == "label" else out


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))),
                                                  1e-30)


_BLOCKS = [("grapher", dict(r=1)), ("grapher", dict(r=2)), ("label", {})]


@pytest.mark.parametrize("conv", ["edge", "sage", "gin", "gat"])
@pytest.mark.parametrize("kind,kwargs", _BLOCKS,
                         ids=["grapher_r1", "grapher_r2_bias", "label"])
def test_aggregator_block_eval_matches_jax(conv, kind, kwargs):
    """Eval mode: the output within 1e-5 x max|out| (fp32; the same sums in
    another order); the graph the non-fused route builds is the plain
    knn_topk's on the CPU."""
    case = _Case(kind, conv, **kwargs)
    ref, _ = case.jax_apply(case.variables, train=False)
    before = tknn_topk.launches
    with torch.no_grad():
        got = case.port_apply(train=False)
    assert tknn_topk.launches == before
    assert got.shape == ref.shape
    assert _rel_err(got.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("conv", ["edge", "sage", "gin", "gat"])
@pytest.mark.parametrize("kind,kwargs", _BLOCKS,
                         ids=["grapher_r1", "grapher_r2_bias", "label"])
def test_aggregator_block_train_matches_jax(conv, kind, kwargs):
    """Train mode (batch statistics): the output, the updated BN running
    statistics and the gradient of sum(out * w) in every parameter against
    jax.grad, each within 1e-4 of the leaf's largest |value|. A gradient
    leaf that is zero in exact arithmetic (a bias before a train-mode BN,
    the attention bias before the softmax) holds only rounding noise on
    both sides, up to ~1e-6 of the block's largest gradient: a leaf whose
    JAX gradient stays under 1e-5 of that largest must stay under it in
    the port too."""
    _check_train(_Case(kind, conv, **kwargs))


def test_stochastic_mr_grapher_matches_jax():
    """'mr' with stochastic dilation in training takes the non-fused route
    (knn_graph, dilate_edges, the plain max-relative) on both sides; with
    epsilon 1e-9 both draws take the strided branch. Train-mode output, BN
    statistics and gradients as in the aggregator train test."""
    _check_train(_Case("grapher", "mr", r=2, dilation=2, stochastic=True,
                       epsilon=1e-9))


def _check_train(case):
    params = case.variables["params"]
    stats = case.variables["batch_stats"]

    def j_loss(p):
        out, upd = case.jax_apply({"params": p, "batch_stats": stats}, True)
        return jnp.sum(out * jnp.asarray(case.w)), (out, upd)

    grads, (ref, upd) = jax.jit(jax.grad(j_loss, has_aux=True))(params)
    before = tknn_topk.launches
    got = case.port_apply(train=True)
    (got * _t(case.w)).sum().backward()
    assert tknn_topk.launches == before
    assert _rel_err(got.detach().numpy(), np.asarray(ref)) <= 1e-4
    sd = case.tm.state_dict()
    ref_stats = _port_state_dict({"batch_stats": upd["batch_stats"]},
                                 case.path, case.prefix)
    assert ref_stats
    for key, value in ref_stats.items():
        assert _rel_err(sd[key].numpy(), value.numpy()) <= 1e-4, key
    ref_grads = _port_state_dict({"params": grads}, case.path, case.prefix)
    named = dict(case.tm.named_parameters())
    assert set(ref_grads) == set(named)
    noise = 1e-5 * max(float(g.abs().max()) for g in ref_grads.values())
    for key, g in ref_grads.items():
        scale = float(g.abs().max())
        if scale <= noise:
            assert float(named[key].grad.abs().max()) <= noise, key
            continue
        err = float((named[key].grad - g).abs().max())
        assert err <= 1e-4 * scale, key


@pytest.mark.parametrize("conv", ["edge", "sage", "gin", "gat"])
@pytest.mark.parametrize("kind", ["grapher", "label"])
def test_aggregator_leaves_map_one_to_one(conv, kind):
    """Every JAX leaf of the block maps to exactly one port key of the same
    shape, and every port parameter and buffer has one; the JAX leaf names
    that decide weight decay come back from the port's modules."""
    case = _Case(kind, conv)
    n_leaves = sum(len(jax.tree_util.tree_leaves(t))
                   for t in case.variables.values())
    sd = _port_state_dict(case.variables, case.path, case.prefix)
    port = case.tm.state_dict()
    assert len(sd) == n_leaves and set(sd) == set(port)
    for key, value in sd.items():
        assert tuple(value.shape) == tuple(port[key].shape), key
    leaves = jax_leaf_names(case.tm)
    gconv = "graph_conv.gconv."
    expect = {"edge": {"nn.0.weight": "kernel"},
              "sage": {"nn1.0.weight": "kernel", "nn2.0.weight": "kernel"},
              "gin": {"eps": "eps", "nn.0.weight": "kernel"},
              "gat": {"a.weight": "kernel", "a.bias": "bias"}}[conv]
    for key, leaf in expect.items():
        assert leaves[gconv + key] == leaf


def test_init_block_parameters_is_seeded():
    """The seeded init of a standalone block: the same seed gives the same
    weights, every conv weight is drawn, gin's eps starts at 0."""
    blocks = [tgrapher.Grapher(C, K, conv="gin", use_multi_group=False)
              for _ in range(2)]
    for b in blocks:
        init_block_parameters(b, torch.Generator().manual_seed(4))
    a, b = (m.state_dict() for m in blocks)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["graph_conv.gconv.eps"].item() == 0.0
    assert a["graph_conv.gconv.nn.0.weight"].abs().sum() > 0
    assert a["fc1.0.weight"].abs().sum() > 0
