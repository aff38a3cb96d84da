"""Parity of the port's fold-aware grouped route and of its kernel-phase tool
with the JAX package, on the CPU.

  * ``knn_mr_grouped_reference`` (the plain version of the group-strided
    CUDA kernel) against the JAX ``knn_mr_fused_grouped`` in interpret
    mode, and autograd through the port's ``knn_mr_fused_grouped`` against
    ``jax.grad`` through the JAX one;
  * the Grapher and GrapherLabel blocks with ``GKGNET_GROUPED=1`` on both
    sides, eval and train, against the JAX blocks with
    ``set_knn_impl("pallas")`` (interpret mode), from one weight tree;
  * each phase's plain version of ``gkgnet_tpu_torch.tools.exp_kernel_phases``
    against the JAX tool's ``make(...)`` kernels in interpret mode, with the
    tool's module constants patched small.

Inputs are made with numpy from a seed and handed to both frameworks. Each
test states its tolerance.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gkgnet_tpu.nn import grapher as jgrapher
from gkgnet_tpu.ops import knn as jknn
from gkgnet_tpu.ops.pallas import knn_mr as jknn_mr
from gkgnet_tpu.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu_torch.nn import grapher as tgrapher
from gkgnet_tpu_torch.ops import knn_mr as tknn_mr
from gkgnet_tpu_torch.ops.aggregate import fold_groups, unfold_groups
from gkgnet_tpu_torch.tools import exp_kernel_phases as tphases
from gkgnet_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ------------------------------------- knn_mr_fused_grouped: the contract

# (b, g, n, m, d, k, dilation, bias, y = x, tile_n): tests/test_pallas.py's
# grouped shape, self-kNN, M >= 1024 (the JAX kernel's foldv selector) and
# dilation 2
_GROUPED = {
    "test_pallas": (2, 2, 48, 32, 6, 4, 1, True, False, 32),
    "self": (2, 2, 40, 40, 6, 5, 2, False, True, 40),
    "foldv": (1, 2, 16, 1100, 8, 3, 2, True, False, 16),
    "dilation2": (2, 2, 40, 48, 6, 3, 2, False, False, 40),
}


def _grouped_inputs(case, seed=11):
    b, g, n, m, d, k, dil, has_bias, self_knn, tile = _GROUPED[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, g * d)).astype(np.float32)
    y = x if self_knn else rng.standard_normal((b, m, g * d)).astype(
        np.float32)
    bias = (rng.standard_normal((n, m)).astype(np.float32) * 0.1
            if has_bias else None)
    return x, y, bias, k, dil, g, tile


@pytest.mark.parametrize("case", list(_GROUPED))
def test_grouped_reference_matches_jax(case):
    """``knn_mr_grouped_reference`` against the JAX ``knn_mr_fused_grouped``
    (interpret mode): idx ``(B, N, g, k)`` bitwise, mr ``(B, N, g*D)``
    within 1e-5 (fp32; the same maxima, distances summed in another order
    decide no tie at these seeds). It is fold -> knn_mr_reference ->
    unfold, bitwise."""
    x, y, bias, k, dil, g, tile = _grouped_inputs(case)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else _t(bias)
    tx = _t(x)
    ty = tx if y is x else _t(y)
    idx, mr = tknn_mr.knn_mr_grouped_reference(tx, ty, tb, k, dil, g)
    b, n = x.shape[:2]
    assert idx.dtype == torch.int32 and idx.shape == (b, n, g, k)
    assert mr.dtype == torch.float32 and mr.shape == x.shape
    j_idx, j_mr = jknn_mr.knn_mr_fused_grouped(
        jnp.asarray(x), jnp.asarray(y), jb, k, dil, g, tile, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(mr.numpy(), np.asarray(j_mr), rtol=1e-5,
                               atol=1e-5)
    f_idx, f_mr = tknn_mr.knn_mr_reference(fold_groups(tx, g),
                                           fold_groups(ty, g), tb, k, dil)
    assert torch.equal(idx, f_idx.reshape(b, g, n, k).permute(0, 2, 1, 3))
    assert torch.equal(mr, unfold_groups(f_mr, g))


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_grouped_autograd_matches_jax_grad(self_knn):
    """torch.autograd through the port's ``knn_mr_fused_grouped`` against
    jax.grad through the JAX one (interpret mode): the same gradients
    within 1e-5 (fp32). With y = x the two parts sum into the one input."""
    b, g, n, m, d, k, dil = 1, 2, 24, 16, 6, 3, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, n, g * d)).astype(np.float32)
    y = x if self_knn else rng.standard_normal((b, m, g * d)).astype(
        np.float32)
    bias = (rng.standard_normal((n, y.shape[1])) * 0.1).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def j_loss(x_, y_):
        _, mr = jknn_mr.knn_mr_fused_grouped(
            x_, x_ if self_knn else y_, jnp.asarray(bias), k, dil, g, 8,
            True)
        return jnp.sum(mr * mr * jnp.asarray(w))

    j_gx, j_gy = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(y))
    tx = _t(x).requires_grad_()
    ty = tx if self_knn else _t(y).requires_grad_()
    idx, mr = tknn_mr.knn_mr_fused_grouped(tx, ty, _t(bias), k, dil, g)
    assert not idx.requires_grad
    (mr * mr * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx),
                               rtol=1e-5, atol=1e-5)
    if not self_knn:
        np.testing.assert_allclose(ty.grad.numpy(), np.asarray(j_gy),
                                   rtol=1e-5, atol=1e-5)


def _grouped_bwd_inputs(dtype, self_knn, seed=12):
    """Unfolded rows with exact ties (target rows 5, 6 and 7 equal, so that
    dilation 2 keeps two of them), the plain grouped forward's idx and an
    output gradient, in ``dtype``."""
    b, g, n, m, d, k, dil = 2, 2, 32, 24, 6, 4, 2
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, g * d)).astype(np.float32)
    y = x.copy() if self_knn else rng.standard_normal(
        (b, m, g * d)).astype(np.float32)
    y[:, 6] = y[:, 7] = y[:, 5]
    if self_knn:
        x = y
    grad = rng.standard_normal(x.shape).astype(np.float32)
    tx = _t(x).to(dtype)
    ty = tx if self_knn else _t(y).to(dtype)
    idx, _ = tknn_mr.knn_mr_grouped_reference(tx, ty, None, k, dil, g)
    return tx, ty, idx, _t(grad).to(dtype), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_grouped_backward_reference_matches_folded(dtype, self_knn):
    """``knn_mr_grouped_backward_reference`` on the unfolded rows, without
    fold copies, bitwise fold -> ``knn_mr_backward_reference`` -> unfold
    (each target's edges summed in the same order), with exact ties."""
    x, y, idx, grad, g = _grouped_bwd_inputs(dtype, self_knn)
    gx, gy = tknn_mr.knn_mr_grouped_backward_reference(x, y, idx, grad, g)
    b, n, _, k = idx.shape
    idxf = idx.permute(0, 2, 1, 3).reshape(b * g, n, k).contiguous()
    fgx, fgy = tknn_mr.knn_mr_backward_reference(
        fold_groups(x, g), fold_groups(y, g), idxf, fold_groups(grad, g))
    assert gx.shape == x.shape and gy.shape == y.shape
    assert torch.equal(gx, unfold_groups(fgx, g))
    assert torch.equal(gy, unfold_groups(fgy, g))
    ge = tknn_mr.edge_gradients_reference(
        fold_groups(x, g), fold_groups(y, g), idxf, fold_groups(grad, g))
    assert ((ge != 0).sum(dim=2) > 1).any(), "the fixture has no tie"


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_grouped_autograd_without_fold_copies_matches_jax_grad(
        monkeypatch, self_knn):
    """torch.autograd through the port's ``knn_mr_fused_grouped`` (fp32,
    exact ties, dilation 2), whose backward takes the unfolded rows as they
    are (fold_groups and unfold_groups raise once the forward has run),
    against jax.grad through the JAX one (interpret mode): the same
    gradients within 1e-5."""
    x, y, idx, _, g = _grouped_bwd_inputs(torch.float32, self_knn, seed=13)
    k, dil = idx.shape[-1], 2
    w = np.random.default_rng(14).standard_normal(x.shape).astype(np.float32)

    def j_loss(x_, y_):
        _, mr = jknn_mr.knn_mr_fused_grouped(
            x_, x_ if self_knn else y_, None, k, dil, g, 8, True)
        return jnp.sum(mr * mr * jnp.asarray(w))

    j_gx, j_gy = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x.numpy()),
                                                  jnp.asarray(y.numpy()))
    tx = x.clone().requires_grad_()
    ty = tx if self_knn else y.clone().requires_grad_()
    got_idx, mr = tknn_mr.knn_mr_fused_grouped(tx, ty, None, k, dil, g)
    assert torch.equal(got_idx, idx)

    def no_copy(*_):
        raise AssertionError("the grouped backward made a fold copy")

    monkeypatch.setattr(tknn_mr, "fold_groups", no_copy)
    monkeypatch.setattr(tknn_mr, "unfold_groups", no_copy)
    (mr * mr * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx),
                               rtol=1e-5, atol=1e-5)
    if not self_knn:
        np.testing.assert_allclose(ty.grad.numpy(), np.asarray(j_gy),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["batched_bias", "groups_split",
                                  "channels", "kd_over_m"])
def test_grouped_rejects_bad_inputs(case):
    """The grouped route takes a shared (N, M) bias only (a batched bias
    raises, as knn_mr.py:669-670 asserts), channels that split into the
    groups, x and y of one width, and k * dilation <= M."""
    x, y = torch.zeros(2, 10, 8), torch.zeros(2, 12, 8)
    bias, k, dil, g = torch.zeros(10, 12), 3, 2, 2
    if case == "batched_bias":
        bias = torch.zeros(4, 10, 12)
    elif case == "groups_split":
        g = 3
    elif case == "channels":
        y = torch.zeros(2, 12, 6)
    else:
        k, dil = 5, 3
    with pytest.raises((ValueError, TypeError)):
        tknn_mr.knn_mr_fused_grouped(x, y, bias, k, dil, g)
    with pytest.raises((ValueError, TypeError)):
        tknn_mr.knn_mr_grouped_reference(x, y, bias, k, dil, g)


def test_grouped_on_cpu_never_launches():
    """On CPU tensors ``knn_mr_fused_grouped`` runs the plain versions (no
    counter moves, the backward's too); the kernel's wrapper raises."""
    x, y, bias, k, dil, g, _ = _grouped_inputs("test_pallas", seed=3)
    tx = _t(x).requires_grad_()
    before = (tknn_mr.launches, tknn_mr.grouped_launches,
              tknn_mr.backward_launches)
    idx, mr = tknn_mr.knn_mr_fused_grouped(tx, _t(y), _t(bias), k, dil, g)
    mr.sum().backward()
    ref_idx, ref_mr = tknn_mr.knn_mr_grouped_reference(_t(x), _t(y),
                                                       _t(bias), k, dil, g)
    assert torch.equal(idx, ref_idx) and torch.equal(mr, ref_mr)
    assert torch.equal(tx.grad, -torch.ones_like(tx))
    with pytest.raises(ValueError, match="CUDA"):
        tknn_mr.launch_grouped(_t(x), _t(y), _t(bias), k, dil, g)
    assert (tknn_mr.launches, tknn_mr.grouped_launches,
            tknn_mr.backward_launches) == before


# ------------------------------ Grapher blocks on the grouped route vs JAX

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


def _port_state_dict(variables, jax_path, torch_prefix):
    """A standalone JAX block's tree as the port block's state_dict, by
    placing it at its path in the full model's tree."""
    def wrap(tree):
        for name in reversed(jax_path):
            tree = {name: tree}
        return tree
    full = state_dict_from_jax({c: wrap(t) for c, t in variables.items()})
    assert all(k.startswith(torch_prefix) for k in full)
    return {k[len(torch_prefix):]: v for k, v in full.items()}


@pytest.fixture
def grouped_route(monkeypatch):
    """``GKGNET_GROUPED=1`` and the JAX package's Pallas kNN (interpret mode
    on the CPU), restored afterwards: other files' tests share the worker.
    Yields the counts of calls that took each side's grouped route."""
    calls = {"jax": 0, "port": 0}
    j_fn = jknn_mr.knn_mr_fused_grouped
    t_fn = tknn_mr.knn_mr_grouped_reference

    def j_spy(*args, **kwargs):
        calls["jax"] += 1
        return j_fn(*args, **kwargs)

    def t_spy(*args, **kwargs):
        calls["port"] += 1
        return t_fn(*args, **kwargs)

    monkeypatch.setenv("GKGNET_GROUPED", "1")
    monkeypatch.setattr(jknn_mr, "knn_mr_fused_grouped", j_spy)
    monkeypatch.setattr(tknn_mr, "knn_mr_grouped_reference", t_spy)
    previous = jknn._KNN_IMPL
    jknn.set_knn_impl("pallas")
    try:
        yield calls
    finally:
        jknn.set_knn_impl(previous)


class _Block:
    """One 'mr' block with 2 channel groups in both frameworks, with the
    same weights and inputs."""

    def __init__(self, kind, r=1):
        rng = np.random.default_rng(17)
        self.kind = kind
        self.x = rng.standard_normal((2, HW, HW, C)).astype(np.float32)
        if kind == "grapher":
            self.rel = get_relative_pos_table(C, HW * HW, r) if r > 1 \
                else None
            self.jm = jgrapher.Grapher(C, K, 1, "mr", "gelu", r=r)
            self.tm = tgrapher.Grapher(C, K, 1, "mr", "gelu", r=r)
            self.args = (self.x, self.rel)
            path, prefix = ("backbone", "backbone_1_grapher"), \
                "backbone.backbone.1.0."
        else:
            self.labels = rng.standard_normal((2, N_LABELS, C)).astype(
                np.float32)
            self.jm = jgrapher.GrapherLabel(C, K, act="gelu")
            self.tm = tgrapher.GrapherLabel(C, K, act="gelu")
            self.args = (self.labels, self.x)
            path, prefix = ("backbone", "gcn_label_0_0"), \
                "backbone.gcn_label.0.0."
        self.path, self.prefix = path, prefix
        shapes = jax.eval_shape(lambda: self.jm.init(
            jax.random.PRNGKey(0), *self._jargs(), False))
        self.variables = {c: _random_tree(shapes[c], rng)
                          for c in ("params", "batch_stats")}
        self.tm.load_state_dict(
            _port_state_dict(self.variables, path, prefix), strict=True)
        out_shape = self.x.shape if kind == "grapher" else self.labels.shape
        self.w = rng.standard_normal(out_shape).astype(np.float32)

    def _jargs(self):
        return [None if a is None else jnp.asarray(a) for a in self.args]

    def jax_apply(self, params, train):
        """(out, folded edge idx, BN statistics or None)."""
        out, state = self.jm.apply(
            {"params": params,
             "batch_stats": self.variables["batch_stats"]},
            *self._jargs(), train, capture_intermediates=True,
            mutable=["batch_stats", "intermediates"])
        _, idx = state["intermediates"]["graph_conv"]["__call__"][0]
        out = out[0] if self.kind == "label" else out
        return out, idx, state["batch_stats"] if train else None

    def port_apply(self, train):
        """(out, folded edge idx) of the port's block."""
        edges = []
        hook = self.tm.graph_conv.register_forward_hook(
            lambda mod, args, out: edges.append(out[1]))
        try:
            self.tm.train(train)
            args = [None if a is None else _t(a) for a in self.args]
            out = self.tm(*args, torch.Generator().manual_seed(3))
        finally:
            hook.remove()
        return (out[0] if self.kind == "label" else out), edges[0]


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))),
                                                  1e-30)


_BLOCKS = [("grapher", 1), ("grapher", 2), ("label", 1)]
_IDS = ["grapher_r1", "grapher_r2_bias", "label"]


@pytest.mark.parametrize("kind,r", _BLOCKS, ids=_IDS)
def test_grouped_block_eval_matches_jax(grouped_route, kind, r):
    """Eval mode, both sides on the grouped route (asserted): the folded
    edge idx ``(B*g, N, k)`` bitwise, the output within 1e-4 (the
    tolerance of tests/test_torch_model.py's Grapher tests: fp32 sums in
    another order through three convs)."""
    block = _Block(kind, r)
    grouped_route.update(jax=0, port=0)  # the JAX init traced it too
    ref, ref_idx, _ = block.jax_apply(block.variables["params"], False)
    with torch.no_grad():
        got, idx = block.port_apply(False)
    assert grouped_route == {"jax": 1, "port": 1}
    assert idx.shape == (2 * 2, *ref_idx.shape[1:]) == ref_idx.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind,r", _BLOCKS, ids=_IDS)
def test_grouped_block_train_matches_jax(grouped_route, kind, r):
    """Train mode (batch statistics), both sides on the grouped route: the
    edge idx bitwise; the output, the updated BN running statistics and the
    gradient of sum(out * w) in every parameter against jax.grad, each
    within 1e-4 of the leaf's largest |value| (the tolerance of
    tests/test_torch_graph.py's train tests; a leaf that is zero in exact
    arithmetic, a bias before a train-mode BN, holds only rounding noise on
    both sides and must stay under 1e-5 of the block's largest gradient)."""
    block = _Block(kind, r)
    grouped_route.update(jax=0, port=0)  # the JAX init traced it too
    params = block.variables["params"]

    def j_loss(p):
        out, idx, stats = block.jax_apply(p, True)
        return jnp.sum(out * jnp.asarray(block.w)), (out, idx, stats)

    grads, (ref, ref_idx, stats) = jax.grad(j_loss, has_aux=True)(params)
    got, idx = block.port_apply(True)
    (got * _t(block.w)).sum().backward()
    assert grouped_route == {"jax": 1, "port": 1}
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert _rel_err(got.detach().numpy(), np.asarray(ref)) <= 1e-4
    sd = block.tm.state_dict()
    ref_stats = _port_state_dict({"batch_stats": stats}, block.path,
                                 block.prefix)
    assert ref_stats
    for key, value in ref_stats.items():
        assert _rel_err(sd[key].numpy(), value.numpy()) <= 1e-4, key
    ref_grads = _port_state_dict({"params": grads}, block.path, block.prefix)
    named = dict(block.tm.named_parameters())
    assert set(ref_grads) == set(named)
    noise = 1e-5 * max(float(g.abs().max()) for g in ref_grads.values())
    for key, g in ref_grads.items():
        scale = float(g.abs().max())
        if scale <= noise:
            assert float(named[key].grad.abs().max()) <= noise, key
            continue
        assert float((named[key].grad - g).abs().max()) <= 1e-4 * scale, key


@pytest.mark.parametrize("kind,r", _BLOCKS, ids=_IDS)
def test_grouped_route_equals_default_route(monkeypatch, kind, r):
    """The port's grouped route against its default (fold + folded kernel)
    route on the same block and inputs, fp32 on the CPU: output, edge idx
    and every parameter's gradient bitwise (fold and unfold are
    permutations; the arithmetic is the same)."""
    block = _Block(kind, r)
    results = []
    for flag in ("0", "1"):
        monkeypatch.setenv("GKGNET_GROUPED", flag)
        block.tm.zero_grad(set_to_none=True)
        got, idx = block.port_apply(True)
        (got * _t(block.w)).sum().backward()
        results.append((got.detach(), idx, [p.grad.clone() for p in
                                            block.tm.parameters()]))
    (a, ia, ga), (b, ib, gb) = results
    assert torch.equal(a, b) and torch.equal(ia, ib)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


# ------------------------------------ exp_kernel_phases against the TPU tool

_SMALL = dict(BG=2, N=16, D=8, M=24, K=3, TILE=8)


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/exp_kernel_phases.py, loaded from its file
    (``tools`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_kernel_phases", os.path.join(REPO, "tools",
                                              "exp_kernel_phases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _phase_inputs(seed=0):
    """Seeded bf16 x (BG, N, D) and y (BG, M, D) at the small geometry, as
    jnp and torch arrays of the same values."""
    rng = np.random.default_rng(seed)
    jx = jnp.asarray(rng.standard_normal(
        (_SMALL["BG"], _SMALL["N"], _SMALL["D"])), jnp.bfloat16)
    jy = jnp.asarray(rng.standard_normal(
        (_SMALL["BG"], _SMALL["M"], _SMALL["D"])), jnp.bfloat16)
    tx, ty = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (jx, jy))
    return jx, jy, tx, ty


@pytest.mark.parametrize("phase", tphases.PHASES)
def test_phase_reference_matches_jax_tool(jax_tool, monkeypatch, phase):
    """Each phase's plain version against the JAX tool's kernel (interpret
    mode, the module constants patched small): dist within twice
    ``dist_bound`` (both are fp32 computations of the same fp64 sums), sel
    -inf on both sides, gfix and selg within twice ``gather_bound`` (the
    same fp32 maxima summed in another order; selg's selection agrees)."""
    for name, value in _SMALL.items():
        monkeypatch.setattr(jax_tool, name, value)
    jx, jy, tx, ty = _phase_inputs()
    kern = {"dist": (jax_tool.k_dist, {}),
            "sel": (jax_tool.k_sel, dict(gather=False, select=True)),
            "gfix": (jax_tool.k_sel, dict(gather=True, select=False)),
            "selg": (jax_tool.k_sel, dict(gather=True, select=True))}[phase]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_tool.make(kern[0], **kern[1])(jx, jy))
    k = _SMALL["K"]
    got = tphases.phase_reference(phase, tx, ty, k)
    assert got.shape == ref.shape == (_SMALL["BG"], _SMALL["N"], 1)
    assert got.dtype == torch.float32
    if phase == "sel":
        assert (ref == -np.inf).all() and (got == -np.inf).all()
        return
    if phase == "dist":
        _, bound = tphases.dist_bound(tx, ty)
    else:
        idx = (tphases.fixed_columns(tx, k) if phase == "gfix" else
               tknn_mr.knn_mr_reference(tx, ty, None, k)[0])
        _, bound = tphases.gather_bound(tx, ty, idx)
    assert (np.abs(got.double().numpy() - ref) <= 2 * bound.numpy()).all()


def test_phase_reference_contract():
    """The checksums' definitions on the port's own plain versions: selg is
    sum(mr in fp32) + sum(idx) of ``knn_mr_reference``'s idx, gfix the same
    on columns 7 .. 6 + k, each within its ``gather_bound`` of the fp64
    sum; dist within ``dist_bound``; sel -inf."""
    _, _, tx, ty = _phase_inputs(seed=1)
    k = _SMALL["K"]
    idx, _ = tknn_mr.knn_mr_reference(tx, ty, None, k)
    for phase, cols in (("selg", idx), ("gfix", tphases.fixed_columns(tx, k))):
        exact, bound = tphases.gather_bound(tx, ty, cols)
        got = tphases.phase_reference(phase, tx, ty, k).double()
        assert ((got - exact).abs() <= bound).all(), phase
    assert tphases.fixed_columns(tx, k)[1, 5].tolist() == [7, 8, 9]
    exact, bound = tphases.dist_bound(tx, ty)
    got = tphases.phase_reference("dist", tx, ty, k).double()
    assert ((got - exact).abs() <= bound).all()
    assert (tphases.phase_reference("sel", tx, ty, k) == -np.inf).all()


@pytest.mark.parametrize("case", ["phase", "gfix_short_m", "k_over_16",
                                  "dtype_mix"])
def test_phase_rejects_bad_inputs(case):
    """An unknown phase, gfix without columns 7 .. 6 + k, k beyond the
    kernel's lists of 16, and mixed types raise; on CPU tensors ``launch``
    raises and counts nothing."""
    x = torch.zeros(2, 16, 8, dtype=torch.bfloat16)
    y = torch.zeros(2, 24, 8, dtype=torch.bfloat16)
    phase, k = "dist", 3
    if case == "phase":
        phase = "gather"
    elif case == "gfix_short_m":
        phase, y = "gfix", y[:, :9]
    elif case == "k_over_16":
        k = 17
    else:
        y = y.float()
    with pytest.raises((ValueError, TypeError)):
        tphases.phase_reference(phase, x, y, k)
    before = tphases.launches
    with pytest.raises((ValueError, TypeError)):
        tphases.launch(phase, x, y, k)
    with pytest.raises(ValueError, match="CUDA"):
        tphases.launch("dist", x, y.to(x.dtype), 3)
    assert tphases.launches == before


def test_phase_tool_imports_no_jax():
    """The port's phase tool (and the grouped route's modules) import no
    JAX and nothing of the JAX package."""
    code = ("import sys, gkgnet_tpu_torch.tools.exp_kernel_phases, "
            "gkgnet_tpu_torch.nn.grapher, gkgnet_tpu_torch.ops.knn_mr; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'gkgnet_tpu')]; print(bad); "
            "sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
