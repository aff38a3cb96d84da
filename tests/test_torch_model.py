"""Parity of the PyTorch port's modules with the JAX package, on the CPU, in
fp32: layers, Grapher/GrapherLabel and the full GKGNetClassifier eval
forward at arch t, size 128, k=2. Weights are random numpy trees in the JAX
layout, loaded into the port through ``gkgnet_tpu_torch.utils.weights``;
the JAX side is initialized by shape only (``jax.eval_shape``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.nn import grapher as jgrapher
from gkgnet_tpu.nn import layers as jlayers
from gkgnet_tpu.nn.classifier import GKGNetClassifier as JaxClassifier
from gkgnet_tpu.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu.utils.torch_convert import (convert_reference_checkpoint,
                                            expected_torch_shapes)
from gkgnet_tpu_torch import entry as tentry
from gkgnet_tpu_torch.nn import grapher as tgrapher
from gkgnet_tpu_torch.nn import layers as tlayers
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier
from gkgnet_tpu_torch.utils.weights import (load_jax_variables,
                                            state_dict_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_tree(shapes, rng):
    """Random fp32 leaves for a tree of ShapeDtypeStructs, scaled so that
    activations stay O(1) through the network."""
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


def _jax_variables(module, *args, seed=0):
    """Random variables for ``module.init(key, *args)``, by shape only."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)
    return {c: _random_tree(shapes[c], rng)
            for c in ("params", "batch_stats") if c in shapes}


def _load_subtree(module, variables, jax_path, torch_prefix):
    """Load a standalone JAX module's tree into the matching port module by
    placing it at its path in the full model's tree."""
    def wrap(tree):
        for name in reversed(jax_path):
            tree = {name: tree}
        return tree
    full = state_dict_from_jax({c: wrap(t) for c, t in variables.items()})
    sd = {k[len(torch_prefix):]: v for k, v in full.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("batch", [1, 2])
def test_fold_groups_match_jax(batch):
    x = np.random.default_rng(0).standard_normal((batch, 7, 12)).astype(
        np.float32)
    folded = tgrapher.fold_groups(_t(x), 2)
    assert folded.is_contiguous()   # the kernel takes contiguous rows
    np.testing.assert_array_equal(
        folded.numpy(), np.asarray(jgrapher.fold_groups(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        tgrapher.unfold_groups(folded, 2).numpy(), x)


def test_avg_pool_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        tlayers.avg_pool_nhwc(_t(x), 2).numpy(),
        np.asarray(jlayers.avg_pool_nhwc(jnp.asarray(x), 2)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["ffn", "stem", "downsample"])
def test_layers_match_jax(kind):
    rng = np.random.default_rng(1)
    c = 16
    if kind == "ffn":
        jm = jlayers.FFN(4 * c, c, "gelu")
        tm = tlayers.FFN(c, 4 * c, "gelu")
        x = rng.standard_normal((2, 6, 6, c))
        path, prefix = ("backbone", "backbone_1_ffn"), "backbone.backbone.1.1."
    elif kind == "stem":
        jm = jlayers.Stem(c, "gelu")
        tm = tlayers.Stem(3, c, "gelu")
        x = rng.standard_normal((2, 16, 16, 3))
        path, prefix = ("backbone", "stem"), "backbone.stem."
    else:
        jm = jlayers.Downsample(2 * c)
        tm = tlayers.Downsample(c, 2 * c)
        x = rng.standard_normal((2, 8, 8, c))
        path, prefix = ("backbone", "backbone_2"), "backbone.backbone.2."
    x = x.astype(np.float32)
    variables = _jax_variables(jm, jnp.asarray(x), False)
    ref = jax.jit(lambda v, x: jm.apply(v, x, False))(variables,
                                                      jnp.asarray(x))
    _load_subtree(tm, variables, path, prefix)
    with torch.no_grad():
        got = tm(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r,dilation", [(2, 1), (1, 2)])
def test_grapher_matches_jax(r, dilation):
    c, hw, k = 16, 8, 3
    x = np.random.default_rng(2).standard_normal((2, hw, hw, c)).astype(
        np.float32)
    rel = get_relative_pos_table(c, hw * hw, r)
    jm = jgrapher.Grapher(c, k, dilation, act="gelu", r=r)
    variables = _jax_variables(jm, jnp.asarray(x), jnp.asarray(rel), False)
    ref = jax.jit(lambda v, x: jm.apply(v, x, jnp.asarray(rel), False))(
        variables, jnp.asarray(x))
    tm = _load_subtree(tgrapher.Grapher(c, k, dilation, act="gelu", r=r),
                       variables, ("backbone", "backbone_1_grapher"),
                       "backbone.backbone.1.0.")
    with torch.no_grad():
        got = tm(_t(x), _t(rel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_grapher_label_matches_jax():
    c, hw, k, n_labels = 16, 8, 3, 6
    rng = np.random.default_rng(3)
    labels = rng.standard_normal((2, n_labels, c)).astype(np.float32)
    feats = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    jm = jgrapher.GrapherLabel(c, k, act="gelu")
    variables = _jax_variables(jm, jnp.asarray(labels), jnp.asarray(feats),
                               False)
    ref, ref_idx = jax.jit(lambda v, a, b: jm.apply(v, a, b, False))(
        variables, jnp.asarray(labels), jnp.asarray(feats))
    tm = _load_subtree(tgrapher.GrapherLabel(c, k, act="gelu"), variables,
                       ("backbone", "gcn_label_0_0"),
                       "backbone.gcn_label.0.0.")
    with torch.no_grad():
        got, idx = tm(_t(labels), _t(feats))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["conv", "graph_builder", "stochastic"])
def test_unported_options_raise(case):
    """What the port rejects, as the JAX package does: an unknown
    aggregator, a non-'mr' aggregator with folded groups, the perturbed
    graph builder (not ported), and stochastic dilation in training
    without a generator."""
    if case == "stochastic":
        block = tgrapher.Grapher(16, 3, 2, stochastic=True, epsilon=0.5)
        x = torch.zeros((1, 4, 4, 16))
        with pytest.raises(ValueError, match="generator"):
            block.train()(x, None)
        return
    if case == "conv":
        with pytest.raises(NotImplementedError):
            tgrapher.Grapher(16, 3, 1, conv="gcn", use_multi_group=False)
        with pytest.raises(ValueError):
            tgrapher.Grapher(16, 3, 1, conv="edge", use_multi_group=True)
        return
    with pytest.raises(NotImplementedError):
        tgrapher.Grapher(16, 3, 1, graph_builder="perturbed")


SMALL = dict(arch="t", k=2, k_label_gcn=2, n_classes=6, size=128)


@pytest.fixture(scope="module")
def small_model():
    """The JAX classifier at arch t, size 128, k=2, random weights, and the
    port with the same weights."""
    jm = JaxClassifier(**SMALL)
    x = np.random.default_rng(6).standard_normal((1, 128, 128, 3)).astype(
        np.float32)
    variables = _jax_variables(jm, jnp.asarray(x), False, seed=7)
    tm = GKGNetClassifier(**SMALL)
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval(), x


def test_classifier_matches_jax(small_model):
    jm, variables, tm, x = small_model
    (ref, _), _ = jax.jit(
        lambda v, x: jm.apply(v, x, False, mutable=["constants"]))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tm(_t(x))
    assert got.dtype == torch.float32 and got.shape == (1, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_weights_round_trip_through_reference_converter(small_model):
    """JAX tree -> port -> state_dict -> the JAX package's converter ->
    bitwise the original tree, with every key and shape as the converter
    expects."""
    _, variables, tm, _ = small_model
    sd = tm.state_dict()
    expected = expected_torch_shapes(variables)
    assert set(sd) == set(expected)
    for key, shape in expected.items():
        assert tuple(sd[key].shape) == shape, key
    back = convert_reference_checkpoint(sd, variables)
    for c in ("params", "batch_stats"):
        leaves = jax.tree_util.tree_leaves_with_path(variables[c])
        got = dict(jax.tree_util.tree_leaves_with_path(back[c]))
        assert len(got) == len(leaves)
        for path, leaf in leaves:
            np.testing.assert_array_equal(got[path], leaf)


def test_predict_returns_sigmoid_scores(small_model):
    _, _, tm, x = small_model
    images = _t(np.concatenate([x, -x]))
    scores = tentry.predict(tm, images)
    with torch.no_grad():
        logits, _ = tm(images)
    assert scores.shape == (2, 6)
    assert torch.equal(scores, torch.sigmoid(logits))


def test_entry_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.resolve_device("cuda")
    assert tentry.resolve_device("cpu").type == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys, gkgnet_tpu_torch.entry, gkgnet_tpu_torch.utils.weights,"
            " gkgnet_tpu_torch.core.trainer, gkgnet_tpu_torch.core.optim,"
            " gkgnet_tpu_torch.core.schedules, gkgnet_tpu_torch.nn.losses,"
            " gkgnet_tpu_torch.tools.train, gkgnet_tpu_torch.tools.test,"
            " gkgnet_tpu_torch.tools.make_synthetic_coco,"
            " gkgnet_tpu_torch.data, gkgnet_tpu_torch.native,"
            " gkgnet_tpu_torch.core.checkpoint, gkgnet_tpu_torch.core.metrics,"
            " gkgnet_tpu_torch.core.config, gkgnet_tpu_torch.core.builder;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'gkgnet_tpu')]; print(bad); "
            "sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
