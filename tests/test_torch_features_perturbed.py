"""Parity of the port's perturbed top-k graph build with the JAX package,
on the CPU, in fp32: the hard top-k indicator, the perturbed top-k on
JAX's noise, the soft kNN gather, a perturbed graph conv and the
perturbed classifier at t@128. Split from ``test_torch_features.py`` so
that its CPU time spreads over test workers; each test states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.nn import grapher as jgrapher
from gkgnet_tpu.nn.classifier import GKGNetClassifier as JaxClassifier
from gkgnet_tpu.ops import perturbed_topk as jpt
from gkgnet_tpu_torch.nn import grapher as tgrapher
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier
from gkgnet_tpu_torch.ops import perturbed_topk as tpt
from gkgnet_tpu_torch.utils.weights import (load_jax_variables,
                                            state_dict_from_jax)
from test_torch_model import _jax_variables, _load_subtree, _t

SMALL = dict(arch="t", k=2, k_label_gcn=2, n_classes=6, size=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU work on one thread: the suite runs several test files at
    once on the host's cores, and beside them a run on every core's thread
    spends most of its time waiting for the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(a):
    return np.asarray(a, dtype=np.float32)


# --------------------------------------------------------- perturbed top-k


def test_hard_topk_indicator_matches_jax():
    """The eval indicator, exact: distinct scores and exact ties (the lower
    index first among equal scores)."""
    x = np.random.default_rng(0).standard_normal((3, 5, 12)).astype(
        np.float32)
    x[0, 0, [2, 7, 9]] = 5.0
    got = tpt.hard_topk_indicator(_t(x), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jpt.hard_topk_indicator(
                                      jnp.asarray(x), 2)))


def test_perturbed_topk_matches_jax_on_its_noise():
    """The forward on JAX's own noise draw, exact (whole counts / nS), and
    ``jax.grad`` of a weighted sum against the port's autograd, within
    1e-5 (sums over the samples in another order)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 10)).astype(np.float32)
    g = rng.standard_normal((3, 4, 3, 10)).astype(np.float32)
    k, ns, sigma = 3, 40, 0.3
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (ns,) + x.shape, jnp.float32))
    ref = jpt.perturbed_topk(jnp.asarray(x), k, ns, sigma, key)
    ref_grad = jax.grad(lambda v: jnp.sum(
        jpt.perturbed_topk(v, k, ns, sigma, key) * jnp.asarray(g)))(
            jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    got = tpt.perturbed_topk_from_noise(tx, k, _t(noise), sigma)
    np.testing.assert_array_equal(got.detach().numpy(), _np(ref))
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(ref_grad), rtol=1e-5,
                               atol=1e-5)
    # a generator's draw: the same function of its own noise
    gen = torch.Generator().manual_seed(3)
    drawn = tpt.perturbed_topk(_t(x), k, ns, sigma, gen)
    noise2 = torch.randn((ns,) + x.shape,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(drawn, tpt.perturbed_topk_from_noise(
        _t(x), k, noise2, sigma))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_soft_knn_gather_matches_jax(training):
    """The soft neighbours of normalized targets (dilation 2), in eval (the
    hard top-k) and in training on JAX's noise, fp32, within 1e-6, and
    the gradient to the targets within 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5)).astype(np.float32)
    y = rng.standard_normal((2, 14, 5)).astype(np.float32)
    k, dil, ns, sigma = 3, 2, 20, 0.1
    key = jax.random.PRNGKey(5)

    def jfun(yy):
        return jpt.soft_knn_gather(jnp.asarray(x), yy, k, num_samples=ns,
                                   sigma=sigma, dilation=dil,
                                   rng=key if training else None,
                                   training=training)
    ref = jfun(jnp.asarray(y))
    ref_grad = jax.grad(lambda yy: jnp.sum(jfun(yy) ** 2))(jnp.asarray(y))
    noise = None
    if training:
        noise = _t(np.asarray(jax.random.normal(key, (ns, 2, 6, 14),
                                                jnp.float32)))
    ty = _t(y).requires_grad_(True)
    got = tpt.soft_knn_gather(_t(x), ty, k, num_samples=ns, sigma=sigma,
                              dilation=dil, training=training, noise=noise)
    assert got.shape == (2, 6, k, 5)
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=1e-6,
                               atol=1e-6)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), _np(ref_grad), rtol=1e-5,
                               atol=1e-5)


class _JaxNoise:
    """Record the scores and the noise of every ``perturbed_topk`` call of
    the JAX package (run eagerly), then hand them, call by call, to the
    port's: the port's scores must agree with JAX's within 1e-5, and the
    selection then runs on JAX's, so that two perturbed scores an ulp
    apart (the two packages' fp32 distance sums, taken in other orders)
    cannot rank differently. The scores carry no gradient in the model."""

    def __init__(self, monkeypatch):
        self.draws = []
        orig = jpt.perturbed_topk

        def record(x, k, num_samples=500, sigma=0.05, rng=None):
            self.draws.append((np.asarray(x), np.asarray(jax.random.normal(
                rng, (num_samples,) + x.shape, jnp.float32))))
            return orig(x, k, num_samples, sigma, rng)

        def replay(x, k, num_samples=500, sigma=0.05, generator=None):
            scores, noise = self.draws.pop(0)
            assert noise.shape == (num_samples,) + tuple(x.shape)
            np.testing.assert_allclose(x.detach().numpy(), scores,
                                       rtol=1e-5, atol=1e-5)
            return tpt.perturbed_topk_from_noise(_t(scores), k, _t(noise),
                                                 sigma)

        monkeypatch.setattr(jpt, "perturbed_topk", record)
        monkeypatch.setattr(tpt, "perturbed_topk", replay)


def test_perturbed_graph_conv_matches_jax(monkeypatch):
    """A spatial graph conv with the perturbed build (r = 2, 2 groups) in
    eval and in train on JAX's noise, and the input gradient in train, fp32,
    within 1e-4; no edge indices."""
    noise = _JaxNoise(monkeypatch)
    c = 8
    x = np.random.default_rng(0).standard_normal((2, 4, 4, c)).astype(
        np.float32)
    jm = jgrapher.SpatialGraphConv(c, 2 * c, k=3, r=2, num_group=2,
                                   graph_builder="perturbed")
    tm = tgrapher.SpatialGraphConv(c, 2 * c, k=3, r=2, num_group=2,
                                   graph_builder="perturbed")
    variables = _jax_variables(jm, jnp.asarray(x), None, False)
    _load_subtree(tm, variables,
                  ("backbone", "backbone_1_grapher", "graph_conv"),
                  "backbone.backbone.1.0.graph_conv.")
    ref, ref_idx = jm.apply(variables, jnp.asarray(x), None, False)
    with torch.no_grad():
        got, idx = tm.eval()(_t(x), None)
    assert idx is None and ref_idx is None
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4, atol=1e-4)

    def jloss(xin):
        (out, _), _ = jm.apply(variables, xin, None, True,
                               rngs={"perturbed": jax.random.PRNGKey(2)},
                               mutable=["batch_stats"])
        return jnp.sum(out ** 2), out
    (_, ref_out), ref_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    out, _ = tm.train()(tx, None, torch.Generator().manual_seed(0))
    (out ** 2).sum().backward()
    assert not noise.draws
    np.testing.assert_allclose(out.detach().numpy(), _np(ref_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), _np(ref_grad), rtol=1e-3,
                               atol=1e-3)
    with pytest.raises(ValueError):
        tm.train()(_t(x), None, None)
    with pytest.raises(ValueError):
        tgrapher.SpatialGraphConv(c, 2 * c, conv="edge", num_group=1,
                                  graph_builder="perturbed")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_perturbed_classifier_matches_jax(monkeypatch, train):
    """GKGNetClassifier with graph_builder='perturbed' at t@128 on carried
    weights: eval, and train-mode logits on JAX's noise, fp32, within
    1e-4; no edge indices."""
    noise = _JaxNoise(monkeypatch)
    kw = dict(SMALL, graph_builder="perturbed")
    jm = JaxClassifier(**kw)
    x = np.random.default_rng(6).standard_normal((2, 128, 128, 3)).astype(
        np.float32)
    variables = _jax_variables(jm, jnp.asarray(x), False, seed=7)
    tm = GKGNetClassifier(**kw)
    load_jax_variables(tm, variables)
    if train:
        (ref, ref_edge), _ = jm.apply(
            variables, jnp.asarray(x), True,
            rngs={"perturbed": jax.random.PRNGKey(3)},
            mutable=["batch_stats", "constants"])
        with torch.no_grad():
            got, edge = tm.train()(_t(x), torch.Generator().manual_seed(0))
        assert not noise.draws
    else:
        (ref, ref_edge), _ = jm.apply(variables, jnp.asarray(x), False,
                                      mutable=["constants"])
        with torch.no_grad():
            got, edge = tm.eval()(_t(x))
    assert edge is None and ref_edge is None
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4, atol=1e-4)
