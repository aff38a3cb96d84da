"""Parity of the port's model features with the JAX package, on the CPU, in
fp32: the activations, necks, linear heads, losses, the perturbed top-k
and its graph build, mixup/cutmix, LAMB, the tiled plain kNN build and the
GKGNet flags. Inputs and weights come from numpy seeds; the JAX side runs
its plain (XLA) path. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.core import optim as joptim
from gkgnet_tpu.nn import augment as jaugment
from gkgnet_tpu.nn import grapher as jgrapher
from gkgnet_tpu.nn import heads as jheads
from gkgnet_tpu.nn import layers as jlayers
from gkgnet_tpu.nn import losses as jlosses
from gkgnet_tpu.nn import necks as jnecks
from gkgnet_tpu.nn.classifier import GKGNetClassifier as JaxClassifier
from gkgnet_tpu.nn.gkgnet import GKGNet as JaxGKGNet
from gkgnet_tpu.ops import knn as jknn
from gkgnet_tpu.ops import perturbed_topk as jpt
from gkgnet_tpu.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu_torch.core import optim as toptim
from gkgnet_tpu_torch.nn import augment as taugment
from gkgnet_tpu_torch.nn import grapher as tgrapher
from gkgnet_tpu_torch.nn import heads as theads
from gkgnet_tpu_torch.nn import layers as tlayers
from gkgnet_tpu_torch.nn import losses as tlosses
from gkgnet_tpu_torch.nn import necks as tnecks
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier
from gkgnet_tpu_torch.nn.gkgnet import GKGNet
from gkgnet_tpu_torch.ops import knn as tknn
from gkgnet_tpu_torch.ops import perturbed_topk as tpt
from gkgnet_tpu_torch.utils.weights import (load_jax_variables,
                                            state_dict_from_jax)
from test_torch_model import _jax_variables, _load_subtree, _t

SMALL = dict(arch="t", k=2, k_label_gcn=2, n_classes=6, size=128)


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _load_under(module, variables, top):
    """Load a JAX module's tree placed under ``top`` (``neck`` or
    ``head``) into the port's module of the same place."""
    full = state_dict_from_jax({c: {top: t} for c, t in variables.items()})
    sd = {k[len(top) + 1:]: v for k, v in full.items()}
    module.load_state_dict(sd, strict=True)
    return module


# ----------------------------------------------------------- activations


@pytest.mark.parametrize("act", ["relu", "leakyrelu", "prelu", "gelu",
                                 "hswish"])
def test_activations_match_jax(act):
    """Each activation on values around its kinks (-3, 0, 3), fp32, within
    1e-6; prelu with a slope of 0.37 in both."""
    x = np.random.default_rng(0).uniform(-5, 5, (4, 33)).astype(np.float32)
    x[0, :3] = [-3.0, 0.0, 3.0]
    jm = jlayers.Activation(act)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tlayers.Activation(act)
    if act == "prelu":
        variables = {"params": {"alpha": np.full((1,), 0.37, np.float32)}}
        tm.weight.data.fill_(0.37)
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tlayers.Activation("swish")


@pytest.mark.parametrize("kind,act", [("ffn", "prelu"), ("stem", "prelu"),
                                      ("grapher", "prelu"),
                                      ("grapher", "hswish"),
                                      ("ffn", "leakyrelu")])
def test_blocks_with_activations_load_and_match_jax(kind, act):
    """A block built with the activation, its JAX weights (the prelu
    slopes among them: ``act*/alpha``) carried by the weight loader, in
    eval, within 1e-4."""
    rng = np.random.default_rng(1)
    c = 16
    if kind == "ffn":
        jm, tm = jlayers.FFN(4 * c, c, act), tlayers.FFN(c, 4 * c, act)
        x = rng.standard_normal((2, 6, 6, c))
        args = ()
        path, prefix = ("backbone", "backbone_1_ffn"), "backbone.backbone.1.1."
    elif kind == "stem":
        jm, tm = jlayers.Stem(c, act), tlayers.Stem(3, c, act)
        x = rng.standard_normal((2, 16, 16, 3))
        args = ()
        path, prefix = ("backbone", "stem"), "backbone.stem."
    else:
        jm = jgrapher.Grapher(c, 3, 1, act=act, r=2)
        tm = tgrapher.Grapher(c, 3, 1, act=act, r=2)
        x = rng.standard_normal((2, 8, 8, c))
        args = (jnp.asarray(get_relative_pos_table(c, 64, 2)),)
        path, prefix = ("backbone", "backbone_1_grapher"), \
            "backbone.backbone.1.0."
    x = x.astype(np.float32)
    variables = _jax_variables(jm, jnp.asarray(x), *args, False)
    if act == "prelu":  # slopes other than the initial 0.2
        variables["params"] = jax.tree_util.tree_map_with_path(
            lambda p, v: np.full(v.shape, 0.31, np.float32)
            if p[-1].key == "alpha" else v, variables["params"])
    ref = jm.apply(variables, jnp.asarray(x), *args, False)
    if kind == "grapher":
        ref = ref[0] if isinstance(ref, tuple) else ref
    _load_subtree(tm, variables, path, prefix)
    with torch.no_grad():
        got = tm(_t(x), *[_t(np.asarray(a)) for a in args]) \
            if kind == "grapher" else tm(_t(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4, atol=1e-4)
    if act == "prelu":
        slopes = [m.weight for m in tm.modules()
                  if isinstance(m, tlayers.Activation) and m.act == "prelu"]
        assert slopes and all(float(s) == pytest.approx(0.31) for s in slopes)


# ----------------------------------------------------------------- necks


def _pyramid(seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, s, s, c)).astype(np.float32)
                 for s, c in [(8, 16), (4, 32), (2, 64)])


@pytest.mark.parametrize("cfg", [
    dict(type="HRFuseScales", out_channels=24),
    dict(type="FPN", out_channels=24),
    dict(type="ChannelMapper", out_channels=12),
    dict(type="ChannelMapper", out_channels=12, kernel_size=3),
    dict(type="GlobalAveragePooling"),
], ids=["hrfuse", "fpn", "mapper1", "mapper3", "gap"])
def test_pyramid_necks_match_jax(cfg):
    """Each neck over a 3-level pyramid (8, 4, 2 px; 16, 32, 64 channels)
    with the JAX module's random weights, fp32, within 1e-5: the bilinear
    and nearest upsampling, the SAME-padded convs, the per-level order."""
    xs = _pyramid()
    jm = jnecks.build_neck(cfg)
    jx = tuple(jnp.asarray(x) for x in xs)
    tm = tnecks.build_neck(cfg, [16, 32, 64])
    if cfg["type"] == "GlobalAveragePooling":
        ref = jm.apply({}, jx)
    else:
        variables = _jax_variables(jm, jx)
        ref = jm.apply(variables, jx)
        _load_under(tm, variables, "neck")
    with torch.no_grad():
        got = tm(tuple(_t(x) for x in xs))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)


def test_multilabel_projection_neck_matches_jax():
    """The per-class projection, on a (B, C) and on a (B, H, W, C) input,
    within 1e-5."""
    rng = np.random.default_rng(1)
    jm = jnecks.MultiLabelProjection(num_classes=5, in_channels=16,
                                     proj_channels=8)
    tm = tnecks.build_neck(dict(type="MultiLabelProjection", num_classes=5,
                                in_channels=16, proj_channels=8), [16])
    for shape in ((2, 16), (2, 3, 3, 16)):
        x = rng.standard_normal(shape).astype(np.float32)
        variables = _jax_variables(jm, jnp.asarray(x))
        _load_under(tm, variables, "neck")
        ref = jm.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tm(_t(x))
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError):
        tnecks.build_neck(dict(type="Nope"), [16])


# ----------------------------------------------------------------- heads


@pytest.mark.parametrize("kind", ["linear", "multilabel"])
def test_linear_heads_match_jax(kind):
    """Forward, loss and simple_test of the linear heads, fp32, within 1e-6
    (the multi-label target holds difficult labels, -1)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    if kind == "linear":
        jm = jheads.LinearClsHead(num_classes=7, in_channels=12)
        tm = theads.LinearClsHead(7, 12)
        gt = rng.integers(0, 7, 5)
    else:
        jm = jheads.MultiLabelLinearClsHead(num_classes=7, in_channels=12)
        tm = theads.MultiLabelLinearClsHead(7, 12)
        gt = rng.integers(-1, 2, (5, 7)).astype(np.float32)
    variables = _jax_variables(jm, jnp.asarray(x))
    _load_under(tm, variables, "head")
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    ref_loss = jm.loss(ref, jnp.asarray(gt))
    got_loss = tm.loss(got, torch.from_numpy(gt))
    assert set(got_loss) == set(ref_loss) == {"loss"}
    np.testing.assert_allclose(got_loss["loss"].numpy(),
                               _np(ref_loss["loss"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.simple_test(got).numpy(),
                               _np(jm.simple_test(ref)), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------- losses


def _logits(seed, shape=(6, 9)):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.standard_normal(shape)).astype(np.float32), rng


@pytest.mark.parametrize("case", [
    "soft_ce", "soft_ce_weighted", "ce", "ce_sum", "smooth_classy",
    "smooth_original", "seesaw", "seesaw_p0", "contrastive", "focal",
    "focal_avg", "center", "triplet_euclidean", "triplet_cosine"])
def test_other_losses_match_jax(case):
    """Each of the eight losses, in its reductions and options, fp32,
    within 1e-5 relative (the seesaw powers and the triplet square roots
    round differently by an ulp or two)."""
    pred, rng = _logits(5)
    n, c = pred.shape
    label = rng.integers(0, c, n)
    onehot = np.eye(c, dtype=np.float32)[label]
    soft = rng.random((n, c)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = rng.random(n).astype(np.float32)
    multi = (rng.random((n, c)) < 0.3).astype(np.float32)
    jp, tp = jnp.asarray(pred), _t(pred)
    if case.startswith("soft_ce"):
        w = weight if case.endswith("weighted") else None
        ref = jlosses.soft_cross_entropy(
            jp, jnp.asarray(soft), None if w is None else jnp.asarray(w))
        got = tlosses.soft_cross_entropy(tp, _t(soft),
                                         None if w is None else _t(w))
    elif case.startswith("ce"):
        red = "sum" if case == "ce_sum" else "mean"
        ref = jlosses.cross_entropy(jp, jnp.asarray(label), reduction=red)
        got = tlosses.cross_entropy(tp, torch.from_numpy(label),
                                    reduction=red)
    elif case.startswith("smooth"):
        mode = case.split("_")[1].replace("classy", "classy_vision")
        ref = jlosses.label_smooth_loss(jp, jnp.asarray(onehot), 0.2, mode)
        got = tlosses.label_smooth_loss(tp, _t(onehot), 0.2, mode)
    elif case.startswith("seesaw"):
        cum = rng.integers(1, 500, c).astype(np.float32)
        p = 0.0 if case == "seesaw_p0" else 0.8
        ref = jlosses.seesaw_loss(jp, jnp.asarray(label), jnp.asarray(cum),
                                  p=p)
        got = tlosses.seesaw_loss(tp, torch.from_numpy(label), _t(cum), p=p)
    elif case == "contrastive":
        b = rng.standard_normal(pred.shape).astype(np.float32)
        ref = jlosses.contrastive_loss(jp, jnp.asarray(b))
        got = tlosses.contrastive_loss(tp, _t(b))
    elif case.startswith("focal"):
        kw = dict(avg_factor=4.0) if case == "focal_avg" else {}
        ref = jlosses.focal_loss(jp, jnp.asarray(multi), **kw)
        got = tlosses.focal_loss(tp, _t(multi), **kw)
    elif case == "center":
        centers = rng.standard_normal((c + 2, c)).astype(np.float32)
        ref = jlosses.center_loss(jp, jnp.asarray(label),
                                  jnp.asarray(centers))
        got = tlosses.center_loss(tp, torch.from_numpy(label), _t(centers))
    else:
        dist = case.split("_")[1]
        lab = np.array([0, 1, 0, 2, 1, 2])
        ref = jlosses.triplet_loss(jp, jnp.asarray(lab), distance=dist)
        got = tlosses.triplet_loss(tp, torch.from_numpy(lab), distance=dist)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-6)


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


# --------------------------------------------------------- mixup / cutmix


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mixup_and_cutmix_match_jax_on_its_draws(alpha):
    """mixup and cutmix given JAX's own draws (its key splits: lam, the
    permutation, the box centre), exact up to 1e-6; the port's own draws
    mix the labels to rows summing to 1."""
    imgs = np.random.default_rng(2).standard_normal((4, 16, 12, 3)).astype(
        np.float32)
    labels = np.eye(4, 5, dtype=np.float32)
    for seed in range(4):
        rng = jax.random.PRNGKey(seed)
        ref_i, ref_l = jaugment.batch_mixup(rng, jnp.asarray(imgs),
                                            jnp.asarray(labels), alpha)
        r_lam, r_perm = jax.random.split(rng)
        lam = jax.random.beta(r_lam, alpha, alpha)
        perm = jax.random.permutation(r_perm, 4)
        got_i, got_l = taugment.mixup_with(_t(imgs), _t(labels),
                                           torch.tensor(float(lam)),
                                           torch.from_numpy(np.asarray(perm)))
        np.testing.assert_allclose(got_i.numpy(), _np(ref_i), atol=1e-6)
        np.testing.assert_allclose(got_l.numpy(), _np(ref_l), atol=1e-6)

        ref_i, ref_l = jaugment.batch_cutmix(rng, jnp.asarray(imgs),
                                             jnp.asarray(labels), alpha)
        r_lam, r_perm, r_x, r_y = jax.random.split(rng, 4)
        lam = jax.random.beta(r_lam, alpha, alpha)
        perm = jax.random.permutation(r_perm, 4)
        cy = jax.random.randint(r_y, (), 0, 16)
        cx = jax.random.randint(r_x, (), 0, 12)
        got_i, got_l = taugment.cutmix_with(
            _t(imgs), _t(labels), torch.tensor(float(lam)),
            torch.from_numpy(np.asarray(perm)), torch.tensor(int(cy)),
            torch.tensor(int(cx)))
        np.testing.assert_array_equal(got_i.numpy(), _np(ref_i))
        np.testing.assert_allclose(got_l.numpy(), _np(ref_l), atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    for fn in (taugment.batch_mixup, taugment.batch_cutmix):
        mi, ml = fn(_t(imgs), _t(labels), alpha, gen)
        assert mi.shape == imgs.shape
        np.testing.assert_allclose(ml.sum(-1).numpy(), 1.0, atol=1e-5)


def test_build_batch_augment_choice():
    """build_batch_augment's probabilities (normalized, 1 / n by default)
    equal the JAX package's; a probability of 0 is never drawn, a share of 0.25 is
    drawn about that often; no augments build nothing."""
    cfgs = [dict(type="BatchMixup", alpha=0.2, prob=0.75),
            dict(type="BatchCutMix", alpha=1.0, prob=0.25)]
    aug = taugment.build_batch_augment(cfgs)
    np.testing.assert_allclose(aug.weights.numpy(), [0.75, 0.25])
    default = taugment.build_batch_augment([dict(type="BatchMixup"),
                                            dict(type="CutMix")])
    np.testing.assert_allclose(default.weights.numpy(), [0.5, 0.5])
    assert taugment.build_batch_augment(None) is None
    assert jaugment.build_batch_augment(None) is None
    with pytest.raises(ValueError):
        taugment.build_batch_augment([dict(type="Mosaic")])
    imgs = torch.zeros((2, 4, 4, 3))
    imgs[1] = 1.0
    labels = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    gen = torch.Generator().manual_seed(1)
    only_cut = taugment.build_batch_augment(
        [dict(type="BatchMixup", prob=0.0), dict(type="BatchCutMix",
                                                 prob=1.0)])
    for _ in range(10):  # a cutmix never gives a value strictly inside
        out, _ = only_cut(imgs, labels, gen)
        assert bool(((out == 0) | (out == 1)).all())
    picks = [int(torch.multinomial(aug.weights, 1, generator=gen))
             for _ in range(400)]
    assert 60 <= picks.count(1) <= 140
    out_i, out_l = aug(imgs, labels, gen)
    assert out_i.shape == imgs.shape and out_l.shape == labels.shape


# ------------------------------------------------------------------ LAMB


class _Tiny(torch.nn.Module):
    """A Dense, a BatchNorm and a zero-initialized Dense: decayed kernels,
    exempt scales and biases, and parameters whose norm is 0."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(6, 4)
        self.norm = tlayers.BatchNorm(4)
        self.zero = torch.nn.Linear(4, 3)


def test_lamb_matches_optax():
    """Five LAMB steps (weight decay with the decay mask, clipping at a
    global norm that the third step's gradients exceed) against the JAX
    package's ``build_optimizer(..., 'lamb')``, fp32, within 1e-6."""
    rng = np.random.default_rng(0)
    params = {
        "dense": {"kernel": rng.standard_normal((6, 4)).astype(np.float32),
                  "bias": rng.standard_normal(4).astype(np.float32)},
        "norm": {"scale": (1 + 0.1 * rng.standard_normal(4)).astype(
            np.float32), "bias": np.zeros(4, np.float32)},
        "zero": {"kernel": np.zeros((4, 3), np.float32),
                 "bias": np.zeros(3, np.float32)}}
    model = _Tiny()
    with torch.no_grad():
        model.dense.weight.copy_(_t(params["dense"]["kernel"].T))
        model.dense.bias.copy_(_t(params["dense"]["bias"]))
        model.norm.weight.copy_(_t(params["norm"]["scale"]))
        model.norm.bias.zero_()
        model.zero.weight.zero_()
        model.zero.bias.zero_()
    lr = lambda step: 0.01 * (step + 1)  # noqa: E731
    kw = dict(weight_decay=0.05, betas=(0.9, 0.99), eps=1e-6,
              grad_clip_norm=3.0)
    tx = joptim.build_optimizer(params, lambda c: 0.01 * (c + 1), "lamb",
                                **kw)
    opt = toptim.build_optimizer(model, lr, "lamb", **kw)
    state = tx.init(params)
    jparams = jax.tree.map(jnp.asarray, params)
    for step in range(5):
        scale = 10.0 if step == 2 else 0.2
        grads = jax.tree.map(
            lambda p: (scale * rng.standard_normal(p.shape)).astype(
                np.float32), params)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        model.dense.weight.grad = _t(grads["dense"]["kernel"].T.copy())
        model.dense.bias.grad = _t(grads["dense"]["bias"])
        model.norm.weight.grad = _t(grads["norm"]["scale"])
        model.norm.bias.grad = _t(grads["norm"]["bias"])
        model.zero.weight.grad = _t(grads["zero"]["kernel"].T.copy())
        model.zero.bias.grad = _t(grads["zero"]["bias"])
        norm = opt.update(step)
        assert (float(norm) > 3.0) == (step == 2)
    pairs = [(model.dense.weight.detach().T, jparams["dense"]["kernel"]),
             (model.dense.bias, jparams["dense"]["bias"]),
             (model.norm.weight, jparams["norm"]["scale"]),
             (model.norm.bias, jparams["norm"]["bias"]),
             (model.zero.weight.detach().T, jparams["zero"]["kernel"]),
             (model.zero.bias, jparams["zero"]["bias"])]
    for got, ref in pairs:
        np.testing.assert_allclose(got.detach().numpy(), _np(ref),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------- the tiled plain build


@pytest.mark.parametrize("bias_kind", [None, "shared", "batched"])
def test_knn_graph_query_chunk_is_bitwise_untiled(bias_kind):
    """``knn_graph(query_chunk=)`` bitwise the untiled build (and the JAX
    package's tiled build), for chunks that divide N; a chunk that does not
    divide N builds untiled."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 48, 8)).astype(np.float32)
    y = rng.standard_normal((2, 30, 8)).astype(np.float32)
    bias = {None: None,
            "shared": rng.standard_normal((48, 30)).astype(np.float32),
            "batched": rng.standard_normal((2, 48, 30)).astype(
                np.float32)}[bias_kind]
    tb = None if bias is None else _t(bias)
    whole = tknn.knn_graph(_t(x), _t(y), k=5, bias=tb)
    for chunk in (1, 12, 16, 48, 7):
        tiled = tknn.knn_graph(_t(x), _t(y), k=5, bias=tb, query_chunk=chunk)
        assert torch.equal(tiled, whole), chunk
    ref = jknn.knn_graph(jnp.asarray(x), jnp.asarray(y), k=5,
                         bias=None if bias is None else jnp.asarray(bias),
                         query_chunk=12)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(ref))


def test_knn_budget_tiles_the_stochastic_build(monkeypatch):
    """GKGNet's ``knn_budget`` reaches the plain graph build: the chunk of
    every spatial stage is the JAX package's ``_divisor_chunk``, and the
    stochastic 'mr' blocks' ``knn_graph`` calls take it."""
    from gkgnet_tpu.nn import gkgnet as jgkgnet
    from gkgnet_tpu_torch.nn import gkgnet as tgkgnet

    for n, m, budget in ((1024, 64, 1 << 12), (256, 256, 1 << 12),
                         (64, 64, 1 << 22), (97, 97, 100)):
        assert tgkgnet._divisor_chunk(n, m, budget) == \
            jgkgnet._divisor_chunk(n, m, budget)
    model = GKGNet(**dict(SMALL), knn_budget=1 << 12)
    chunks = [block[0].graph_conv.knn_chunk for block in model.backbone
              if isinstance(block, torch.nn.Sequential)]
    assert chunks == [jgkgnet._divisor_chunk(1024, 64, 1 << 12)] * 2 + \
        [jgkgnet._divisor_chunk(256, 64, 1 << 12)] * 2 + [None] * 8
    seen = []
    real = tgrapher.knn_graph

    def spy(*args, **kwargs):
        seen.append(kwargs.get("query_chunk"))
        return real(*args, **kwargs)
    monkeypatch.setattr(tgrapher, "knn_graph", spy)
    conv = model.backbone[0][0].graph_conv
    conv.stochastic, conv.epsilon = True, 0.5
    x = torch.randn((1, 32, 32, 48))
    conv.train()(x, model.rel_pos_stage0, torch.Generator().manual_seed(0))
    assert seen == [chunks[0]]


# ------------------------------------------------------- GKGNet's flags


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(6).standard_normal((2, 128, 128, 3)).astype(
        np.float32)


@pytest.mark.parametrize("flags", [
    dict(use_multi_group=False, backbone_multi_group=False),
    dict(use_multi_group=False),
    dict(backbone_multi_group=False),
    dict(out_indices=(0, 1, 2, 3), return_stage_feats=True),
    dict(out_indices=(1, 3), return_stage_feats=True, knn_budget=1 << 10),
], ids=["no_groups", "label_no_groups", "backbone_no_groups",
        "all_stage_feats", "stage_feats_budget"])
def test_gkgnet_flags_match_jax(flags, image):
    """The backbone with each flag against the JAX backbone on carried
    weights, eval, fp32, within 1e-4: label embeddings, GAP, the last
    label graph's edges and, with ``return_stage_feats``, the stage maps
    of ``out_indices`` in JAX's order (maps of magnitude ~30: within 1e-5
    of each map's largest value)."""
    kw = dict(SMALL, **flags)
    jm = JaxGKGNet(**kw)
    variables = _jax_variables(jm, jnp.asarray(image), False, seed=9)
    ref, _ = jm.apply(variables, jnp.asarray(image), False,
                      mutable=["constants"])
    tm = GKGNet(**kw)
    _load_subtree(tm, variables, ("backbone",), "backbone.")
    with torch.no_grad():
        got = tm.eval()(_t(image))
    assert len(got) == len(ref) == (4 if flags.get("return_stage_feats")
                                    else 3)
    for a, b in ((got[0], ref[0]), (got[1], ref[1])):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if flags.get("return_stage_feats"):
        assert len(got[3]) == len(ref[3]) == len(flags["out_indices"])
        for a, b in zip(got[3], ref[3]):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-4,
                                       atol=1e-5 * np.abs(_np(b)).max())


@pytest.mark.parametrize("neck", [
    dict(type="HRFuseScales", out_channels=32, out_indices=(0, 1, 2, 3)),
    dict(type="FPN", out_channels=32, out_indices=(1, 2, 3)),
    dict(type="ChannelMapper", out_channels=16, out_indices=(2, 3)),
    dict(type="GlobalAveragePooling", out_indices=(3,), out_channels=384),
    dict(type="GlobalAveragePooling", out_indices=(1, 2)),
], ids=["hrfuse", "fpn", "mapper", "gap", "gap_stage3"])
def test_neck_classifier_matches_jax(neck, image, monkeypatch):
    """The classifier with a neck and its MultiLabelLinearClsHead on
    carried weights (every neck and head leaf through the weight loader),
    eval, fp32, within 1e-4, and the loss head's loss within 1e-5.

    The port's neck and head run on the JAX backbone's outputs: the two
    backbones agree (``test_gkgnet_flags_match_jax``) but where their fp32
    distances (XLA's and torch's sums, in other orders) order a near-tie
    differently, and the flip carries through the chaotic random model to
    the stage maps (not a fault: ROADMAP.md section 3 item 2); here it
    would hide what the neck and head do."""
    kw = dict(SMALL, neck_cfg=neck)
    jm = JaxClassifier(**kw)
    variables = _jax_variables(jm, jnp.asarray(image), False, seed=11)
    (ref, _), _ = jm.apply(variables, jnp.asarray(image), False,
                           mutable=["constants"])
    feats, _ = jm.apply(variables, jnp.asarray(image), False,
                        method=lambda m, x, train: m.backbone(x, train),
                        mutable=["constants"])
    tm = GKGNetClassifier(**kw)
    load_jax_variables(tm, variables)
    jax_backbone = (_t(np.asarray(feats[0])), _t(np.asarray(feats[1])),
                    torch.from_numpy(np.asarray(feats[2])),
                    tuple(_t(np.asarray(f)) for f in feats[3]))
    monkeypatch.setattr(tm.backbone, "forward",
                        lambda imgs, generator=None: jax_backbone)
    with torch.no_grad():
        got, _ = tm.eval()(_t(image))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4, atol=1e-4)
    gt = np.array([[1, 0, -1, 0, 1, 0], [0, 0, 1, 1, 0, 0]], np.float32)
    ref_loss = jm.build_loss_head().loss(ref, jnp.asarray(gt))
    got_loss = tm.build_loss_head().loss(got, _t(gt))
    np.testing.assert_allclose(got_loss["loss"].numpy(),
                               _np(ref_loss["loss"]), rtol=1e-5)
    assert isinstance(tm.head, theads.MultiLabelLinearClsHead)


# ------------------------------------------- a config of the new features


FEATURES_CONFIG = '''
model = dict(arch="t", size=128, k=3, k_label_gcn=3, num_group=2,
             n_classes=5, dtype="float32",
             neck=dict(type="GlobalAveragePooling", out_indices=(3,),
                       out_channels=384),
             train_cfg=dict(augments=[
                 dict(type="BatchMixup", alpha=0.2, prob=0.5),
                 dict(type="BatchCutMix", alpha=1.0, prob=0.5)]))
optimizer = dict(type="lamb", lr=1e-3, weight_decay=0.05)
'''


def test_features_config_builds_and_steps_in_both(tmp_path):
    """A config with ``model.neck``, ``model.train_cfg.augments`` and
    ``optimizer.type='lamb'`` builds in both packages (the same parameter
    tree: every JAX leaf loads into the port) and takes one train step on
    the CPU in each: finite losses; the port's parameters moved."""
    from gkgnet_tpu.core.builder import build_model as jbuild
    from gkgnet_tpu.core.config import Config as JConfig
    from gkgnet_tpu.core.trainer import create_train_state as jstate
    from gkgnet_tpu.core.trainer import make_train_step as jstep
    from gkgnet_tpu_torch.core.builder import build_model
    from gkgnet_tpu_torch.core.config import Config
    from gkgnet_tpu_torch.core.trainer import (create_train_state,
                                               make_train_step)
    from gkgnet_tpu_torch.nn.classifier import init_parameters

    path = tmp_path / "features.py"
    path.write_text(FEATURES_CONFIG)
    jcfg, cfg = JConfig.fromfile(str(path)), Config.fromfile(str(path))
    x = np.random.default_rng(0).standard_normal((2, 128, 128, 3)).astype(
        np.float32)
    gt = np.array([[1, 0, 0, 1, 0], [0, 1, 0, 0, 0]], np.float32)

    jm = jbuild(jcfg.model)
    augments = jcfg.model["train_cfg"]["augments"]
    tx = joptim.build_optimizer(
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))["params"],
        jcfg.optimizer["lr"], "lamb", jcfg.optimizer["weight_decay"])
    state = jstate(jm, jax.random.PRNGKey(0), jnp.asarray(x), tx)
    step = jstep(jm, tx, donate=False,
                 batch_augment=jaugment.build_batch_augment(augments))
    _, jlogs = step(state, {"img": jnp.asarray(x),
                            "gt_label": jnp.asarray(gt)},
                    jax.random.PRNGKey(1))
    assert np.isfinite(float(jlogs["loss"]))

    tm = build_model(cfg.model)
    assert isinstance(tm.head, theads.MultiLabelLinearClsHead)
    load_jax_variables(tm, {"params": jax.device_get(state.params),
                            "batch_stats": jax.device_get(
                                state.batch_stats)})
    init_parameters(tm, torch.Generator().manual_seed(0))
    opt = toptim.build_optimizer(tm, cfg.optimizer["lr"],
                                 cfg.optimizer["type"],
                                 cfg.optimizer["weight_decay"])
    assert isinstance(opt.optimizer, toptim.Lamb)
    tstate = create_train_state(tm, opt)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    tstep = make_train_step(batch_augment=taugment.build_batch_augment(
        cfg.model["train_cfg"]["augments"]))
    tstate, logs = tstep(tstate, {"img": _t(x), "gt_label": _t(gt)})
    assert np.isfinite(float(logs["loss"]))
    moved = [k for k, v in tm.named_parameters()
             if not torch.equal(v.detach(), before[k])]
    assert "head.fc.weight" in moved and len(moved) > len(before) // 2
