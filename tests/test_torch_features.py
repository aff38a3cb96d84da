"""Parity of the port's model features with the JAX package, on the CPU, in
fp32: the activations, necks, linear heads, losses, mixup/cutmix, LAMB
and the tiled plain kNN build (the perturbed build, GKGNet's flags and a
config of these features are in ``test_torch_features_*.py``). Inputs and
weights come from numpy seeds; the JAX side runs its plain (XLA) path.
Each test states its tolerance.
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
from gkgnet_tpu.ops import knn as jknn
from gkgnet_tpu.ops.pos_embed import get_relative_pos_table
from gkgnet_tpu_torch.core import optim as toptim
from gkgnet_tpu_torch.nn import augment as taugment
from gkgnet_tpu_torch.nn import grapher as tgrapher
from gkgnet_tpu_torch.nn import heads as theads
from gkgnet_tpu_torch.nn import layers as tlayers
from gkgnet_tpu_torch.nn import losses as tlosses
from gkgnet_tpu_torch.nn import necks as tnecks
from gkgnet_tpu_torch.nn.gkgnet import GKGNet
from gkgnet_tpu_torch.ops import knn as tknn
from gkgnet_tpu_torch.utils.weights import state_dict_from_jax
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
