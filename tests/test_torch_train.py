"""Parity of the PyTorch port's training slice with the JAX package, on the
CPU: BatchNorm in train mode, DropPath, the losses, the weight-decay mask,
the optimizer and schedules, and one whole train step at arch t, size 128,
k=3 in fp32. Inputs and weights are made with numpy from a seed and handed
to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

from gkgnet_tpu.core import optim as joptim
from gkgnet_tpu.core import schedules as jsched
from gkgnet_tpu.core import trainer as jtrainer
from gkgnet_tpu.nn import classifier as jclassifier
from gkgnet_tpu.nn import heads as jheads
from gkgnet_tpu.nn import layers as jlayers
from gkgnet_tpu.nn import losses as jlosses
from gkgnet_tpu_torch import entry as tentry
from gkgnet_tpu_torch.core import optim as toptim
from gkgnet_tpu_torch.core import schedules as tsched
from gkgnet_tpu_torch.core import trainer as ttrainer
from gkgnet_tpu_torch.nn import layers as tlayers
from gkgnet_tpu_torch.nn import losses as tlosses
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, parse_losses
from gkgnet_tpu_torch.nn.heads import LabelQueryHead
from gkgnet_tpu_torch.utils.weights import (jax_leaf_names, load_jax_variables,
                                            state_dict_from_jax, torch_key)

SMALL = dict(arch="t", k=3, k_label_gcn=3, n_classes=10, size=128)


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
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _leaves(tree):
    """{path of names: numpy leaf} of a JAX tree."""
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_batchnorm_train_mode_matches_jax(dtype):
    """Output and updated running statistics against the JAX BatchNorm
    applied with ``mutable=['batch_stats']``: batch moments as
    mean(x^2) - mean(x)^2 in fp32, unbiased variance into the running
    statistics with momentum 0.1. fp32 within 1e-5; a bf16 output within
    1 bf16 ulp of the same fp32 value."""
    rng = np.random.default_rng(0)
    c = 8
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 5, c))).astype(np.float32)
    scale = 1.0 + 0.1 * rng.standard_normal(c)
    bias = 0.1 * rng.standard_normal(c)
    mean = rng.standard_normal(c)
    var = rng.uniform(0.5, 1.5, c)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = jlayers.BatchNorm(dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                            "bias": jnp.asarray(bias, jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(mean, jnp.float32),
                                 "var": jnp.asarray(var, jnp.float32)}}
    jx = jnp.asarray(x, jdt)
    ref, mutated = jm.apply(variables, jx, False, mutable=["batch_stats"])
    tm = tlayers.BatchNorm(c, dtype=dtype)
    tm.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                        "running_mean": _t(mean), "running_var": _t(var)})
    got = tm.train()(_t(np.asarray(jx.astype(jnp.float32))).to(dtype))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(tm.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), stats["var"],
                               rtol=1e-6, atol=1e-6)
    # eval mode uses the running statistics and leaves them alone
    before = tm.running_var.clone()
    tm.eval()(_t(x))
    assert torch.equal(tm.running_var, before)


def test_drop_path_semantics():
    """Identity in eval and at rate 0; in train mode each sample is either
    0 or x / keep, drawn from the generator passed in, so the same seed
    gives the same result."""
    x = torch.randn((64, 3, 4), generator=torch.Generator().manual_seed(0))
    dp = tlayers.DropPath(0.25)
    assert dp.eval()(x, None) is x
    assert tlayers.DropPath(0.0).train()(x, None) is x
    dp.train()
    out = dp(x, torch.Generator().manual_seed(1))
    dropped = (out == 0).flatten(1).all(1)
    kept = (out == x / 0.75).flatten(1).all(1)
    assert bool((dropped | kept).all()) and dropped.any() and kept.any()
    assert torch.equal(out, dp(x, torch.Generator().manual_seed(1)))
    assert not torch.equal(out, dp(x, torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError):
        dp(x, None)


def test_drop_path_rates_match_jax():
    """The per-block rates: ``linspace(0, drop_path, n_blocks)`` over the
    Grapher/FFN blocks, the stage's first rate for its label blocks (and
    their FFN), read from the JAX modules as they are called."""
    jm = jclassifier.GKGNetClassifier(**SMALL, drop_path=0.3)
    rates = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and hasattr(mod, "drop_path") \
                and (mod.name or "").startswith(("backbone_", "gcn_label_")):
            rates[mod.name] = mod.drop_path
        return next_fun(*args, **kwargs)

    with flax_nn.intercept_methods(record):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 128, 128, 3)), False))
    tm = GKGNetClassifier(**SMALL, drop_path=0.3)
    got = {}
    for i, block in enumerate(tm.backbone.backbone):
        if isinstance(block, torch.nn.Sequential):
            got[f"backbone_{i}_grapher"] = block[0].drop_path.rate
            got[f"backbone_{i}_ffn"] = block[1].drop_path.rate
    for s, stage in enumerate(tm.backbone.gcn_label):
        for j, gcn in enumerate(stage):
            got[f"gcn_label_{s}_{j}"] = gcn.drop_path.rate
            assert gcn.ffn.drop_path.rate == gcn.drop_path.rate
    assert set(got) == set(rates) and len(rates) == 2 * 12 + 4
    for name, rate in rates.items():
        assert got[name] == pytest.approx(rate, rel=1e-12, abs=0), name


# --------------------------------------------------------------- losses


def _scores(seed, shape=(4, 10)):
    rng = np.random.default_rng(seed)
    pred = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    target = (rng.random(shape) < 0.3).astype(np.float32)
    weight = rng.random(shape[0]).astype(np.float32)
    return pred, target, weight


@pytest.mark.parametrize("case", ["asl", "asl_noclip_weighted",
                                  "asl_softmax_sum", "bce", "smooth",
                                  "smooth_avg_weighted", "reduce_none"])
def test_losses_match_jax(case):
    """Each loss against the JAX package's, in fp32 within 1e-6."""
    pred, target, weight = _scores(1)
    jp, jt, jw = jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight)
    tp, tt, tw = _t(pred), _t(target), _t(weight)
    if case == "asl":
        ref = jlosses.asymmetric_loss(jp, jt, gamma_pos=0.0, gamma_neg=2.0)
        got = tlosses.asymmetric_loss(tp, tt, gamma_pos=0.0, gamma_neg=2.0)
    elif case == "asl_noclip_weighted":
        ref = jlosses.asymmetric_loss(jp, jt, jw, gamma_pos=1.0, clip=0.0,
                                      avg_factor=3.0)
        got = tlosses.asymmetric_loss(tp, tt, tw, gamma_pos=1.0, clip=0.0,
                                      avg_factor=3.0)
    elif case == "asl_softmax_sum":
        ref = jlosses.asymmetric_loss(jp, jt, reduction="sum",
                                      use_sigmoid=False)
        got = tlosses.asymmetric_loss(tp, tt, reduction="sum",
                                      use_sigmoid=False)
    elif case == "bce":
        ref = jlosses.binary_cross_entropy_with_logits(jp, jt)
        got = tlosses.binary_cross_entropy_with_logits(tp, tt)
    elif case == "smooth":
        ref = jlosses.label_smooth_multilabel_loss(jp, jt, 0.1,
                                                   avg_factor=4)
        got = tlosses.label_smooth_multilabel_loss(tp, tt, 0.1, avg_factor=4)
    elif case == "smooth_avg_weighted":
        ref = jlosses.label_smooth_multilabel_loss(jp, jt, 0.2, jw)
        got = tlosses.label_smooth_multilabel_loss(tp, tt, 0.2, tw)
    else:
        ref = jlosses.weight_reduce_loss(jp, jnp.asarray(target), "none")
        got = tlosses.weight_reduce_loss(tp, tt, "none")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_head_loss_and_parse_losses_match_jax():
    """``LabelQueryHead.loss`` (the dual loss of the main path) and
    ``parse_losses`` against the JAX package's, within 1e-6; bf16 logits
    are taken in fp32."""
    pred, target, _ = _scores(2, (4, 80))
    j_losses = jheads.LabelQueryHead(80, 640).loss(jnp.asarray(pred),
                                                  jnp.asarray(target))
    j_total, j_log = jclassifier.parse_losses(j_losses)
    head = LabelQueryHead(80, 640)
    t_losses = head.loss(_t(pred), _t(target))
    assert set(t_losses) == set(j_losses) == {"bce_loss", "asy_loss"}
    total, log = parse_losses(t_losses)
    assert set(log) == set(j_log)
    for key in j_log:
        np.testing.assert_allclose(log[key].item(), float(j_log[key]),
                                   rtol=1e-6)
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-6)
    bf16 = head.loss(_t(pred).to(torch.bfloat16), _t(target))
    assert all(v.dtype == torch.float32 for v in bf16.values())


# ------------------------------------------------ optimizer and schedules


def _jax_small_params(seed=0):
    """Random fp32 params for the JAX classifier at SMALL, by shape only."""
    jm = jclassifier.GKGNetClassifier(**SMALL)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), False))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes["params"])


def test_no_decay_mask_matches_jax_leaf_by_leaf():
    """The port's decay mask is the JAX package's ``no_decay_mask``, leaf by
    leaf through ``torch_key``. The JAX rule reads the leaf's last name, so
    it decays head/fc1_bias, pos_embed and label_lt/embedding and exempts
    head/fc2/bias."""
    params = _jax_small_params()
    j_mask = _leaves(joptim.no_decay_mask(params))
    tm = GKGNetClassifier(**SMALL)
    mask = toptim.no_decay_mask(tm)
    leaf_names = jax_leaf_names(tm)
    assert set(mask) == {torch_key(p) for p in j_mask}
    assert set(mask) == {name for name, _ in tm.named_parameters()}
    for path, decayed in j_mask.items():
        key = torch_key(path)
        assert leaf_names[key] == path[-1], key
        assert mask[key] == bool(decayed), key
    assert mask["head.fc1.bias"] and mask["backbone.pos_embed"]
    assert mask["backbone.label_lt.weight"] and not mask["head.fc2.bias"]
    assert not mask["backbone.stem.convs.1.weight"]        # a BN scale


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizer_matches_optax(kind):
    """The port's clip + optimizer + schedule + EMA, fed the same gradients
    as optax's ``chain(clip_by_global_norm(5), adamw | sgd)``, over 3 steps
    whose gradient norms are 20, 2 and 8 (clipped, not, clipped): the
    parameters and the EMA within 1e-6 relative to each leaf's largest
    value, the global norms within 1e-6."""
    params = _jax_small_params(1)
    j_sched = jsched.step_lr_with_warmup(1e-2, 1, [2], warmup_iters=2)
    t_sched = tsched.step_lr_with_warmup(1e-2, 1, [2], warmup_iters=2)
    tx = joptim.build_optimizer(params, j_sched, optimizer=kind)
    opt_state = tx.init(params)
    j_update = jax.jit(tx.update)
    j_ema = params
    tm = GKGNetClassifier(**SMALL)
    tm.load_state_dict(state_dict_from_jax({"params": params}), strict=False)
    opt = toptim.build_optimizer(tm, t_sched, optimizer=kind)
    ema = {name: p.detach().clone() for name, p in tm.named_parameters()}
    named = dict(tm.named_parameters())
    rng = np.random.default_rng(2)
    for step, norm in enumerate((20.0, 2.0, 8.0)):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        scale = norm / float(optax.global_norm(grads))
        grads = jax.tree.map(lambda g: (g * scale).astype(np.float32), grads)
        updates, opt_state = j_update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        m = min(2e-4 * 100, (1.0 + step) / (100 + step))
        j_ema = jax.tree.map(lambda e, p: (1.0 - m) * e + m * p, j_ema,
                             params)
        for key, g in state_dict_from_jax({"params": grads}).items():
            named[key].grad = g.clone()
        got_norm = opt.update(step)
        ttrainer.ema_update(ema, tm, step, 2e-4 * 100, 100)
        np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
    for name, tree in (("params", params), ("ema", j_ema)):
        ref = state_dict_from_jax({"params": tree})
        for key, value in ref.items():
            got = (named[key] if name == "params" else ema[key]).detach()
            bound = 1e-6 * value.abs().max().item()
            assert (got - value).abs().max().item() <= bound, (name, key)


def test_schedules_match_jax():
    """The lr schedules step by step, and the plateau reducer's scales,
    against the JAX package's: within 1e-6 relative, or 1e-6 of the base
    rate where JAX's fp32 warmup factor ``1 - (1 - t)(1 - ratio)`` loses
    digits to cancellation (the port computes it in fp64)."""
    pairs = [
        (jsched.step_lr_with_warmup(1e-4, 10, [3, 5], warmup_iters=25),
         tsched.step_lr_with_warmup(1e-4, 10, [3, 5], warmup_iters=25)),
        (jsched.step_lr_with_warmup(1e-3, 4, [2], gamma=0.5),
         tsched.step_lr_with_warmup(1e-3, 4, [2], gamma=0.5)),
        (jsched.cosine_cooldown_lr(1e-3, 60, warmup_iters=7,
                                   min_lr_ratio=0.01),
         tsched.cosine_cooldown_lr(1e-3, 60, warmup_iters=7,
                                   min_lr_ratio=0.01)),
    ]
    for (j_fn, t_fn), base in zip(pairs, (1e-4, 1e-3, 1e-3)):
        for step in range(70):
            np.testing.assert_allclose(t_fn(step), float(j_fn(step)),
                                       rtol=1e-6, atol=1e-6 * base)
    metrics = [0.5, 0.6, 0.6, 0.59, 0.58, 0.61, 0.6, 0.6, 0.6, 0.6, 0.7]
    for kwargs in (dict(patience=1), dict(patience=0, cooldown=2,
                                          mode="min", min_lr=0.05)):
        j_r = jsched.ReduceLrOnPlateau(**kwargs)
        t_r = tsched.ReduceLrOnPlateau(**kwargs)
        assert [t_r.update(v) for v in metrics] == \
            [j_r.update(v) for v in metrics]


def test_device_normalize_matches_jax():
    norm = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
    img = np.random.default_rng(3).integers(0, 256, (2, 4, 4, 3),
                                             dtype=np.uint8)
    ref = jtrainer.make_device_normalize(norm)(jnp.asarray(img))
    got = ttrainer.make_device_normalize(norm)(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    f = torch.ones((1, 2, 2, 3))
    assert ttrainer.make_device_normalize(norm)(f) is f
    assert ttrainer.make_device_normalize(None)(f) is f


# ------------------------------------------------ the train step, whole


@pytest.fixture(scope="module")
def step_pair():
    """One train step of the JAX package (``make_train_step``) and of the
    port on the same weights (``load_jax_variables``) and batch: arch t,
    size 128, k=3, fp32, batch 2, drop_path 0, AdamW + clip 5 + schedule +
    EMA. Also the JAX gradients of the same loss (``jax.value_and_grad``
    of what make_train_step differentiates), which the step does not
    return."""
    jm = jclassifier.GKGNetClassifier(**SMALL)
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    gt = (rng.random((2, 10)) < 0.3).astype(np.float32)
    batch = {"img": jnp.asarray(img), "gt_label": jnp.asarray(gt)}
    j_sched = jsched.step_lr_with_warmup(1e-3, 10, [5], warmup_iters=2)
    state = jtrainer.create_train_state(jm, jax.random.PRNGKey(0),
                                        batch["img"], optax.sgd(1e-3),
                                        ema=True)
    tx = joptim.build_optimizer(state.params, j_sched)
    state = state.replace(opt_state=tx.init(state.params))
    head = jm.build_loss_head()

    def loss(params):
        (score, _), mutated = jm.apply(
            {"params": params, "batch_stats": state.batch_stats,
             "constants": state.constants}, batch["img"], train=True,
            rngs={"droppath": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        total, log = jclassifier.parse_losses(head.loss(score,
                                                        batch["gt_label"]))
        return total, log

    (_, j_log0), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        state.params)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    step = jtrainer.make_train_step(jm, tx, lr_schedule=j_sched,
                                    ema_momentum=2e-4, donate=False)
    j_state, j_log = step(state, batch, jax.random.PRNGKey(7))

    tm = GKGNetClassifier(**SMALL)
    load_jax_variables(tm, variables)
    t_sched = tsched.step_lr_with_warmup(1e-3, 10, [5], warmup_iters=2)
    t_state = ttrainer.create_train_state(
        tm, toptim.build_optimizer(tm, t_sched), ema=True)
    t_step = ttrainer.make_train_step(ema_momentum=2e-4)
    t_state, t_log = t_step(t_state, {"img": _t(img), "gt_label": _t(gt)}, 7)
    return dict(j_state=j_state, j_log=j_log, j_log0=j_log0,
                j_grads=j_grads, t_state=t_state, t_log=t_log)


def test_train_step_matches_jax_losses_and_norm(step_pair):
    """bce_loss, asy_loss, loss and the pre-clip gradient norm within 1e-4
    relative; lr the schedule's (to JAX's fp32 warmup factor, as in
    test_schedules_match_jax)."""
    j_log, t_log = step_pair["j_log"], step_pair["t_log"]
    for key in ("bce_loss", "asy_loss", "loss", "grad_norm"):
        np.testing.assert_allclose(float(t_log[key]), float(j_log[key]),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(t_log["lr"], float(j_log["lr"]), rtol=1e-6,
                               atol=1e-6 * 1e-3)
    assert step_pair["t_state"].step == int(step_pair["j_state"].step) == 1


def test_train_step_matches_jax_gradients(step_pair):
    """Every gradient leaf: the port's (after clipping at 5) against the
    JAX gradients times the same clip factor, within 1e-2 of the leaf's
    largest |g|. fp32 sums in other orders, carried back through 14 graph
    convs and 48 BatchNorms, differ by up to ~1e-3 of a leaf's scale, and a
    max-relative near-tie that the two break differently moves one
    element's gradient to another neighbour (the worst leaf measured:
    3.6e-3). A conv bias that a BatchNorm follows has a zero gradient in
    exact arithmetic and holds only rounding noise, so no leaf's scale is
    taken below 1e-4 of the largest gradient of the model."""
    j_grads = step_pair["j_grads"]
    norm = float(optax.global_norm(j_grads))
    factor = 1.0 if norm < 5.0 else 5.0 / norm
    named = dict(step_pair["t_state"].model.named_parameters())
    ref = state_dict_from_jax({"params": j_grads})
    assert set(ref) == set(named)
    floor = 1e-4 * max(g.abs().max().item() for g in ref.values())
    for key, g in ref.items():
        got = named[key].grad
        scale = max(g.abs().max().item(), floor) * factor
        err = (got - g * factor).abs().max().item()
        assert err <= 1e-2 * scale, (key, err, scale)


def test_train_step_matches_jax_batch_stats_and_ema(step_pair):
    """The running statistics after the step (momentum 0.1 towards the batch
    moments) within 1e-4 relative to each leaf's largest value, with an
    absolute floor of 1e-6 (a BatchNorm whose input has zero batch mean in
    exact arithmetic gets only rounding noise into its running mean, the
    activations being O(1)), and the EMA of the parameters within 1e-5 of
    each leaf's largest value plus 2 * lr * m: Adam's first update is
    +-lr on every element, and on a leaf of rounding noise (above) its
    sign is the noise's."""
    t_model = step_pair["t_state"].model
    sd = t_model.state_dict()
    ref = state_dict_from_jax(
        {"batch_stats": step_pair["j_state"].batch_stats})
    for key, value in ref.items():
        bound = max(1e-4 * value.abs().max().item(), 1e-6)
        assert (sd[key] - value).abs().max().item() <= bound, key
    ema = step_pair["t_state"].ema_params
    lr_m = float(step_pair["j_log"]["lr"]) * 2e-4
    for key, value in state_dict_from_jax(
            {"params": step_pair["j_state"].ema_params}).items():
        bound = 1e-5 * value.abs().max().item() + 2 * lr_m
        assert (ema[key] - value).abs().max().item() <= bound, key


def test_train_entry_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.train_entry()
