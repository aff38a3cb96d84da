"""The port's training-support services against the JAX package's, on the
CPU: ``precise_bn`` (the running statistics it recomputes, on the JAX
deployment test's mini GKGNet and on ``tests/test_extras.py``'s one-layer
BN model, at drop_path 0: the two frameworks' DropPath draws cannot match)
and ``class_num_check``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from gkgnet_tpu.core.builder import build_model as jax_build_model
from gkgnet_tpu.core.config import Config as JaxConfig
from gkgnet_tpu.core.hooks import class_num_check as jax_class_num_check
from gkgnet_tpu.core.hooks import precise_bn as jax_precise_bn
from gkgnet_tpu.core.trainer import create_train_state as jax_train_state
from gkgnet_tpu.nn.layers import BatchNorm as JaxBatchNorm
from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.config import Config
from gkgnet_tpu_torch.core.hooks import class_num_check, precise_bn
from gkgnet_tpu_torch.nn.layers import BatchNorm
from gkgnet_tpu_torch.utils.weights import (load_jax_variables,
                                            state_dict_from_jax)
from test_deployment import MINI_CONFIG

# the statistics of a train-mode forward 16 graph convs and 48 BatchNorms
# deep in fp32: the two frameworks' convolutions and reductions round
# differently and each layer's moments feed the next layer's normalization
# (measured: variances within 5e-6 relative); the absolute floor is for
# means that are 0 in exact arithmetic (a BatchNorm after a normalized
# input and a bias-free mix) and hold rounding noise of O(1) activations
MINI_RTOL, MINI_ATOL = 1e-4, 1e-5
# one BatchNorm on the images, the moments of the same fp32 data summed in
# another order: the variance mean(x^2) - mean(x)^2 cancels ~7x at mean 5
# and variance 4, so a few ulp of the sums become ~1e-5 of it
TINY_RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_init_state(jmodel, size):
    """The JAX train state of ``tools/inference.py``'s ``init_model`` (key
    0, SGD), its init jitted: ~4 s instead of ~35 s op by op at t@128, the
    same values to an ulp."""
    return jax.jit(lambda x: jax_train_state(
        jmodel, jax.random.PRNGKey(0), x, optax.sgd(1e-3)))(
            jnp.zeros((1, size, size, 3)))


def _stats(tree):
    """A JAX ``batch_stats`` tree as the port's state_dict entries."""
    return {k: v.numpy() for k, v in
            state_dict_from_jax({"batch_stats": tree}).items()}


def _port_stats(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The JAX mini model and its state from the JAX init, and the port's
    model with the same variables."""
    path = tmp_path_factory.mktemp("hooks") / "cfg.py"
    path.write_text(MINI_CONFIG.format(img_dir="unused", ann="unused"))
    jmodel = jax_build_model(JaxConfig.fromfile(str(path)).model)
    state = jax_init_state(jmodel, 128)
    model = build_model(Config.fromfile(str(path)).model)
    load_jax_variables(model, {"params": state.params,
                               "batch_stats": state.batch_stats})
    return jmodel, state, model


def _batches(n, batch, seed=1):
    """Seeded standard-normal batches. Not seed 0: its first batch of 2
    meets a near-tie in the graph build of block 10 (stage 3), which the two
    frameworks' fp32 distances (~5e-6 apart there) break differently; the
    train-mode logits then differ by 1.4, a flip and not a fault (ROADMAP.md
    queue 3 item 2). The batches of seed 1 meet none: each one's train-mode
    logits agree to 1e-5."""
    rng = np.random.default_rng(seed)
    return [{"img": rng.standard_normal((batch, 128, 128, 3)).astype(
        np.float32)} for _ in range(n)]


def test_precise_bn_matches_jax_on_the_mini_model(mini):
    """Every BatchNorm's recomputed mean and variance against the JAX
    function's on the same batches: 5 batches of 2 with num_samples=7, so
    both stop after the fourth."""
    jmodel, state, model = mini
    batches = _batches(5, 2)
    want = _stats(jax_precise_bn(
        jmodel, state, [{"img": jnp.asarray(b["img"])} for b in batches],
        num_samples=7).batch_stats)
    model.eval()
    used = precise_bn(model, batches, num_samples=7,
                      generator=torch.Generator().manual_seed(0))
    assert used == 4
    assert not model.training
    got = _port_stats(model)
    assert set(got) == set(want) and len(got) > 40
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=MINI_RTOL,
                                   atol=MINI_ATOL, err_msg=key)
    # the statistics moved from the init's zeros and ones
    assert all(not np.array_equal(v, np.zeros_like(v))
               for k, v in got.items() if k.endswith("running_mean"))


class _JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False, **kw):
        return JaxBatchNorm(name="bn")(x, use_running_average=not train)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bn = BatchNorm(3)

    def forward(self, x, generator=None):
        return self.bn(x)


def test_precise_bn_matches_jax_on_one_layer():
    """``tests/test_extras.py``'s case: data of mean ~5 and variance ~4,
    three batches; the port's statistics against the JAX function's, and
    both near the data's moments."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((4, 8, 8, 3)).astype(np.float32) * 2.0 + 5.0
    jmodel = _JaxTiny()
    state = jax_train_state(jmodel, jax.random.PRNGKey(0),
                            jnp.zeros((4, 8, 8, 3)), optax.sgd(1e-3))
    want = jax_precise_bn(jmodel, state,
                          [{"img": jnp.asarray(data)} for _ in range(3)],
                          num_samples=100).batch_stats["bn"]
    model = _Tiny()
    assert precise_bn(model, [{"img": data} for _ in range(3)],
                      num_samples=100) == 3
    np.testing.assert_allclose(model.bn.running_mean.numpy(),
                               np.asarray(want["mean"]), rtol=TINY_RTOL)
    np.testing.assert_allclose(model.bn.running_var.numpy(),
                               np.asarray(want["var"]), rtol=TINY_RTOL)
    np.testing.assert_allclose(model.bn.running_mean.numpy(),
                               data.mean((0, 1, 2)), atol=0.2)
    np.testing.assert_allclose(model.bn.running_var.numpy(),
                               data.var((0, 1, 2)), rtol=0.2)


def test_precise_bn_without_batches_keeps_the_statistics():
    model = _Tiny()
    with torch.no_grad():
        model.bn.running_mean.fill_(3.0)
    assert precise_bn(model, []) == 0
    assert torch.equal(model.bn.running_mean, torch.full((3,), 3.0))
    assert torch.equal(model.bn.running_var, torch.ones(3))
    assert model.training  # the mode it came in with


@pytest.mark.parametrize("classes,num", [(["a", "b", "c"], 3),
                                         (["a", "b", "c"], 80),
                                         (None, 80)])
def test_class_num_check_matches_jax(classes, num):
    class DS:
        pass

    ds = DS()
    if classes is not None:
        ds.CLASSES = classes
    outcomes = []
    for fn in (jax_class_num_check, class_num_check):
        try:
            fn(ds, num)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (classes is None or len(classes) == num)
