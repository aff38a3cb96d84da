"""A config of the new model features (a neck, batch augments, LAMB)
built and stepped in both packages on the CPU. Split from
``test_torch_features.py`` so that its CPU time spreads over test
workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.core import optim as joptim
from gkgnet_tpu.nn import augment as jaugment
from gkgnet_tpu_torch.core import optim as toptim
from gkgnet_tpu_torch.nn import augment as taugment
from gkgnet_tpu_torch.nn import heads as theads
from gkgnet_tpu_torch.utils.weights import (load_jax_variables,
                                            state_dict_from_jax)
from test_torch_model import _t

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU work on one thread: the suite runs several test files at
    once on the host's cores, and beside them a run on every core's thread
    spends most of its time waiting for the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
