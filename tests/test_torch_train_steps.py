"""The port's train step on its own, on the CPU: two steps at arch t,
size 128, k=3 with DropPath and EMA (finite, moved, reproducible), and the
dynamic loss scaler's growth and back-off. Kept apart from
``test_torch_train.py`` so that the two files' CPU time spreads over two
test workers.
"""

import numpy as np
import pytest
import torch

from gkgnet_tpu_torch.core import optim as toptim
from gkgnet_tpu_torch.core import schedules as tsched
from gkgnet_tpu_torch.core import trainer as ttrainer
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters

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


def _small_state(drop_path=0.1, n_classes=10, **state_kwargs):
    model = GKGNetClassifier(**{**SMALL, "n_classes": n_classes},
                             drop_path=drop_path)
    init_parameters(model, torch.Generator().manual_seed(0))
    opt = state_kwargs.pop("optimizer", None) or toptim.build_optimizer(
        model, tsched.step_lr_with_warmup(1e-3, 10, [5], warmup_iters=2))
    return ttrainer.create_train_state(model, opt, **state_kwargs)


def _small_batch(n_classes=10):
    rng = np.random.default_rng(0)
    return {"img": _t(rng.standard_normal((2, 128, 128, 3))),
            "gt_label": _t(rng.random((2, n_classes)) < 0.3)}


def test_train_two_steps_smoke():
    """Two steps at drop_path 0.1 with EMA: finite logs, parameters and
    running statistics moved, the EMA between the initial and the new
    parameters, reproducible from the seed, scores in [0, 1]."""
    batch = _small_batch()
    runs = []
    for _ in range(2):
        state = _small_state(ema=True)
        p0 = state.model.backbone.stem.convs[0].weight.detach().clone()
        var0 = state.model.backbone.stem.convs[1].running_var.clone()
        step = ttrainer.make_train_step(ema_momentum=2e-4)
        for _ in range(2):
            state, logs = step(state, batch, 7)
        runs.append(state)
    assert state.step == 2
    for key in ("bce_loss", "asy_loss", "loss", "grad_norm", "lr"):
        assert np.isfinite(float(logs[key])), key
    p2 = state.model.backbone.stem.convs[0].weight.detach()
    e2 = state.ema_params["backbone.stem.convs.0.weight"]
    assert not torch.allclose(p0, p2)
    assert not torch.allclose(e2, p2) and not torch.allclose(e2, p0)
    assert not torch.equal(var0,
                           state.model.backbone.stem.convs[1].running_var)
    for a, b in zip(runs[0].model.state_dict().values(),
                    runs[1].model.state_dict().values()):
        assert torch.equal(a, b)
    for use_ema in (False, True):
        scores = ttrainer.make_eval_step(use_ema)(state, batch["img"])
        assert scores.shape == (2, 10) and state.model.training
        assert bool(((scores >= 0) & (scores <= 1)).all())
    assert not torch.equal(ttrainer.make_eval_step(True)(state, batch["img"]),
                           ttrainer.make_eval_step(False)(state,
                                                          batch["img"]))


def _scaler_state(growth_interval):
    model_opt = dict(drop_path=0.0, n_classes=80, dynamic_loss_scale=True)
    state = _small_state(**model_opt)
    state.optimizer = toptim.build_optimizer(
        state.model, 1e-3, optimizer="sgd", weight_decay=0.0,
        betas=(0.0, 0.999), grad_clip_norm=None)
    step = ttrainer.make_train_step(dynamic_loss_scale=True,
                                    scale_growth_interval=growth_interval)
    return state, step


def test_dynamic_scale_growth_and_finite_update():
    """As tests/test_fp16.py: x2 after 2 finite steps, updates applied."""
    state, step = _scaler_state(growth_interval=2)
    assert state.loss_scale == 2.0 ** 16
    gt = torch.zeros((2, 80))
    gt[0, 3] = 1.0
    batch = {"img": torch.ones((2, 128, 128, 3)) * 0.1, "gt_label": gt}
    p0 = state.model.head.fc1.weight.detach().clone()
    state, logs = step(state, batch)
    assert np.isfinite(float(logs["loss"]))
    assert logs["loss_scale"] == 2.0 ** 16 and state.good_steps == 1
    assert not torch.allclose(state.model.head.fc1.weight, p0)
    state, logs = step(state, batch)
    assert logs["loss_scale"] == 2.0 ** 17 and state.good_steps == 0


def test_dynamic_scale_backoff_skips_update():
    """As tests/test_fp16.py: a NaN batch halves the scale and leaves the
    parameters and the BatchNorm statistics as they were."""
    state, step = _scaler_state(growth_interval=2000)
    bad = {"img": torch.full((2, 128, 128, 3), float("nan")),
           "gt_label": torch.zeros((2, 80))}
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, logs = step(state, bad)
    assert logs["loss_scale"] == 2.0 ** 15 and state.good_steps == 0
    assert float(logs["grad_norm"]) == 0.0
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, before[key]), key


