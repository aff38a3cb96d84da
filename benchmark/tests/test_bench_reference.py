"""The plain reference against the port's CPU path on a tiny
configuration: the same parameter names and shapes, the same relative
position tables and decay rule, the same logits and the same training
step in fp32."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.check import GRAD_FLOOR
from benchmark.reference import model as ref_model
from benchmark.reference.train import PlainTrainer

MODEL = dict(arch="t", size=128, k=3, k_label_gcn=3, num_group=2,
             drop_path=0.1, n_classes=80, num_gcn=1, dtype="float32",
             head=dict(gamma_pos=0.0, gamma_neg=2.0, clip=0.05,
                       asy_loss_scale=10.0, label_smooth_val=0.1))
NORM = {"mean": [123.675, 116.28, 103.53], "std": [58.395, 57.12, 57.375]}
IMAGES = {"scales": [[6, 180], [24, 80], [96, 30]], "noise": 6}
RECIPE = {"model": MODEL, "img_norm": NORM, "steps_per_epoch": 10,
          "optimizer": {"type": "adamw", "lr": 1e-3, "weight_decay": 0.05,
                        "eps": 1e-8, "betas": [0.9, 0.999],
                        "paramwise_no_decay": True, "grad_clip_norm": 5.0},
          "lr_config": {"policy": "step", "step": [10, 50], "gamma": 0.1,
                        "warmup": "linear", "warmup_ratio": 0.001,
                        "warmup_iters": 1, "warmup_by_epoch": True}}
CPU = torch.device("cpu")


def port(stats=True, seed=3):
    from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier
    params, drawn = inputs.weights(MODEL, seed, CPU)
    net = GKGNetClassifier(arch="t", size=128, k=3, k_label_gcn=3,
                           drop_path=0.1, head_kwargs=MODEL["head"])
    net.load_state_dict({**params, **drawn}, strict=True)
    return net, params, drawn


def batch(n=2, seed=3):
    return inputs.normalize(inputs.images(n, 128, IMAGES, seed, 3, CPU),
                            NORM)


def test_names_and_shapes_are_the_ports():
    net, _, _ = port()
    specs = {n: s for n, s, _ in ref_model.param_specs(MODEL)}
    assert specs == {n: tuple(p.shape) for n, p in net.named_parameters()}
    stats = {f"{n}.{s}" for n, _ in ref_model.bn_names(MODEL)
             for s in ("running_mean", "running_var")}
    assert stats == {n for n, _ in net.named_buffers()
                     if "running" in n}


def test_decay_rule_is_the_recipes():
    from gkgnet_tpu_torch.core.optim import no_decay_mask
    net, _, _ = port()
    assert ref_model.decayed(MODEL) == no_decay_mask(net)


@pytest.mark.parametrize("dim,n,r", [(48, 1024, 4), (96, 256, 2),
                                     (240, 64, 1)])
def test_relative_pos_tables_are_the_ports(dim, n, r):
    from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table
    np.testing.assert_allclose(ref_model.relative_pos_table(dim, n, r),
                               get_relative_pos_table(dim, n, r),
                               rtol=0, atol=1e-6)


def test_eval_logits_match_the_port():
    net, params, _ = port()
    x = batch()
    stats = inputs.calibrated_stats(MODEL, params, x)
    net.load_state_dict({**params, **stats}, strict=True)
    with torch.no_grad():
        want = net.eval()(x)[0]
        got = ref_model.PlainGKGNet(MODEL, params, stats).forward(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert 0.3 < float(torch.sigmoid(got).std() * 10) < 10  # not saturated


def test_training_step_matches_the_port():
    """Two steps of the port's train step (fp32, eager on the CPU) against
    the plain trainer: losses, the first gradient and the parameters."""
    from gkgnet_tpu_torch.core.optim import build_optimizer
    from gkgnet_tpu_torch.core.schedules import build_lr_schedule
    from gkgnet_tpu_torch.core.trainer import (create_train_state,
                                               make_train_step)
    net, params, _ = port()
    opt = RECIPE["optimizer"]
    sched = build_lr_schedule(dict(RECIPE["lr_config"], base_lr=opt["lr"]),
                              RECIPE["steps_per_epoch"])
    state = create_train_state(net, build_optimizer(
        net, sched, "adamw", opt["weight_decay"], tuple(opt["betas"]),
        opt["eps"], opt["grad_clip_norm"]))
    step = make_train_step()
    plain = PlainTrainer(RECIPE, params)
    gt = inputs.labels(2, 80, 2.9, 3, 4, CPU)
    for i in range(2):
        x = batch(seed=10 + i)
        _, logs = step(state, {"img": x, "gt_label": gt}, 77)
        loss = plain.step(x, gt, 77)
        assert float(logs["loss"]) == pytest.approx(loss, rel=1e-5)
        if i == 0:
            for name, p in net.named_parameters():
                mu = state.optimizer.optimizer.state[p]["mu"] / 0.1
                torch.testing.assert_close(
                    mu, plain.first_grads[name], rtol=1e-3, atol=1e-7)
    # a leaf whose gradient is round-off (a conv bias under a train-mode
    # BN) moves under Adam by that round-off alone: left out, as the
    # check leaves it out
    norms = {k: float(g.norm()) for k, g in plain.first_grads.items()}
    floor = GRAD_FLOOR * float(np.median(list(norms.values())))
    moved = [k for k, v in norms.items() if v >= floor]
    assert len(moved) > len(norms) // 2
    params = dict(net.named_parameters())
    for name in moved:
        torch.testing.assert_close(params[name].detach(),
                                   plain.params[name].detach(),
                                   rtol=1e-5, atol=1e-6)


def test_lower_types_round():
    t = torch.linspace(-3, 3, 1001)
    for kind, rel in (("bf16", 2 ** -8), ("fp8", 2 ** -3)):
        q = ref_model.round_to(kind)(t)
        err = (q - t).abs() / t.abs().clamp(min=3 * 2 ** -6)
        assert 0 < float(err.max()) <= rel


def test_fp8_rounds_the_gradient_too():
    t = torch.tensor([1.0, 0.5], requires_grad=True)
    q = ref_model.round_to("fp8")(t)
    (q * torch.tensor([1.0, 0.1234])).sum().backward()
    # 0.1234 at the scale 448 / 1 is 55.3, which e4m3 rounds to 56
    assert float(t.grad[1]) == 56 / 448
