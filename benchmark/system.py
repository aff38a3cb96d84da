"""The system under test behind one small interface, so that the windows
and the checks drive either:

  * ``Program``: the port, through its own entry points:
    ``core.trainer.make_train_step`` (its default CUDA graph) fed by
    ``make_device_normalize`` as the training CLI feeds it,
    ``make_eval_step`` (sigmoid scores) and ``entry.predict``; the model
    built from the configuration with the benchmark's weights loaded;
  * ``Reference``: the plain reference put in the program's place,
    computed in a lower type (``cast``) or with a fault planted (``rows``:
    half the batch, the loss's mean over the rest). It imports nothing of
    the program; the checks' control and faults use it.

Each takes the configuration, the weights and BN statistics by name and
the run's seed. ``train_step`` returns the loss as a 0-d tensor without
reading it; ``first_grad_norms`` and ``change_norms`` give the per-leaf
norms the checks compare. ``Program.eager`` runs one uncompiled call of
the same step, for the trace's attribution of kernels to operators.
"""

from __future__ import annotations

import torch

from benchmark import inputs
from benchmark.reference.model import PlainGKGNet, identity
from benchmark.reference.train import PlainTrainer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _norms(tensors: dict) -> dict:
    return {k: float(v) for k, v in zip(tensors, torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors.values()])
        .tolist())}


class Program:
    """The port under test."""

    def __init__(self, cfg: dict, params: dict, stats: dict, seed: int,
                 device: torch.device):
        from gkgnet_tpu_torch.core.optim import build_optimizer
        from gkgnet_tpu_torch.core.schedules import build_lr_schedule
        from gkgnet_tpu_torch.core.trainer import (create_train_state,
                                                   make_device_normalize)
        from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier

        self.cfg, self.seed, self.device = cfg, seed, device
        m = cfg["model"]
        model = GKGNetClassifier(
            arch=m["arch"], k=m["k"], k_label_gcn=m["k_label_gcn"],
            num_group=m["num_group"], n_classes=m["n_classes"],
            size=m["size"], num_gcn=m["num_gcn"], drop_path=m["drop_path"],
            dtype=DTYPES[m["dtype"]], head_kwargs=m["head"])
        model = model.to(device)
        model.load_state_dict({**params, **stats}, strict=True)
        self.model = model
        opt = cfg["optimizer"]
        lr_cfg = dict(cfg["lr_config"], base_lr=opt["lr"])
        optimizer = build_optimizer(
            model, build_lr_schedule(lr_cfg, cfg["steps_per_epoch"]),
            opt["type"], opt["weight_decay"], tuple(opt["betas"]),
            opt["eps"], opt["grad_clip_norm"], opt["paramwise_no_decay"])
        self.state = create_train_state(model, optimizer)
        norm = cfg["img_norm"]
        self.normalize = make_device_normalize((tuple(norm["mean"]),
                                                tuple(norm["std"])))
        self._steps = {}

    def _step(self, kind: str, compiled: bool | None):
        from gkgnet_tpu_torch.core.trainer import (make_eval_step,
                                                   make_train_step)
        key = (kind, compiled)
        if key not in self._steps:
            self._steps[key] = (make_train_step(compiled=compiled)
                                if kind == "train"
                                else make_eval_step(compiled=compiled))
        return self._steps[key]

    def train_step(self, img: torch.Tensor, gt: torch.Tensor,
                   compiled: bool | None = None) -> torch.Tensor:
        batch = {"img": self.normalize(img), "gt_label": gt}
        _, logs = self._step("train", compiled)(self.state, batch, self.seed)
        return logs["loss"]

    def eval_step(self, imgs: torch.Tensor,
                  compiled: bool | None = None) -> torch.Tensor:
        return self._step("eval", compiled)(self.state, imgs)

    def predict(self, img: torch.Tensor,
                compiled: bool | None = None) -> torch.Tensor:
        from gkgnet_tpu_torch.entry import predict
        return predict(self.model, img, compiled=compiled)

    def eager(self, kind: str, *args) -> None:
        call = {"train": self.train_step, "eval": self.eval_step,
                "serve": self.predict}[kind]
        call(*args, compiled=False)

    def first_grad_norms(self) -> dict:
        """The first step's gradient as AdamW took it: its first moment
        after one step over (1 - beta1)."""
        opt = self.state.optimizer.optimizer
        b1 = self.cfg["optimizer"]["betas"][0]
        return {k: v / (1.0 - b1) for k, v in _norms({
            name: opt.state[p]["mu"]
            for name, p in self.model.named_parameters()}).items()}

    def change_norms(self, p0: dict) -> dict:
        return _norms({name: p.detach() - p0[name]
                       for name, p in self.model.named_parameters()})

    def release(self) -> None:
        self._steps.clear()
        del self.state, self.model


class Reference:
    """The plain reference in the program's place (computed through
    ``cast``; ``rows``: only the first rows of each training batch)."""

    def __init__(self, cfg: dict, params: dict, stats: dict, seed: int,
                 device: torch.device, cast=identity,
                 rows: int | None = None):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.params, self.stats, self.cast = params, stats, cast
        self.trainer = PlainTrainer(cfg, params, cast, rows)
        self.model = PlainGKGNet(cfg["model"], params, stats, cast)

    def train_step(self, img, gt, compiled=None) -> torch.Tensor:
        loss = self.trainer.step(inputs.normalize(img, self.cfg["img_norm"]),
                                 gt, self.seed)
        return torch.tensor(loss)

    @torch.no_grad()
    def eval_step(self, imgs, compiled=None) -> torch.Tensor:
        return torch.sigmoid(self.model.forward(imgs))

    def predict(self, img, compiled=None) -> torch.Tensor:
        return self.eval_step(img.to(self.device))

    def first_grad_norms(self) -> dict:
        return _norms(self.trainer.first_grads)

    def change_norms(self, p0: dict) -> dict:
        return _norms({k: p.detach() - p0[k]
                       for k, p in self.trainer.params.items()})

    def release(self) -> None:
        del self.trainer, self.model
