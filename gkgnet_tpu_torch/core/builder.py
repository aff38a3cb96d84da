"""Config -> object builders (counterpart: ``gkgnet_tpu/core/builder.py``;
the registry layer of the reference, models/builder.py +
datasets/builder.py, as plain dispatch).

What the port does not have yet raises ``NotImplementedError`` naming its
``ROADMAP.md`` item: a neck, ``train_cfg.augments`` (batch mixup/cutmix)
and ``graph_builder='perturbed'`` (queue 1 item 6).
"""

from __future__ import annotations

import torch

from gkgnet_tpu_torch.data.coco import CocoMultiLabel
from gkgnet_tpu_torch.data.pipelines import build_pipeline
from gkgnet_tpu_torch.data.single_label import ImageListDataset
from gkgnet_tpu_torch.data.voc import VOCMultiLabel
from gkgnet_tpu_torch.data.wrappers import (
    ClassBalancedDataset,
    ConcatDataset,
    KFoldDataset,
    RepeatDataset,
)
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "bf16": torch.bfloat16, "fp32": torch.float32,
          "float16": torch.float16, "fp16": torch.float16}

DATASETS = {"COCO": CocoMultiLabel, "VOC": VOCMultiLabel,
            "ImageList": ImageListDataset}


def build_dataset(cfg: dict):
    cfg = dict(cfg)
    t = cfg.pop("type")
    if t == "ClassBalancedDataset":
        return ClassBalancedDataset(build_dataset(cfg["dataset"]),
                                    cfg["oversample_thr"])
    if t == "RepeatDataset":
        return RepeatDataset(build_dataset(cfg["dataset"]), cfg["times"])
    if t == "ConcatDataset":
        return ConcatDataset([build_dataset(c) for c in cfg["datasets"]])
    if t == "KFoldDataset":
        ds = build_dataset(cfg.pop("dataset"))
        return KFoldDataset(ds, **cfg)
    if t in DATASETS:
        pipeline = cfg.pop("pipeline", None)
        if pipeline is not None:
            pipeline = build_pipeline(pipeline)
        return DATASETS[t](pipeline=pipeline, **cfg)
    raise ValueError(f"unknown dataset type {t}")


def build_model(cfg: dict) -> GKGNetClassifier:
    cfg = dict(cfg)
    head = cfg.pop("head", None)
    dtype = DTYPES[cfg.pop("dtype", "float32")]
    if (cfg.pop("train_cfg", None) or {}).get("augments"):
        raise NotImplementedError(
            "train_cfg.augments (batch mixup/cutmix, gkgnet_tpu/nn/augment.py)"
            " is not ported yet (ROADMAP.md queue 1 item 6)")
    if cfg.pop("neck", None) is not None:
        raise NotImplementedError(
            "a neck (gkgnet_tpu/nn/necks.py) is not ported yet (ROADMAP.md "
            "queue 1 item 6)")
    builder = cfg.pop("graph_builder", "knn")
    if builder != "knn":
        raise NotImplementedError(
            f"graph_builder='{builder}' is not ported yet (ROADMAP.md queue 1"
            f" item 6)")
    return GKGNetClassifier(dtype=dtype, head_kwargs=head, **cfg)
