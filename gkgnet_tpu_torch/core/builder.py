"""Config -> object builders (counterpart: ``gkgnet_tpu/core/builder.py``;
the registry layer of the reference, models/builder.py +
datasets/builder.py, as plain dispatch).

A config's ``model.neck`` becomes the classifier's ``neck_cfg`` and its
``model.graph_builder`` the graph build; ``model.train_cfg`` belongs to
the training loop (``train_cfg.augments``:
``nn.augment.build_batch_augment``).
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
    # train_cfg.augments is consumed by the training loop (batch-level
    # mixup/cutmix), not the module
    cfg.pop("train_cfg", None)
    neck = cfg.pop("neck", None)
    if neck is not None:
        cfg["neck_cfg"] = dict(neck)
    return GKGNetClassifier(dtype=dtype, head_kwargs=head, **cfg)
