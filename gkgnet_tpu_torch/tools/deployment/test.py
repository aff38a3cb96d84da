"""Evaluate an exported artifact through the eval harness of the checkpoint
path (counterpart: ``tools/deployment/test.py``; the reference runs its
ONNX/TensorRT backends through ``single_gpu_test`` + ``dataset.evaluate``).

    python -m gkgnet_tpu_torch.tools.deployment.test CONFIG ARTIFACT \\
        [--out scores.pkl] [--metrics-out metrics.json] [--device cpu]

ARTIFACT is a ``.pt2`` file written by ``tools/deployment/export.py``. The
config's test split runs through it in dataset order at the artifact's
batch, the last batch padded with copies of its last image, and the scores
go to the dataset's ``evaluate``; the metric dict is printed as JSON. The
artifact must have been exported for the device asked for: the card unless
``--device cpu`` is given; raises without a card.
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np
import torch

from gkgnet_tpu_torch.core.builder import build_dataset
from gkgnet_tpu_torch.core.export import load_exported_classifier
from gkgnet_tpu_torch.core.trainer import (make_device_normalize,
                                           pipeline_device_norm)
from gkgnet_tpu_torch.data.loader import build_dataloader
from gkgnet_tpu_torch.entry import resolve_device
from gkgnet_tpu_torch.tools.train import find_pipeline_cfg, load_config
from gkgnet_tpu_torch.utils.logging import get_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate an exported artifact")
    p.add_argument("config")
    p.add_argument("artifact")
    p.add_argument("--out", help="dump raw scores (pickle)")
    p.add_argument("--metrics-out", help="dump metric dict (json)")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> tuple[dict, np.ndarray]:
    """Returns ``(metrics, scores)``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    logger = get_logger()
    cfg = load_config(args.config, args.cfg_options)
    clf = load_exported_classifier(args.artifact, device=device)
    batch = clf.batch
    logger.info(f"loaded artifact {args.artifact}, input {clf.input_shape} "
                f"on {clf.device}")

    test_ds = build_dataset(cfg.data["test"])
    loader = build_dataloader(test_ds, batch, cfg.data.get("workers", 8),
                              shuffle=False, drop_last=False)
    # a pipeline that leaves Normalize to the device gives uint8 batches,
    # normalized on the artifact's device as the test CLI does
    norm = make_device_normalize(pipeline_device_norm(
        find_pipeline_cfg(cfg.data["test"])))
    chunks = []
    for i, b in enumerate(loader):
        imgs = b["img"]
        pad = batch - imgs.shape[0]
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)], 0)
        scores = clf.forward(norm(torch.from_numpy(imgs).to(clf.device)))
        chunks.append(scores[: batch - pad].cpu().numpy())
        if (i + 1) % 10 == 0:
            logger.info(f"{(i + 1) * batch}/{len(test_ds)}")
    results = np.concatenate(chunks, 0)

    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"dumped scores to {args.out}")
    metrics = test_ds.evaluate(results, logger=logger)
    print(json.dumps(metrics, indent=2))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics, results


if __name__ == "__main__":
    main()
