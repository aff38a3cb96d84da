"""Evaluation CLI (counterpart: ``tools/test.py``): score a checkpoint over
the config's test split in dataset order, print the full COCO metric dict as
JSON, and optionally dump the raw scores and the metrics.

    python -m gkgnet_tpu_torch.tools.test CONFIG work_dirs/<run>/best \\
        --out scores.pkl --metrics-out metrics.json [--ema] [--device cpu]

``CKPT_DIR`` is a directory of epoch saves (``checkpoints`` or ``best``);
its newest epoch is loaded, with the EMA parameters under ``--ema`` (a
save without them raises).
Without a checkpoint the model keeps its seeded init. Runs on the card
unless ``--device cpu`` is given; raises without a card.
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np
import torch

from gkgnet_tpu_torch.core.builder import build_dataset, build_model
from gkgnet_tpu_torch.core.checkpoint import load_params_only
from gkgnet_tpu_torch.core.trainer import create_train_state, make_eval_step
from gkgnet_tpu_torch.entry import resolve_device
from gkgnet_tpu_torch.nn.classifier import init_parameters
from gkgnet_tpu_torch.tools.train import check_one_card, load_config, run_eval
from gkgnet_tpu_torch.utils.logging import get_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a GKGNet model on one card")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="checkpoint dir (omit to eval the seeded init)")
    p.add_argument("--out", help="dump raw scores (pickle)")
    p.add_argument("--metrics-out", help="dump metric dict (json)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--ema", action="store_true", help="evaluate EMA weights")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> tuple[dict, np.ndarray]:
    """Returns ``(metrics, scores)``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config, args.cfg_options)
    check_one_card(cfg)
    logger = get_logger()

    test_ds = build_dataset(cfg.data["test"])
    model = build_model(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    if args.checkpoint:
        epoch, _ = load_params_only(args.checkpoint, model, ema=args.ema)
        logger.info(f"loaded {args.checkpoint} (epoch {epoch}"
                    f"{', EMA weights' if args.ema else ''})")
    state = create_train_state(model.to(device), optimizer=None)
    batch = args.batch or cfg.data.get("samples_per_device", 16)
    results = run_eval(test_ds, make_eval_step(), state, batch, cfg, device,
                       split="test")

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
