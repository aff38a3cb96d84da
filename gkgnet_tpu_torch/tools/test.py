"""Evaluation CLI (counterpart: ``tools/test.py``): score a checkpoint over
the config's test split in dataset order, print the full COCO metric dict as
JSON, and optionally dump the raw scores and the metrics.

    python -m gkgnet_tpu_torch.tools.test CONFIG work_dirs/<run>/best \\
        --out scores.pkl --metrics-out metrics.json [--ema] [--device cpu]
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m gkgnet_tpu_torch.tools.test CONFIG CKPT_DIR --out scores.pkl
    gkgnet_tpu_torch/tools/dist_test.sh CONFIG CKPT_DIR 4 [args]   # the same

Over a world of ranks (as ``tools.train`` joins it) each data rank scores
its rows ``r::data`` under ``parallel.sharding.graph_sharding`` and the
scores are reassembled in dataset order on every rank; rank 0 prints the
metrics and writes ``--out`` and ``--metrics-out``.

``CKPT_DIR`` is a directory of epoch saves (``checkpoints`` or ``best``);
its newest epoch is loaded, with the EMA parameters under ``--ema`` (a
save without them raises).
Without a checkpoint the model keeps its seeded init. Runs on the card
unless ``--device cpu`` is given; raises without a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle

import numpy as np
import torch

from gkgnet_tpu_torch.core.builder import build_dataset, build_model
from gkgnet_tpu_torch.core.checkpoint import load_params_only
from gkgnet_tpu_torch.core.trainer import create_train_state, make_eval_step
from gkgnet_tpu_torch.nn.classifier import init_parameters
from gkgnet_tpu_torch.parallel.mesh import destroy
from gkgnet_tpu_torch.parallel.sharding import graph_sharding
from gkgnet_tpu_torch.tools.train import join_world, load_config, run_eval
from gkgnet_tpu_torch.utils.logging import get_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Test a GKGNet model on one card or a world of ranks")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="checkpoint dir (omit to eval the seeded init)")
    p.add_argument("--out", help="dump raw scores (pickle)")
    p.add_argument("--metrics-out", help="dump metric dict (json)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--ema", action="store_true", help="evaluate EMA weights")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--multihost", action="store_true",
                   help="join the world from the torch.distributed.run "
                        "environment even for a world of one")
    return p.parse_args(argv)


def main(argv=None) -> tuple[dict, np.ndarray]:
    """Returns ``(metrics, scores)``."""
    args = parse_args(argv)
    cfg = load_config(args.config, args.cfg_options)
    device, mesh, joined = join_world(args, cfg)
    try:
        return _test(args, cfg, device, mesh)
    finally:
        if joined:
            destroy()


def _test(args, cfg, device, mesh) -> tuple[dict, np.ndarray]:
    rank0 = mesh.rank == 0
    logger = get_logger()
    if not rank0:
        logger.setLevel(logging.WARNING)

    test_ds = build_dataset(cfg.data["test"])
    model = build_model(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    if args.checkpoint:
        epoch, _ = load_params_only(args.checkpoint, model, ema=args.ema)
        logger.info(f"loaded {args.checkpoint} (epoch {epoch}"
                    f"{', EMA weights' if args.ema else ''})")
    state = create_train_state(model.to(device), optimizer=None)
    batch = args.batch or cfg.data.get("samples_per_device", 16)
    overlap = (cfg.get("mesh") or {}).get("overlap", False)
    with graph_sharding(mesh, overlap=overlap):
        results = run_eval(test_ds, make_eval_step(), state, batch, cfg,
                           device, split="test", mesh=mesh)
    metrics = test_ds.evaluate(results, logger=logger)
    if not rank0:
        return metrics, results
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"dumped scores to {args.out}")
    print(json.dumps(metrics, indent=2))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics, results


if __name__ == "__main__":
    main()
