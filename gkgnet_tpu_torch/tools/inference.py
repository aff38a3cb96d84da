"""Single-image inference API and CLI (counterpart: ``tools/inference.py``,
the reference's ``init_model`` / ``inference_model`` /
``show_result_pyplot``, multi-label aware).

    python -m gkgnet_tpu_torch.tools.inference IMG CONFIG [CKPT_DIR] \\
        [--topk 5] [--out-image out.png] [--device cpu]

``CKPT_DIR`` is a directory of the port's epoch saves (``checkpoints`` or
``best``, as the train CLI writes them); without it the model keeps its
seeded init. Runs on the card unless ``--device cpu`` is given; raises
without a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.checkpoint import load_params_only
from gkgnet_tpu_torch.core.config import Config
from gkgnet_tpu_torch.core.trainer import (create_train_state,
                                           make_device_normalize,
                                           make_eval_step,
                                           pipeline_device_norm)
from gkgnet_tpu_torch.data.coco import COCO_CLASSES
from gkgnet_tpu_torch.data.pipelines import build_pipeline
from gkgnet_tpu_torch.entry import resolve_device
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters


def init_model(config, checkpoint: str | None = None,
               device: str | torch.device | None = None
               ) -> tuple[GKGNetClassifier, Config]:
    """The config's model (a path or a ``Config``) with its seeded init
    (seed 0) and, given a checkpoint directory, its newest save's weights,
    in eval mode on ``device`` (the card unless the caller names another).
    Returns ``(model, cfg)``."""
    device = resolve_device(device)
    cfg = config if isinstance(config, Config) else Config.fromfile(config)
    model = build_model(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    if checkpoint:
        load_params_only(checkpoint, model)
    return model.to(device).eval(), cfg


def load_image(cfg: Config, img_path: str) -> np.ndarray:
    """The config's test pipeline on one image file: ``(1, H, W, 3)``."""
    pipeline = build_pipeline(cfg.data["test"]["pipeline"])
    results = pipeline({"img_prefix": "", "img_info": {"filename": img_path}},
                       np.random.default_rng(0))
    return results["img"][None]


def image_batch(model: GKGNetClassifier, cfg: Config, img_path: str
                ) -> torch.Tensor:
    """One image through the test pipeline, on the model's device and
    normalized there when the pipeline defers it: ``(1, H, W, 3)``."""
    device = next(model.parameters()).device
    norm = make_device_normalize(
        pipeline_device_norm(cfg.data["test"]["pipeline"]))
    return norm(torch.from_numpy(load_image(cfg, img_path)).to(device))


def inference_model(model: GKGNetClassifier, cfg: Config, img_path: str,
                    topk: int = 5) -> tuple[np.ndarray, list[dict]]:
    """The test pipeline and the eval step on one image: the per-class
    sigmoid scores ``(n_classes,)`` and the top-k predictions as
    ``{'class_id', 'class_name', 'score'}`` dicts, best first."""
    imgs = image_batch(model, cfg, img_path)
    state = create_train_state(model, optimizer=None)
    scores = make_eval_step()(state, imgs)[0].cpu().numpy()
    order = np.argsort(-scores)[:topk]
    classes = getattr(cfg, "classes", None) or COCO_CLASSES
    preds = [{"class_id": int(i),
              "class_name": classes[i] if i < len(classes) else str(i),
              "score": float(scores[i])} for i in order]
    return scores, preds


def show_result(img_path: str, preds, out_file: str | None = None):
    """Draw the predictions onto the image (``imshow_infos``)."""
    from gkgnet_tpu_torch.utils.visualization import imshow_predictions

    return imshow_predictions(img_path, preds, out_file=out_file)


def main(argv=None) -> tuple[np.ndarray, list[dict]]:
    p = argparse.ArgumentParser(description="GKGNet single-image inference")
    p.add_argument("img")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--out-image")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    model, cfg = init_model(args.config, args.checkpoint, args.device)
    scores, preds = inference_model(model, cfg, args.img, args.topk)
    print(json.dumps(preds, indent=2))
    if args.out_image:
        show_result(args.img, preds, args.out_image)
    return scores, preds


if __name__ == "__main__":
    main()
